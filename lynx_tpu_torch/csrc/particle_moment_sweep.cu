// Particle moment sweep, the per-setting walk (kernel B5), for Hopper,
// sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_moment_sweep_kernel
// (launched by _moment_sweep_pallas_impl).  One shared particle cloud is
// observed under B settings.  For each setting the kernel walks the plan:
// a map entry pushes the particle through a sparse 7x7 affine map, an
// aperture entry multiplies its survival weight by the aperture's mask at
// the current coordinates offset by the plane centre (cx, cy).  Then it sums
// 36 moments: sum w x_r (7), sum w x_r x_c for r <= c (28) and sum w (1).
//
// What bounds it on an H100: arithmetic and latency, not memory.  The cloud
// (7 coordinates and a weight, 3.2 MB in f32 at N = 100,000) stays in L2
// across the settings; per (setting, particle) the walk does a multiply-add
// per non-zero map cell and 43 for the sums against 32 bytes read.  The
// route serves B < 16 settings, so one launch has little work (B N ~ 1e6
// walks): what costs is filling the card and each walk's instruction count.
//
// Design.  One launch, a grid of (setting, particle span) blocks of
// kThreads, sized by spans_of to put ~kTargetBlocks blocks on the card's
// 132 SMs at any B (each thread walks a few groups of kPer particles).
// - At its start a block resolves the tape for its setting into shared
//   memory: every map cell's value (a structural one is the literal 1, whose
//   product is exact), each map's structural zeros as a 49-bit mask, each
//   aperture's bounds and plane centre.  The walk then reads values by
//   broadcast from shared memory and branches only on the masks and the
//   entry kinds, which are the same on every thread of the block.
// - A thread walks kPer neighbouring particles together (one 16-byte load a
//   coordinate where N allows), so each cell's value and mask test serve
//   kPer particles.
// - The 36 sums are reduced inside the block: a transposing butterfly of 31
//   warp shuffles leaves lane l with the warp's sum l (and 20 more the last
//   four), shared memory adds the warps in order, and one partial per block
//   goes to a (B, spans, 36) buffer.  The block that arrives last for its
//   setting (an int32 counter per setting, zeroed by the caller) adds that
//   setting's partials in span order.  No floating-point atomics: the
//   result is the same from run to run.
// The plan reaches the kernel as a tape of records (ops/fused_track
// _walk_tape): a map's 49 cells are each a structural zero (skipped, as the
// TPU kernel skips them at trace time), a structural one, a literal, or an
// index into the (S, B) per-setting scalars.  Templated on float and
// double: the kernel computes in the cloud's dtype, as the TPU kernel does.

#include <cuda_runtime.h>

#include <cstdint>

#include "moment_sums.cuh"

namespace {

// Tape layout; lynx_tpu_torch/ops/fused_track.py has the same constants.
constexpr int kMap = 0;
constexpr int kRecord = 64;  // int32 per record
constexpr int kCodes = 8;    // offset of a map record's 49 cell codes
constexpr int kZero = -1;
constexpr int kOne = -2;     // a code <= -3 is literal -3 - code
constexpr int kCells = 49;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kTargetBlocks = 132 * 4;  // four blocks on each of the card's 132 SMs
constexpr int kDefaultShared = 48 * 1024;
constexpr int kDoesNotFit = -1;  // the plan's resolved tape exceeds a block's shared memory

// Particles a thread walks together: one 16-byte vector of a coordinate.
template <typename T>
constexpr int kPer = 16 / sizeof(T);

#ifndef LYNX_HOST_STAND_IN
template <typename T>
__device__ __forceinline__ T lynx_shfl_xor(T value, int mask) {
  return __shfl_xor_sync(0xffffffffu, value, mask);
}
#endif

// Particles p .. p + kPer - 1 of one row of the (7, n) cloud (or of the
// weights); those at n or past it read as 0.
__device__ __forceinline__ void load_group(const float* row, int64_t p, int64_t n, bool vector,
                                           float (&out)[4]) {
  if (vector && p < n) {
    const float4 v = *reinterpret_cast<const float4*>(row + p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = p + q < n ? row[p + q] : 0.0f;
}

__device__ __forceinline__ void load_group(const double* row, int64_t p, int64_t n, bool vector,
                                           double (&out)[2]) {
  if (vector && p < n) {
    const double2 v = *reinterpret_cast<const double2*>(row + p);
    out[0] = v.x, out[1] = v.y;
    return;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) out[q] = p + q < n ? row[p + q] : 0.0;
}

// One step of the transposing butterfly: lanes whose bit kWidth is set keep
// sums kWidth .. 2 kWidth - 1 of their slots and send 0 .. kWidth - 1, the
// others the reverse; each adds its partner's.  After the steps 16 .. 1,
// lane l holds the warp's sum l in acc[0].
template <int kWidth, typename T>
__device__ __forceinline__ void fold(T (&acc)[lynx::kSums], int lane) {
  const bool upper = (lane & kWidth) != 0;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    const T send = upper ? acc[i] : acc[i + kWidth];
    const T keep = upper ? acc[i + kWidth] : acc[i];
    acc[i] = keep + lynx_shfl_xor(send, kWidth);
  }
}

// Shared memory of a block: per entry a structural-zero mask, 49 values
// (a map's cells, or an aperture's x_max, y_max, cx, cy) and (kind, shape).
template <typename T>
int64_t shared_bytes(int n_entries) {
  return static_cast<int64_t>(n_entries) *
         (sizeof(unsigned long long) + kCells * sizeof(T) + 2 * sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) moment_walk_kernel(
    const int* __restrict__ tape, int n_entries, const T* __restrict__ literals,
    const T* __restrict__ scalars, const T* __restrict__ cloud, const T* __restrict__ weights,
    T* __restrict__ partials, int* __restrict__ arrived, T* __restrict__ out, int64_t batch,
    int64_t n, int64_t spans, int64_t span_len, int vector) {
  constexpr int P = kPer<T>;
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ T s_warp[kWarps][lynx::kSums];
  __shared__ int s_last;
  auto* s_zeros = reinterpret_cast<unsigned long long*>(s_raw);
  T* s_value = reinterpret_cast<T*>(s_zeros + n_entries);
  int* s_kind = reinterpret_cast<int*>(s_value + n_entries * kCells);

  const int64_t b = blockIdx.x / spans;
  const int64_t span = blockIdx.x - b * spans;

  // The tape, resolved for setting b.
  for (int i = threadIdx.x; i < n_entries * kCells; i += kThreads) {
    const int e = i / kCells, cell = i - e * kCells;
    const int* rec = tape + e * kRecord;
    T value = T(0);
    if (rec[0] == kMap) {
      const int code = rec[kCodes + cell];
      value = code >= 0 ? scalars[code * batch + b]
                        : code <= -3 ? literals[-3 - code] : T(code == kOne ? 1 : 0);
    } else if (cell < 4) {
      value = scalars[rec[1 + cell] * batch + b];  // x_max, y_max, cx, cy
    }
    s_value[i] = value;
  }
  for (int e = threadIdx.x; e < n_entries; e += kThreads) {
    const int* rec = tape + e * kRecord;
    unsigned long long zeros = 0;
    if (rec[0] == kMap) {
      for (int cell = 0; cell < kCells; ++cell) {
        zeros |= static_cast<unsigned long long>(rec[kCodes + cell] == kZero) << cell;
      }
    }
    s_zeros[e] = zeros;
    s_kind[2 * e] = rec[0];
    s_kind[2 * e + 1] = rec[5];  // an aperture's shape, 0 rectangular
  }
  __syncthreads();

  T acc[lynx::kSums];
#pragma unroll
  for (int k = 0; k < lynx::kSums; ++k) acc[k] = T(0);

  const int64_t groups = span_len / (kThreads * P);
  for (int64_t g = 0; g < groups; ++g) {
    const int64_t p = span * span_len + (g * kThreads + threadIdx.x) * P;
    T c[7][P];
#pragma unroll
    for (int j = 0; j < 7; ++j) load_group(cloud + j * n, p, n, vector, c[j]);
    T w[P];
    load_group(weights, p, n, vector, w);

    for (int e = 0; e < n_entries; ++e) {
      const T* v = s_value + e * kCells;
      if (s_kind[2 * e] == kMap) {
        const unsigned long long zeros = s_zeros[e];
        T pushed[7][P];
#pragma unroll
        for (int r = 0; r < 7; ++r) {
#pragma unroll
          for (int q = 0; q < P; ++q) pushed[r][q] = T(0);
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            if ((zeros >> (7 * r + j)) & 1ull) continue;
            const T m = v[7 * r + j];
#pragma unroll
            for (int q = 0; q < P; ++q) pushed[r][q] = pushed[r][q] + m * c[j][q];
          }
        }
#pragma unroll
        for (int r = 0; r < 7; ++r) {
#pragma unroll
          for (int q = 0; q < P; ++q) c[r][q] = pushed[r][q];
        }
      } else {
        // The masks of lynx_tpu/ops/pallas_track.py:_aperture_mask: strict
        // rectangle, inclusive ellipse in the division form.
        const T x_max = v[0], y_max = v[1], cx = v[2], cy = v[3];
        if (s_kind[2 * e + 1] == 0) {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const T x = c[0][q] + cx, y = c[2][q] + cy;
            const bool keep = x > -x_max && x < x_max && y > -y_max && y < y_max;
            w[q] = w[q] * (keep ? T(1) : T(0));
          }
        } else {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const T x = c[0][q] + cx, y = c[2][q] + cy;
            const bool keep = x * x / (x_max * x_max) + y * y / (y_max * y_max) <= T(1);
            w[q] = w[q] * (keep ? T(1) : T(0));
          }
        }
      }
    }

#pragma unroll
    for (int q = 0; q < P; ++q) {
      const bool live = p + q < n;  // a particle past n adds exact zeros
      const T wq = live ? w[q] : T(0);
      T x[7];
#pragma unroll
      for (int r = 0; r < 7; ++r) x[r] = live ? c[r][q] : T(0);
      int k = 7;
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        const T weighted = wq * x[r];
        acc[r] = acc[r] + weighted;
#pragma unroll
        for (int col = r; col < 7; ++col) {
          acc[k] = acc[k] + weighted * x[col];
          ++k;
        }
      }
      acc[lynx::kSums - 1] = acc[lynx::kSums - 1] + wq;
    }
  }

  // The block's 36 sums: the warps by shuffles, then the warps in order.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  fold<16>(acc, lane);
  fold<8>(acc, lane);
  fold<4>(acc, lane);
  fold<2>(acc, lane);
  fold<1>(acc, lane);
#pragma unroll
  for (int k = 32; k < lynx::kSums; ++k) {
#pragma unroll
    for (int width = 16; width >= 1; width /= 2) acc[k] = acc[k] + lynx_shfl_xor(acc[k], width);
  }
  s_warp[warp][lane] = acc[0];
  if (lane == 0) {
#pragma unroll
    for (int k = 32; k < lynx::kSums; ++k) s_warp[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < lynx::kSums) {
    T total = s_warp[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total = total + s_warp[w][threadIdx.x];
    partials[(b * spans + span) * lynx::kSums + threadIdx.x] = total;
    __threadfence();  // the partial is visible before the block counts as arrived
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrived + b, 1) == spans - 1;
  __syncthreads();
  if (s_last && threadIdx.x < lynx::kSums) {
    __threadfence();
    const volatile T* src = partials + b * spans * lynx::kSums + threadIdx.x;
    T total = src[0];
    for (int64_t s = 1; s < spans; ++s) total = total + src[s * lynx::kSums];
    out[b * lynx::kSums + threadIdx.x] = total;
  }
}

// Particles a block walks: whole groups of kThreads x kPer, enough blocks
// for kTargetBlocks over the batch where the cloud allows.
template <typename T>
int64_t span_len_of(int64_t batch, int64_t n) {
  constexpr int64_t group = kThreads * kPer<T>;
  if (n <= 0 || batch <= 0) return group;
  int64_t spans = (kTargetBlocks + batch - 1) / batch;
  const int64_t most = (n + group - 1) / group;
  if (spans > most) spans = most;
  const int64_t per = (n + spans - 1) / spans;
  return (per + group - 1) / group * group;
}

template <typename T>
int64_t spans_of(int64_t batch, int64_t n) {
  const int64_t len = span_len_of<T>(batch, n);
  return n <= 0 ? 1 : (n + len - 1) / len;
}

template <typename T>
int launch(const void* tape, int n_entries, const void* literals, const void* scalars,
           const void* cloud, const void* weights, void* partials, void* arrived, void* out,
           long long batch, long long n, long long spans, cudaStream_t stream) {
  if (spans != spans_of<T>(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = shared_bytes<T>(n_entries);
  if (bytes > kDefaultShared) {
    int device = 0, limit = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (bytes + static_cast<int64_t>(sizeof(T)) * kWarps * lynx::kSums + 16 > limit) {
      return kDoesNotFit;
    }
    cudaFuncSetAttribute(moment_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
  const auto aligned = [](const void* pointer) {
    return reinterpret_cast<uintptr_t>(pointer) % 16 == 0;
  };
  const int vector = n % kPer<T> == 0 && aligned(cloud) && aligned(weights);
  moment_walk_kernel<T><<<static_cast<unsigned>(batch * spans), kThreads, bytes, stream>>>(
      static_cast<const int*>(tape), n_entries, static_cast<const T*>(literals),
      static_cast<const T*>(scalars), static_cast<const T*>(cloud),
      static_cast<const T*>(weights), static_cast<T*>(partials), static_cast<int*>(arrived),
      static_cast<T*>(out), batch, n, spans, span_len_of<T>(batch, n), vector);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Particle spans per setting of a launch over batch settings and n
// particles (the grid is batch x spans blocks).
long long lynx_particle_moment_spans(int is_double, long long batch, long long n) {
  return is_double ? spans_of<double>(batch, n) : spans_of<float>(batch, n);
}

// tape: (n_entries, 64) int32 records; literals: (L,); scalars: (S, batch);
// cloud: (7, n), the particles transposed; weights: (n,); partials:
// (batch, spans, 36) workspace with spans from lynx_particle_moment_spans;
// arrived: (batch,) int32, zeroed; out: (batch, 36) sums [7 first, 28
// second (r <= c, row-major), weight].  All float (is_double = 0) or double
// (is_double = 1), contiguous.  Returns cudaGetLastError(),
// cudaErrorInvalidValue for other spans, or kDoesNotFit (-1) when the
// resolved tape exceeds the device's shared memory per block.
int lynx_particle_moment_sweep(int is_double, const void* tape, int n_entries,
                               const void* literals, const void* scalars, const void* cloud,
                               const void* weights, void* partials, void* arrived, void* out,
                               long long batch, long long n, long long spans, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(tape, n_entries, literals, scalars, cloud, weights, partials,
                                    arrived, out, batch, n, spans, s)
                   : launch<float>(tape, n_entries, literals, scalars, cloud, weights, partials,
                                   arrived, out, batch, n, spans, s);
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

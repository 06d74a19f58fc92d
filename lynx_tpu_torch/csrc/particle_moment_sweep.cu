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
// across the settings; per (setting, particle) the walk does ~10-30 FMAs per
// map entry and 43 for the sums against 32 bytes read.  The route serves
// B < 16 settings, so one launch has little work (B N ~ 1e6 walks) and fills
// the card only in part.
//
// Design, simple first.  Stage 1: one thread per (setting, particle slot);
// a thread walks particles slot, slot + slots, ... (neighbouring threads,
// neighbouring particles: coalesced reads), keeps its 36 sums in registers
// and writes them to a (B, slots, 36) partial buffer.  Stage 2
// (moment_sums.cuh) sums the partials per setting in a fixed order.  No
// shared memory, no atomics: deterministic, and runnable by the tests' host
// build.  The plan reaches the kernel as a tape of records (ops/fused_track
// _walk_tape): a map's 49 cells are each a structural zero (skipped, as the
// TPU kernel skips them at trace time), a structural one (the coordinate is
// added without a multiply), a literal, or an index into the (S, B)
// per-setting scalars.  Templated on float and double: the kernel computes
// in the cloud's dtype, as the TPU kernel does.

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
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T cell_value(int code, const T* __restrict__ literals,
                                        const T* __restrict__ scalars, int64_t batch,
                                        int64_t b) {
  return code >= 0 ? scalars[code * batch + b] : literals[-3 - code];
}

template <typename T>
__global__ void moment_walk_kernel(const int* __restrict__ tape, int n_entries,
                                   const T* __restrict__ literals, const T* __restrict__ scalars,
                                   const T* __restrict__ cloud, const T* __restrict__ weights,
                                   T* __restrict__ partials, int64_t batch, int64_t n,
                                   int64_t slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * slots) return;
  const lynx::Slot at = lynx::slot_of(i, slots);
  const int64_t b = at.setting;

  T acc[lynx::kSums];
#pragma unroll
  for (int k = 0; k < lynx::kSums; ++k) acc[k] = T(0);

  for (int64_t p = at.slot; p < n; p += slots) {
    T c[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) c[j] = cloud[j * n + p];
    T w = weights[p];

    for (int e = 0; e < n_entries; ++e) {
      const int* rec = tape + e * kRecord;
      if (rec[0] == kMap) {
        T pushed[7];
#pragma unroll
        for (int r = 0; r < 7; ++r) {
          T row = T(0);
          bool started = false;
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            const int code = rec[kCodes + r * 7 + j];
            if (code == kZero) continue;
            const T term =
                code == kOne ? c[j] : cell_value(code, literals, scalars, batch, b) * c[j];
            row = started ? row + term : term;
            started = true;
          }
          pushed[r] = row;
        }
#pragma unroll
        for (int r = 0; r < 7; ++r) c[r] = pushed[r];
      } else {
        // rec: kind, x_max, y_max, cx, cy (scalar rows), shape (0 rectangular).
        const T x = c[0] + scalars[rec[3] * batch + b];
        const T y = c[2] + scalars[rec[4] * batch + b];
        const T x_max = scalars[rec[1] * batch + b];
        const T y_max = scalars[rec[2] * batch + b];
        // The masks of lynx_tpu/ops/pallas_track.py:_aperture_mask: strict
        // rectangle, inclusive ellipse in the division form.
        const bool keep = rec[5] == 0
                              ? (x > -x_max && x < x_max && y > -y_max && y < y_max)
                              : (x * x / (x_max * x_max) + y * y / (y_max * y_max) <= T(1));
        w = w * (keep ? T(1) : T(0));
      }
    }

    int k = 7;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      const T weighted = w * c[r];
      acc[r] = acc[r] + weighted;
#pragma unroll
      for (int col = r; col < 7; ++col) {
        acc[k] = acc[k] + weighted * c[col];
        ++k;
      }
    }
    acc[lynx::kSums - 1] = acc[lynx::kSums - 1] + w;
  }

  T* out = partials + i * lynx::kSums;
#pragma unroll
  for (int k = 0; k < lynx::kSums; ++k) out[k] = acc[k];
}

template <typename T>
void launch(const void* tape, int n_entries, const void* literals, const void* scalars,
            const void* cloud, const void* weights, void* partials, void* scratch, void* out,
            long long batch, long long n, long long slots, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * slots;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  moment_walk_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(tape), n_entries, static_cast<const T*>(literals),
      static_cast<const T*>(scalars), static_cast<const T*>(cloud),
      static_cast<const T*>(weights), static_cast<T*>(partials), batch, n, slots);
  lynx::reduce_partials<T>(static_cast<T*>(partials), static_cast<T*>(scratch),
                           static_cast<T*>(out), batch, slots, stream);
}

}  // namespace

extern "C" {

// tape: (n_entries, 64) int32 records; literals: (L,); scalars: (S, batch);
// cloud: (7, n), the particles transposed; weights: (n,); partials:
// (batch, slots, 36) and scratch: (batch, ceil(slots / 64), 36) workspace;
// out: (batch, 36) sums [7 first, 28 second (r <= c, row-major), weight].
// All float (is_double = 0) or double (is_double = 1), contiguous.
// Returns cudaGetLastError().
int lynx_particle_moment_sweep(int is_double, const void* tape, int n_entries,
                               const void* literals, const void* scalars, const void* cloud,
                               const void* weights, void* partials, void* scratch, void* out,
                               long long batch, long long n, long long slots, void* stream) {
  if (batch > 0 && slots > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(tape, n_entries, literals, scalars, cloud, weights, partials, scratch, out,
                     batch, n, slots, s);
    } else {
      launch<float>(tape, n_entries, literals, scalars, cloud, weights, partials, scratch, out,
                    batch, n, slots, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

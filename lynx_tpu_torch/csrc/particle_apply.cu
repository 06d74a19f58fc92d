// Per-setting particle push (kernel B2) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_particle_apply_kernel
// (launched by _apply_cells_pallas): out[b, n] = T_b p[b, n] for (B, N, 7)
// particles, one composed 7x7 map T_b per setting.  The maps are composed
// once per setting in PyTorch, outside the kernel, as the JAX package does;
// the kernel gets them as a dense (B, 49) row-major matrix plus the static
// layout of the lattice's structural zeros and ones as two 49-bit masks.
// The backward's particle cotangent is this kernel on the transposed maps.
//
// What bounds it on an H100: memory.  A push reads and writes 7 values per
// particle (56 bytes in f32) and does 49 FMAs: ~1.75 flops per byte, far
// below the card's ~20 flops per byte at 67 TFLOP/s and 3.35 TB/s, so the
// kernel can at best stream at device memory bandwidth.
//
// Design: a block takes one span of kSpanBytes (512 particles in f32, 256
// in f64) of the contiguous (B, N, 7) array and moves it between device and
// shared memory with 16-byte vector loads and stores, neighbouring threads
// on neighbouring addresses; each thread then pushes particles from shared
// memory in place (a stride of 7 words: no bank conflicts).  A thread loads
// its setting's 49 cells into registers once, and again only where its
// particles cross into the next setting, so spans may straddle settings.
// The masks are applied as the cells are loaded: a structural zero becomes
// an exact 0 and a structural one an exact 1.  A particle with finite
// coordinates takes the dense sum in column order, which gives the plain
// version's numbers (0 * x adds an exact zero and 1 * x adds x) up to FMA
// contraction.  One with an infinite or NaN coordinate takes the plain
// version's own sum, which skips the structural zeros, so that such a
// coordinate reaches only the rows that use it; that branch is taken by
// such particles alone.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSpanBytes = 14336;  // a multiple of 7 * 16 bytes

template <typename T> struct Vector16;
template <> struct Vector16<float> { using type = float4; };
template <> struct Vector16<double> { using type = double2; };

template <typename T>
__global__ void __launch_bounds__(kThreads) particle_apply_kernel(
    const T* __restrict__ matrix, const T* __restrict__ particles, T* __restrict__ out,
    int64_t n, int64_t total, unsigned long long zeros, unsigned long long ones) {
  using V = typename Vector16<T>::type;
  constexpr int kSpan = kSpanBytes / (7 * static_cast<int>(sizeof(T)));  // particles
  constexpr int kVectors = kSpanBytes / 16;
  __shared__ __align__(16) T span[kSpan * 7];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSpan;
  const int count = total - first < kSpan ? static_cast<int>(total - first) : kSpan;
  const T* src = particles + first * 7;
  T* dst = out + first * 7;
  // A full span whose tensors start on 16 bytes moves as vectors (a span
  // starts kSpanBytes further each block); anything else value by value.
  const bool vectors = count == kSpan &&
                       ((reinterpret_cast<uintptr_t>(particles) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vectors) {
    constexpr int kPerThread = kVectors / kThreads;
    static_assert(kVectors % kThreads == 0, "a span is whole vectors per thread");
    V staged[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      staged[k] = reinterpret_cast<const V*>(src)[threadIdx.x + k * kThreads];
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      reinterpret_cast<V*>(span)[threadIdx.x + k * kThreads] = staged[k];
    }
  } else {
    for (int k = threadIdx.x; k < count * 7; k += kThreads) span[k] = src[k];
  }
  __syncthreads();

  int64_t setting = -1;
  T cell[49];
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const int64_t b = (first + j) / n;
    if (b != setting) {
      setting = b;
      const T* m = matrix + b * 49;
#pragma unroll
      for (int c = 0; c < 49; ++c) {
        cell[c] = ((zeros >> c) & 1ull) ? T(0) : ((ones >> c) & 1ull) ? T(1) : m[c];
      }
    }
    T* p = span + j * 7;
    T x[7];
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      x[k] = p[k];
      finite = finite && isfinite(x[k]);
    }
    if (finite) {
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        T acc = cell[r * 7] * x[0];
#pragma unroll
        for (int k = 1; k < 7; ++k) acc = acc + cell[r * 7 + k] * x[k];
        p[r] = acc;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        T acc = T(0);
        bool started = false;
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          if ((zeros >> (r * 7 + k)) & 1ull) continue;
          acc = started ? acc + cell[r * 7 + k] * x[k] : cell[r * 7 + k] * x[k];
          started = true;
        }
        p[r] = acc;
      }
    }
  }
  __syncthreads();

  if (vectors) {
    constexpr int kPerThread = kVectors / kThreads;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      reinterpret_cast<V*>(dst)[threadIdx.x + k * kThreads] =
          reinterpret_cast<const V*>(span)[threadIdx.x + k * kThreads];
    }
  } else {
    for (int k = threadIdx.x; k < count * 7; k += kThreads) dst[k] = span[k];
  }
}

template <typename T>
void launch(const void* matrix, const void* particles, void* out, long long batch, long long n,
            unsigned long long zeros, unsigned long long ones, cudaStream_t stream) {
  constexpr int kSpan = kSpanBytes / (7 * static_cast<int>(sizeof(T)));
  const int64_t total = static_cast<int64_t>(batch) * n;
  const int64_t blocks = (total + kSpan - 1) / kSpan;
  particle_apply_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(matrix), static_cast<const T*>(particles), static_cast<T*>(out), n,
      total, zeros, ones);
}

}  // namespace

extern "C" {

// matrix: (batch, 49) row-major maps; particles, out: (batch, n, 7); all
// float (is_double = 0) or double (is_double = 1), contiguous.  Bit 7 i + j
// of zeros (ones) is set where cell (i, j) is a structural zero (one).
// Returns cudaGetLastError().
int lynx_particle_apply(int is_double, const void* matrix, const void* particles, void* out,
                        long long batch, long long n, unsigned long long zeros,
                        unsigned long long ones, void* stream) {
  if (batch > 0 && n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(matrix, particles, out, batch, n, zeros, ones, s);
    } else {
      launch<float>(matrix, particles, out, batch, n, zeros, ones, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

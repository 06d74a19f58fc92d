// Per-setting particle push (kernel B2) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_particle_apply_kernel
// (launched by _apply_cells_pallas): out[b, n] = T_b p[b, n] for (B, N, 7)
// particles, one composed 7x7 map T_b per setting.  The maps are composed
// once per setting in PyTorch, outside the kernel, as the JAX package does;
// the kernel gets them as a dense (B, 49) row-major matrix plus the static
// layout of the lattice's structural zeros and ones as two 49-bit masks, so
// it skips the zeros and adds the ones' coordinates without a multiply.
// The backward's particle cotangent is this kernel on the transposed maps.
//
// What bounds it on an H100: memory.  A push reads and writes 7 values per
// particle (56 bytes in f32) and does at most 49 FMAs: ~1 flop per byte,
// far below the card's ~20 flops/byte, so the kernel streams at device
// memory bandwidth at best.
//
// Design: one thread per (setting, particle), in a grid-stride loop; a
// thread reads its particle's 7 contiguous values, so a warp reads one
// contiguous span.  The setting's 49 cells are read through the cache
// (every particle of a setting reads the same row).  The masks are uniform
// across the grid, so the skipped terms cost no divergence.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 blocks per SM; grid-stride beyond

template <typename T>
__global__ void particle_apply_kernel(const T* __restrict__ matrix, const T* __restrict__ particles,
                                      T* __restrict__ out, int64_t n, int64_t total,
                                      unsigned long long zeros, unsigned long long ones) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const T* p = particles + i * 7;
    const T* m = matrix + (i / n) * 49;
    T x[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) x[j] = p[j];
    T* o = out + i * 7;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      T acc = T(0);
      bool started = false;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int bit = r * 7 + j;
        if ((zeros >> bit) & 1ull) continue;
        const T term = ((ones >> bit) & 1ull) ? x[j] : m[bit] * x[j];
        acc = started ? acc + term : term;
        started = true;
      }
      o[r] = acc;
    }
  }
}

template <typename T>
void launch(const void* matrix, const void* particles, void* out, long long batch, long long n,
            unsigned long long zeros, unsigned long long ones, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(batch) * n;
  const int64_t needed = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < kMaxBlocks ? needed : kMaxBlocks);
  particle_apply_kernel<T><<<blocks, kThreads, 0, stream>>>(
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

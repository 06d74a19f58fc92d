// Windowed screen histogram (kernel B1) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/histogram.py:_hist_kernel (launched
// by _window_matmul_hist).  That kernel bins each batch row's particles into
// a small window around the beam spot as a one-hot matrix product on the
// MXU.  What it computes is a scatter: for row b and particle n with local
// bin (lx, ly) inside the window, out[b, lx, ly] += w[n] (or += 1 in count
// mode).  Masked particles carry lx = -1 and add nothing.  The prologue
// (bin indices, window origin, fit test, masking) and the placement of the
// window into the full image stay in PyTorch.
//
// What bounds it on an H100: there is almost no arithmetic.  The kernel
// reads 8 bytes of indices (12 with weights) per particle and issues one
// atomic add per particle; the time is the index stream from device memory
// and the atomics resolved in L2.
//
// Design: one thread per particle, atomics straight into the output in
// device memory.  The flagship window is 952 x 256 int32 = 975 KB: larger
// than one block's 227 KB of shared memory, so a privatized copy per block
// would have to be tiled, and every tile's block would then rescan all
// particles.  The whole window sits easily in the 50 MB L2, where the
// atomics land; a beam spot of ~1e5 particles over ~1e5 bins gives few
// collisions per bin.  So the design reads each particle once, coalesced,
// and leaves conflict resolution to L2.  Count mode uses integer atomics
// and is exact; weighted mode uses f32 atomics, whose order (and so whose
// rounding) varies from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 blocks per SM; grid-stride beyond

template <bool kWeighted, typename Out>
__global__ void window_histogram_kernel(const int32_t* __restrict__ lx,
                                        const int32_t* __restrict__ ly,
                                        const float* __restrict__ weights,
                                        Out* __restrict__ out, int64_t n,
                                        int64_t total, int win_x, int win_y) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int x = lx[i];
    const int y = ly[i];
    if (x < 0 || y < 0 || x >= win_x || y >= win_y) continue;  // masked
    const int64_t row = i / n;
    Out* bin = out + (row * win_x + x) * static_cast<int64_t>(win_y) + y;
    if constexpr (kWeighted) {
      atomicAdd(bin, weights[i]);
    } else {
      atomicAdd(bin, 1);
    }
  }
}

}  // namespace

extern "C" {

// lx, ly: (batch, n) int32 local bin indices, -1 = masked.
// weights: (batch, n) float32, or null for count mode.
// out: (batch, win_x, win_y), int32 in count mode, float32 with weights;
//      zeroed by the caller.
// Returns cudaGetLastError() after the launch.
int lynx_window_histogram(const void* lx, const void* ly, const void* weights,
                          void* out, long long batch, long long n, int win_x,
                          int win_y, void* stream) {
  const int64_t total = static_cast<int64_t>(batch) * n;
  if (total > 0) {
    const int64_t needed = (total + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(needed < kMaxBlocks ? needed : kMaxBlocks);
    const auto* x = static_cast<const int32_t*>(lx);
    const auto* y = static_cast<const int32_t*>(ly);
    auto s = static_cast<cudaStream_t>(stream);
    if (weights == nullptr) {
      window_histogram_kernel<false, int><<<blocks, kThreads, 0, s>>>(
          x, y, nullptr, static_cast<int*>(out), n, total, win_x, win_y);
    } else {
      window_histogram_kernel<true, float><<<blocks, kThreads, 0, s>>>(
          x, y, static_cast<const float*>(weights), static_cast<float*>(out), n,
          total, win_x, win_y);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

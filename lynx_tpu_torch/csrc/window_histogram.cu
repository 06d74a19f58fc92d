// Windowed screen read (kernel B1) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/histogram.py:_hist_kernel (launched
// by _window_matmul_hist) together with the work the JAX package jit-fuses
// around it: the prologue (bin indices, live mask, window origins, fit
// test, masking) and the placement of the window into the full image.
// From the coordinates, weights and ranges of B batch rows of N particles
// it computes, per row, the bins exactly as ops/histogram.py:_bin_index
// does, the window's origin at the lowest live bin, whether every live
// particle fits the window, and the window's counts (exact) or weight sums,
// written straight into the (B, nx, ny) image at the origin.
//
// What bounds it on an H100: bytes.  It reads x, y and the weights once
// (12 bytes a particle in float32) and writes the window once; the read
// around it writes the whole image (20 MB a row at 2448 x 2040), which the
// caller zeroes.  The arithmetic is a few operations a particle.
//
// Design.  The origins need all of a row's particles before any counting,
// so the read is two launches over the whole card (grid (blocks, B)): the
// first writes each particle's packed bin (ix << 16 | iy, -1 dead) and
// each row's lowest live bins with atomics; the second adds each live bin
// inside its row's window to the (zeroed) image with an atomic in L2, and
// marks the row's misfit for a live bin outside.  The image, the tops,
// origins and misfit flags come from one zeroed buffer.  A cluster of
// blocks holding the window in distributed shared memory (DSMEM), in one
// launch (the origins reduced through DSMEM) or as the second pass, was
// slower on an H100 at the flagship window at B = 1 and 8 (PERF.md, the
// read's A/B); path L's (1848, 512) window does not fit a cluster at all.
//
// The bins follow _bin_index's operations one by one, rounded as PyTorch's
// CUDA operations round them: (v - lo) / (hi - lo) * n with IEEE
// division (a product by the reciprocal where PyTorch takes one: a span
// held on the host), no contraction (the _rn intrinsics).  A bin that moved
// would move the image and the routing audit.
//
// The scatter fallback (JAX's lax.cond at lynx_tpu/ops/histogram.py:539)
// is decided on the card: a third launch, the completion, reads the B
// misfit bytes the second pass wrote.  Where every row fits, each of its
// blocks returns after that read.  Where any row misfits (one decision for
// the batch, as lax.cond makes it), each live bin outside its row's window
// adds 1 or its weight to its image cell, so that the image becomes the
// exact scatter's (the window already holds the rest), and one thread adds
// one to a device counter of fallen-back reads.  No host reads a flag.
//
// The (lx, ly) count core (lynx_window_histogram) is the yardstick of the
// count-histogram A/B and of the read's timing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 blocks per SM; grid-stride beyond
constexpr int kMaxBins = 32767;  // a packed bin keeps ix and iy in 15 bits each

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

// -- the fused read ----------------------------------------------------------

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }

__host__ __device__ __forceinline__ int larger(int a, int b) { return a > b ? a : b; }

// One axis of the read: its bounds (a device pointer, one value for every
// row or one a row, or a host value), how the span rounds and its bins.
template <typename T>
struct Axis {
  const T* lo_ptr;
  const T* hi_ptr;
  int64_t lo_step, hi_step;  // 0: one bound for every row, 1: one a row
  T lo, hi;                  // where the pointer is null
  T inv;                     // 1 / (hi - lo) rounded on the host, where divide == 0
  int divide;                // 1: the span hi - lo is formed and divided on the card
  int bins;
};

// An axis as one row sees it.
template <typename T>
struct RowAxis {
  T lo, hi, scale;  // scale: the span (divide) or its reciprocal
  int divide, bins;
};

template <typename T>
__device__ __forceinline__ RowAxis<T> row_axis(const Axis<T>& a, int64_t row) {
  RowAxis<T> r;
  r.lo = a.lo_ptr != nullptr ? a.lo_ptr[row * a.lo_step] : a.lo;
  r.hi = a.hi_ptr != nullptr ? a.hi_ptr[row * a.hi_step] : a.hi;
  r.scale = a.divide ? sub_rn(r.hi, r.lo) : a.inv;
  r.divide = a.divide;
  r.bins = a.bins;
  return r;
}

// _bin_index for one value: floor((v - lo) / (hi - lo) * n) clamped to
// [0, n - 1] (a NaN to 0, as the CUDA cast of a NaN gives), or -1 where v
// lies outside [lo, hi] (a NaN included).
template <typename T>
__device__ __forceinline__ int bin_of(T v, const RowAxis<T>& a) {
  if (!(a.lo <= v && v <= a.hi)) return -1;
  const T d = sub_rn(v, a.lo);
  const T q = a.divide ? div_rn(d, a.scale) : mul_rn(d, a.scale);
  T s = floor_of(mul_rn(q, static_cast<T>(a.bins)));
  const T top = static_cast<T>(a.bins - 1);
  s = s > top ? top : s;
  s = s >= T(0) ? s : T(0);
  return static_cast<int>(s);
}

// The read's particles: (B, N) views with their strides, in elements.
template <typename T, typename W>
struct Particles {
  const T* x;
  const T* y;
  const W* w;
  int64_t x_row, x_step, y_row, y_step, w_row, w_step;
};

// Particle k of a row: its bins, or false where it is dead (out of range
// on an axis, or of weight 0).
template <typename T, typename W>
__device__ __forceinline__ bool live_bins(const Particles<T, W>& p, int64_t row, int64_t k,
                                          const RowAxis<T>& rx, const RowAxis<T>& ry, int& ix,
                                          int& iy) {
  ix = bin_of(p.x[row * p.x_row + k * p.x_step], rx);
  iy = bin_of(p.y[row * p.y_row + k * p.y_step], ry);
  return ix >= 0 && iy >= 0 && p.w[row * p.w_row + k * p.w_step] != W(0);
}

// The window's origin on an axis from the row's largest bins - lowest
// live bin (0 where nothing is live): _window_origin's clamp.
__host__ __device__ __forceinline__ int origin_of(int top, int bins, int win) {
  const int lowest = bins - top;
  const int most = bins - win > 0 ? bins - win : 0;
  return lowest < most ? lowest : most;
}

// The tail beside the image: int32 tops (x: B, y: B), origins (x: B, y:
// B), then one misfit byte a row.
struct Tail {
  int* top_x;
  int* top_y;
  int* ox;
  int* oy;
  unsigned char* misfit;
};

// First pass: each particle's packed bin (-1 dead) and each row's largest
// bins - lowest live bin, reduced in the block, then one atomicMax a
// block.  Grid (blocks, B).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) windowed_read_bins_kernel(
    Particles<T, W> p, Axis<T> ax, Axis<T> ay, int32_t* __restrict__ bins, Tail tail, int64_t n) {
  __shared__ int s_top[2];
  const int64_t row = blockIdx.y;
  if (threadIdx.x == 0) s_top[0] = s_top[1] = 0;
  __syncthreads();
  const RowAxis<T> rx = row_axis(ax, row), ry = row_axis(ay, row);
  int top_x = 0, top_y = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    int ix, iy;
    const bool live = live_bins(p, row, k, rx, ry, ix, iy);
    bins[row * n + k] = live ? ix << 16 | iy : -1;
    if (live) {
      top_x = larger(top_x, ax.bins - ix);
      top_y = larger(top_y, ay.bins - iy);
    }
  }
  if (top_x > 0) {  // then top_y > 0 too
    atomicMax(s_top, top_x);
    atomicMax(s_top + 1, top_y);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_top[0] > 0) {
    atomicMax(tail.top_x + row, s_top[0]);
    atomicMax(tail.top_y + row, s_top[1]);
  }
}

// Second pass: each live packed bin inside its row's window adds 1 or its
// weight to the image cell, an atomic in L2; a live bin outside marks the
// row's misfit.  Grid (blocks, B).
template <typename W, bool kWeighted>
__global__ void __launch_bounds__(kThreads) windowed_read_count_kernel(
    const int32_t* __restrict__ bins, const W* __restrict__ w, int64_t w_row, int64_t w_step,
    W* __restrict__ image, Tail tail, int64_t n, int nx, int ny, int win_x, int win_y) {
  __shared__ int s_misfit;
  const int64_t row = blockIdx.y;
  if (threadIdx.x == 0) s_misfit = 0;
  __syncthreads();
  const int ox = origin_of(tail.top_x[row], nx, win_x);
  const int oy = origin_of(tail.top_y[row], ny, win_y);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    tail.ox[row] = ox;
    tail.oy[row] = oy;
  }
  bool misfit = false;
  W* plane = image + row * nx * static_cast<int64_t>(ny);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const int bin = bins[row * n + k];
    if (bin < 0) continue;  // dead
    const int ix = bin >> 16, iy = bin & 0xffff;
    if (ix - ox >= win_x || iy - oy >= win_y) {  // ix >= ox, iy >= oy always
      misfit = true;
      continue;
    }
    atomicAdd(plane + static_cast<int64_t>(ix) * ny + iy,
              kWeighted ? w[row * w_row + k * w_step] : W(1));
  }
  if (misfit) s_misfit = 1;
  __syncthreads();
  if (threadIdx.x == 0 && s_misfit) tail.misfit[row] = 1;
}

// Third pass, the completion (see the note at the top): where any of the
// batch's rows misfits, each live packed bin outside its row's window adds 1
// or its weight to the image cell, and block (0, 0) counts the read in
// *counter.  Grid (blocks, B).
template <typename W, bool kWeighted>
__global__ void __launch_bounds__(kThreads) windowed_read_complete_kernel(
    const int32_t* __restrict__ bins, const W* __restrict__ w, int64_t w_row, int64_t w_step,
    W* __restrict__ image, Tail tail, int* __restrict__ counter, int64_t n, int64_t batch,
    int nx, int ny, int win_x, int win_y) {
  __shared__ int s_any;
  if (threadIdx.x == 0) s_any = 0;
  __syncthreads();
  for (int64_t r = threadIdx.x; r < batch; r += blockDim.x) {
    if (tail.misfit[r]) atomicMax(&s_any, 1);
  }
  __syncthreads();
  if (!s_any) return;  // every row fits: the windowed image is the read
  const int64_t row = blockIdx.y;
  if (row == 0 && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter, 1);
  const int ox = tail.ox[row], oy = tail.oy[row];
  W* plane = image + row * nx * static_cast<int64_t>(ny);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const int bin = bins[row * n + k];
    if (bin < 0) continue;  // dead
    const int ix = bin >> 16, iy = bin & 0xffff;
    if (ix - ox < win_x && iy - oy < win_y) continue;  // already in the window
    atomicAdd(plane + static_cast<int64_t>(ix) * ny + iy,
              kWeighted ? w[row * w_row + k * w_step] : W(1));
  }
}

template <typename T>
Axis<T> make_axis(const void* lo_ptr, const void* hi_ptr, const long long* steps,
                  const double* values, int divide, int bins) {
  Axis<T> a;
  a.lo_ptr = static_cast<const T*>(lo_ptr);
  a.hi_ptr = static_cast<const T*>(hi_ptr);
  a.lo_step = steps[0];
  a.hi_step = steps[1];
  a.lo = static_cast<T>(values[0]);
  a.hi = static_cast<T>(values[1]);
  // PyTorch's true division by a CPU scalar: the reciprocal, rounded in the
  // compute type, times the dividend.
  a.inv = divide ? T(0) : T(1) / static_cast<T>(values[2]);
  a.divide = divide;
  a.bins = bins;
  return a;
}

template <typename T, typename W>
int dispatch(const void* x, const void* y, const void* w, const long long* strides,
             const void* const* bound_ptrs, const long long* bound_steps,
             const double* bound_values, const int* divide, void* image, void* tail,
             void* bins, long long batch, long long n, int nx, int ny, int win_x, int win_y,
             int weighted, void* stream) {
  const Particles<T, W> p = {static_cast<const T*>(x), static_cast<const T*>(y),
                             static_cast<const W*>(w), strides[0], strides[1], strides[2],
                             strides[3], strides[4], strides[5]};
  const Axis<T> ax = make_axis<T>(bound_ptrs[0], bound_ptrs[1], bound_steps, bound_values,
                                  divide[0], nx);
  const Axis<T> ay = make_axis<T>(bound_ptrs[2], bound_ptrs[3], bound_steps + 2,
                                  bound_values + 3, divide[1], ny);
  int* ints = static_cast<int*>(tail);
  const Tail t = {ints, ints + batch, ints + 2 * batch, ints + 3 * batch,
                  reinterpret_cast<unsigned char*>(ints + 4 * batch)};
  auto* packed = static_cast<int32_t*>(bins);
  auto* out = static_cast<W*>(image);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(needed < kMaxBlocks ? needed : kMaxBlocks),
                  static_cast<unsigned>(batch));
  windowed_read_bins_kernel<T, W><<<grid, kThreads, 0, s>>>(p, ax, ay, packed, t, n);
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  if (weighted) {
    windowed_read_count_kernel<W, true><<<grid, kThreads, 0, s>>>(
        packed, p.w, p.w_row, p.w_step, out, t, n, nx, ny, win_x, win_y);
  } else {
    windowed_read_count_kernel<W, false><<<grid, kThreads, 0, s>>>(
        packed, p.w, p.w_row, p.w_step, out, t, n, nx, ny, win_x, win_y);
  }
  return 0;
}

template <typename W>
int complete(const void* bins, const void* w, long long w_row, long long w_step, void* image,
             void* tail, void* counter, long long batch, long long n, int nx, int ny, int win_x,
             int win_y, int weighted, void* stream) {
  int* ints = static_cast<int*>(tail);
  const Tail t = {ints, ints + batch, ints + 2 * batch, ints + 3 * batch,
                  reinterpret_cast<unsigned char*>(ints + 4 * batch)};
  const auto* packed = static_cast<const int32_t*>(bins);
  const auto* weights = static_cast<const W*>(w);
  auto* out = static_cast<W*>(image);
  auto* count = static_cast<int*>(counter);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(needed < kMaxBlocks ? needed : kMaxBlocks),
                  static_cast<unsigned>(batch));
  if (weighted) {
    windowed_read_complete_kernel<W, true><<<grid, kThreads, 0, s>>>(
        packed, weights, w_row, w_step, out, t, count, n, batch, nx, ny, win_x, win_y);
  } else {
    windowed_read_complete_kernel<W, false><<<grid, kThreads, 0, s>>>(
        packed, weights, w_row, w_step, out, t, count, n, batch, nx, ny, win_x, win_y);
  }
  return static_cast<int>(cudaGetLastError());
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

// The fused read (see the note at the top).
// x, y: (batch, n) views in the compute type (float32 if t_double == 0,
//   else float64), w: (batch, n) weights (float32 if w_double == 0, else
//   float64); strides: x's, y's and w's (row, element) strides in elements.
// bound_ptrs: device pointers of lo_x, hi_x, lo_y, hi_y in the compute
//   type, or null for a host value; bound_steps: 0 (one for every row) or 1
//   (one a row); bound_values: lo_x, hi_x, span_x, lo_y, hi_y, span_y on the
//   host (a span is read where its axis's divide is 0: the reciprocal is
//   taken).
// image: (batch, nx, ny) in w's type, zeroed; tail: int32 zeroed, 4 batch
//   ints then batch bytes (origins at 2 batch and 3 batch, misfit bytes
//   after); bins: a (batch, n) int32 workspace.
// Returns cudaErrorInvalidValue for an empty read, bins past 32,767 or a
// batch past 65,535, else the launches' cudaGetLastError().
int lynx_windowed_read(const void* x, const void* y, const void* w, const long long* strides,
                       const void* const* bound_ptrs, const long long* bound_steps,
                       const double* bound_values, const int* divide, void* image, void* tail,
                       void* bins, long long batch, long long n, int nx, int ny, int win_x,
                       int win_y, int t_double, int w_double, int weighted, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || nx < 1 || ny < 1 || nx > kMaxBins ||
      ny > kMaxBins || win_x < 1 || win_y < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = t_double ? (w_double ? dispatch<double, double> : dispatch<double, float>)
                            : (w_double ? dispatch<float, double> : dispatch<float, float>);
  const int code = run(x, y, w, strides, bound_ptrs, bound_steps, bound_values, divide, image,
                       tail, bins, batch, n, nx, ny, win_x, win_y, weighted, stream);
  return code != 0 ? code : static_cast<int>(cudaGetLastError());
}

// The completion, launched after lynx_windowed_read on the same stream and
// on its buffers (see the note at the top).  bins: the read's (batch, n)
// packed bins; w: its weights (float32 if w_double == 0, else float64) with
// their (row, element) strides; image and tail: the read's; counter: one
// int32 on the card, the fallen-back reads.  Returns cudaErrorInvalidValue
// for a read lynx_windowed_read refuses, else cudaGetLastError().
int lynx_windowed_read_complete(const void* bins, const void* w, long long w_row,
                                long long w_step, void* image, void* tail, void* counter,
                                long long batch, long long n, int nx, int ny, int win_x,
                                int win_y, int w_double, int weighted, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || nx < 1 || ny < 1 || nx > kMaxBins ||
      ny > kMaxBins || win_x < 1 || win_y < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = w_double ? complete<double> : complete<float>;
  return run(bins, w, w_row, w_step, image, tail, counter, batch, n, nx, ny, win_x, win_y,
             weighted, stream);
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// The screen's kernel-density image of a particle beam and its gradient
// (kernel B9) for Hopper, sm_90a.
//
// GPSR's smooth screen reading (ops/kde.py): for each of S settings the
// unnormalised image
//   raw[s, r, c] = sum_p w_p K_y[p, r] K_x[p, c],
//   K_y[p, r] = exp(-(y_p - Y_r)^2 / (2 h^2)), K_x[p, c] likewise,
// every particle against every pixel, nothing truncated, and its gradient for
// the image's cotangent G:
//   A = K_y G:   dL/dx_p = -(w_p / h^2) sum_c A[p, c] K_x[p, c] (x_p - X_c),
//                dL/dw_p = sum_c A[p, c] K_x[p, c];
//   B = K_x G^T: dL/dy_p = -(w_p / h^2) sum_r B[p, r] K_y[p, r] (y_p - Y_r).
// It replaces no TPU kernel (the JAX package has no KDE): it replaces the
// port's blocked PyTorch route (ops/kde.py, _BlockedSums, now the CPU's),
// whose kernel values made a dozen elementwise trips through device memory
// around cuBLAS's products.
//
// What bounds it on an H100: the three products, 2 S N H W operations each,
// in float32 on the CUDA cores (67 TFLOP/s): 11.18 ms at GPSR's 16 settings
// of 100,000 particles on 255 x 306 pixels.  Its bytes (the particles, the
// images) are a few MB.
//
// Design: the kernel values never leave the chip.  Both kernels are float32
// FMA products tiled in registers (no tensor cores: TF32 keeps 10 bits),
// whose operands are made in shared memory one chunk at a time, each value
// exponentiated once per block.  A thread holds a 16 x 8 tile of sums (8 x 8
// in double): an 8 x 8 tile would read as many bytes of shared memory a
// cycle as an H100 SM serves (128) at its FMA rate.  Two stages of shared
// memory, one barrier a chunk: a block makes chunk q + 1 (and fetches the
// particles or G of a later chunk into registers) while it multiplies chunk
// q.  A Gaussian is exp2(d^2 c) squared, c = -log2(e) / (4 h^2): one MUFU.EX2
// and a multiply.  The EX2 flushes a subnormal result to 0 only where its
// square is below 2^-252, which float rounds to 0 in any case, so no term is
// dropped.
// * kde_image_kernel: a block per (setting, kTileM x kTileN tile of the
//   image, split of the particles).  It walks its split's particles in
//   chunks: the chunk's particles staged in shared memory, each thread makes
//   its rows' K_y and its column's w K_x, and the outer products accumulate
//   in registers.  The split (ops/kde.py, kde_plan, from the shapes and the
//   SM count) fills the card where the tiles alone do not;
//   kde_sum_splits_kernel adds the splits' partial images in a fixed order.
//   No atomics: every call gives the same bits.
// * kde_grad_kernel: a block per (setting, kTileM particles, phase).  The x
//   phase forms A kTileN columns at a time over all rows (K_y made on chip,
//   G read from L2) and sums A K_x and A K_x (x - X) in the epilogue, making
//   K_x there; the y phase forms B from K_x and G's transpose likewise.  Each
//   sum has one owner thread and a slot in shared memory; a block owns its
//   particles' gradients: nothing is summed across blocks.
// Templated on float and double (the beam's dtype).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileN = 64;  // image columns (forward, x phase) or rows (y phase) a tile
constexpr int kGroups = 8;  // column groups: a thread's 8 columns are n + (j & 3) + 32 (j >> 2)
constexpr double kLog2e = 1.4426950408889634;

// kChunk: the depth of one shared-memory stage, particles (forward) or rows
// or columns of G (gradient).  A thread's tile of sums is 4 kSlabs x 8, and
// a block's kTileM = 64 kSlabs image rows (forward) or particles (gradient).
template <typename T> struct Shape;
template <> struct Shape<float> { static constexpr int kChunk = 16, kSlabs = 4; };
template <> struct Shape<double> { static constexpr int kChunk = 8, kSlabs = 2; };
template <typename T> constexpr int kTileM = 64 * Shape<T>::kSlabs;
template <typename T> constexpr int kRowsPer = 4 * Shape<T>::kSlabs;

// (S, N) particle coordinates with element strides (the screen's x and y are
// strided views of the particles; a broadcast has stride 0); w null for 1.
template <typename T> struct Coordinates {
  const T* x;
  const T* y;
  const T* w;
  long long x_s, x_p, y_s, y_p, w_s, w_p;
};

// 2^v by the SFU, subnormal results flushed to 0.
__device__ __forceinline__ float ex2_ftz(float v) {
#ifdef LYNX_HOST_STAND_IN
  return exp2f(v);
#else
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#endif
}

// exp(-d^2 / (2 h^2)) as exp2(d^2 c)^2, c = -log2(e) / (4 h^2).
__device__ __forceinline__ float gaussian(float d, float c) {
  const float r = ex2_ftz(d * d * c);
  return r * r;
}
__device__ __forceinline__ double gaussian(double d, double c) {
  const double r = exp2(d * d * c);
  return r * r;
}

// The bandwidth: the 0-d tensor at h_ptr, or h; and the Gaussians' c.
template <typename T> __device__ __forceinline__ double bandwidth(const T* h_ptr, double h) {
  return h_ptr ? static_cast<double>(*h_ptr) : h;
}
__device__ __forceinline__ double exponent_scale(double h) { return -kLog2e / (4.0 * h * h); }

// Four consecutive values of shared memory (16-byte aligned).
template <typename T> __device__ __forceinline__ void load4(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = src[i];
  }
}

// A thread's row i of a block's tile: m + (i & 3) + 64 (i >> 2), m = 4 x its
// row group; its column j: n + (j & 3) + 32 (j >> 2), n = 4 x its column
// group.  A warp's 8 column groups read 128 consecutive bytes, its 4 row
// groups 64 a slab.
__device__ __forceinline__ int tile_row(int m, int i) { return m + (i & 3) + 64 * (i >> 2); }
__device__ __forceinline__ int tile_col(int n, int j) { return n + (j & 3) + 32 * (j >> 2); }

// acc[i][j] += left[kk][row i] right[kk][column j] over one chunk.
template <typename T, int kLeftStride, int kRightStride>
__device__ __forceinline__ void multiply(T (&acc)[kRowsPer<T>][8], const T* left, const T* right,
                                         int m, int n) {
#pragma unroll 8  // a whole chunk's unrolled code outgrows the instruction cache
  for (int kk = 0; kk < Shape<T>::kChunk; ++kk) {
    T a[kRowsPer<T>], b[8];
#pragma unroll
    for (int q = 0; q < Shape<T>::kSlabs; ++q) {
      load4(a + 4 * q, left + kk * kLeftStride + m + 64 * q);
    }
    load4(b, right + kk * kRightStride + n);
    load4(b + 4, right + kk * kRightStride + n + 32);
#pragma unroll
    for (int i = 0; i < kRowsPer<T>; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
  }
}

// The image (see the note).  grid: (row tiles x column tiles x splits,
// settings); out: (settings, splits, height, width).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) kde_image_kernel(
    Coordinates<T> in, const T* __restrict__ x_centres, const T* __restrict__ y_centres,
    const T* __restrict__ h_ptr, double h, long long n, int height, int width, int col_tiles,
    int splits, long long span, T* __restrict__ out) {
  constexpr int kChunk = Shape<T>::kChunk, kM = kTileM<T>;
  constexpr int kStrideM = kM + 4, kStrideN = kTileN + 4;
  constexpr int kRowRepeat = kM / kThreads;             // K_y rows a thread makes
  constexpr int kColStep = kThreads / kTileN;             // K_x: particles k0 + kColStep j
  constexpr int kColsPer = kChunk * kTileN / kThreads;  // K_x values a thread makes
  __shared__ __align__(16) T ky[2][kChunk * kStrideM];
  __shared__ __align__(16) T kx[2][kChunk * kStrideN];
  __shared__ __align__(16) T chunk_x[2][kChunk];
  __shared__ __align__(16) T chunk_y[2][kChunk];
  __shared__ __align__(16) T chunk_w[2][kChunk];

  const Coordinates<T> op = in;
  const int t = threadIdx.x;
  const long long s = blockIdx.y;
  const int split = static_cast<int>(blockIdx.x % splits);
  const int tile = static_cast<int>(blockIdx.x / splits);
  const int row0 = tile / col_tiles * kM, col0 = tile % col_tiles * kTileN;
  const long long lo = split * span;
  const long long hi = lo + span < n ? lo + span : n;
  const long long chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  const T c = static_cast<T>(exponent_scale(bandwidth(h_ptr, h)));

  // Making a chunk: thread t makes rows t + kThreads r of K_y, and column
  // t % kTileN of w K_x for particles t / kTileN + kColStep j.
  T row_centre[kRowRepeat];
#pragma unroll
  for (int r = 0; r < kRowRepeat; ++r) {
    const int row = row0 + t + kThreads * r;
    row_centre[r] = row < height ? y_centres[row] : T(0);
  }
  const int col = t % kTileN, k_first = t / kTileN;
  const T col_centre = col0 + col < width ? x_centres[col0 + col] : T(0);

  // A chunk's particles: thread t < kChunk fetches particle t into
  // registers, then stages it; past the split its weight is 0.
  T px = T(0), py = T(0), pw = T(0);
  auto fetch = [&](long long q) {
    const long long p = lo + q * kChunk + t;
    if (t < kChunk) {
      if (p < hi) {
        px = op.x[s * op.x_s + p * op.x_p];
        py = op.y[s * op.y_s + p * op.y_p];
        pw = op.w ? op.w[s * op.w_s + p * op.w_p] : T(1);
      } else {
        px = py = pw = T(0);
      }
    }
  };
  auto stage = [&](int buf) {
    if (t < kChunk) {
      chunk_x[buf][t] = px;
      chunk_y[buf][t] = py;
      chunk_w[buf][t] = pw;
    }
  };
  auto make = [&](int buf) {
#pragma unroll
    for (int k4 = 0; k4 < kChunk; k4 += 4) {
      T yk[4];
      load4(yk, chunk_y[buf] + k4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < kRowRepeat; ++r) {
          ky[buf][(k4 + k) * kStrideM + t + kThreads * r] = gaussian(yk[k] - row_centre[r], c);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPer; ++j) {
      const int k = k_first + kColStep * j;
      kx[buf][k * kStrideN + col] = chunk_w[buf][k] * gaussian(chunk_x[buf][k] - col_centre, c);
    }
  };

  const int warp = t / 32, lane = t % 32;
  const int m = (warp * 4 + lane / kGroups) * 4, nn = lane % kGroups * 4;
  T acc[kRowsPer<T>][8];
#pragma unroll
  for (int i = 0; i < kRowsPer<T>; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  }
  fetch(0);
  stage(0);
  fetch(1);
  stage(1);
  fetch(2);
  __syncthreads();
  make(0);
  __syncthreads();
  for (long long q = 0; q < chunks; ++q) {
    const int buf = static_cast<int>(q & 1);
    stage(buf);     // chunk q + 2, over chunk q's particles
    fetch(q + 3);
    make(buf ^ 1);  // chunk q + 1, staged a chunk ago (past the last: unread)
    multiply<T, kStrideM, kStrideN>(acc, ky[buf], kx[buf], m, nn);
    __syncthreads();
  }

  T* image = out + (s * splits + split) * height * static_cast<long long>(width);
#pragma unroll
  for (int i = 0; i < kRowsPer<T>; ++i) {
    const int r = row0 + tile_row(m, i);
    if (r >= height) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = col0 + tile_col(nn, j);
      if (cc < width) image[static_cast<long long>(r) * width + cc] = acc[i][j];
    }
  }
}

// out[s, i] = the sum of parts[s, k, i] over the splits k, in order.
template <typename T>
__global__ void __launch_bounds__(256) kde_sum_splits_kernel(const T* __restrict__ parts,
                                                             T* __restrict__ out, long long pixels,
                                                             long long total, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long s = i / pixels;
    const T* src = parts + s * splits * pixels + (i - s * pixels);
    T sum = src[0];
    for (int k = 1; k < splits; ++k) sum += src[k * pixels];
    out[i] = sum;
  }
}

// kde_grad_kernel's shared memory, in values: the chunk stages, the inner and
// outer centres (the larger phase's), the particles' outer coordinates and
// the sums' slots.
template <typename T> struct GradShared {
  static constexpr int kStrideM = kTileM<T> + 4, kStrideN = kTileN + 4;
  static constexpr int kStages = 2 * Shape<T>::kChunk * (kStrideM + kStrideN);
  static constexpr int kSums = 2 * kGroups * kTileM<T>;
  static int centres(int inner, int outer) {
    constexpr int kChunk = Shape<T>::kChunk;
    return (inner + kChunk - 1) / kChunk * kChunk + (outer + kTileN - 1) / kTileN * kTileN;
  }
};

// One phase of the gradient for the block's kTileM particles of setting s
// (see the note): kAlongY false forms A = K_y G (inner axis: rows) and sums
// over the columns, true forms B = K_x G^T (inner axis: columns) and sums
// over the rows.
template <typename T, bool kAlongY>
__device__ __forceinline__ void grad_phase(unsigned char* shared, Coordinates<T> in,
                                           const T* x_centres, const T* y_centres, const T* grad,
                                           T c, T scale, long long s, long long n, int height,
                                           int width, T* gx, T* gy, T* gw) {
  using Layout = GradShared<T>;
  constexpr int kChunk = Shape<T>::kChunk, kM = kTileM<T>;
  constexpr int kStrideM = Layout::kStrideM;
  constexpr int kStrideN = Layout::kStrideN;  // G's transposed stores conflict-free
  constexpr int kLoads = kChunk * kTileN / kThreads;
  constexpr int kRepeat = kM / kThreads;  // particles a thread makes values of
  const int inner = kAlongY ? width : height;  // contracted with G
  const int outer = kAlongY ? height : width;  // summed over in the epilogue
  const int inner_chunks = (inner + kChunk - 1) / kChunk;
  const int outer_tiles = (outer + kTileN - 1) / kTileN;
  T* made = reinterpret_cast<T*>(shared);                // [2][kChunk][kStrideM]
  T* g_tile = made + 2 * kChunk * kStrideM;              // [2][kChunk][kStrideN]
  T* sums = made + Layout::kStages;                      // [2][kGroups][kM]: A K, A K d
  T* outer_coord = sums + Layout::kSums;                 // [kM]
  T* inner_centres = outer_coord + kM;                   // [inner_chunks * kChunk]
  T* outer_centres = inner_centres + inner_chunks * kChunk;  // [outer_tiles * kTileN]

  const int t = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * kM;
  T u[kRepeat];  // the particles' inner coordinates
#pragma unroll
  for (int r = 0; r < kRepeat; ++r) {
    const long long p = p0 + t + kThreads * r;
    T x = T(0), y = T(0);
    if (p < n) {
      x = in.x[s * in.x_s + p * in.x_p];
      y = in.y[s * in.y_s + p * in.y_p];
    }
    u[r] = kAlongY ? x : y;
    outer_coord[t + kThreads * r] = kAlongY ? y : x;
  }
  const T* inner_src = kAlongY ? x_centres : y_centres;
  const T* outer_src = kAlongY ? y_centres : x_centres;
  for (int i = t; i < inner_chunks * kChunk; i += kThreads) {
    inner_centres[i] = i < inner ? inner_src[i] : T(0);
  }
  for (int i = t; i < outer_tiles * kTileN; i += kThreads) {
    outer_centres[i] = i < outer ? outer_src[i] : T(0);
  }
  const T* g_s = grad + s * height * static_cast<long long>(width);

  // Chunk q: inner values q % inner_chunks, outer tile q / inner_chunks.
  // Load e of a chunk is G at (inner kk, outer nn); the y phase walks G's
  // columns (its inner axis) fastest, 8 at a time.
  T staged[kLoads];
  auto place = [&](int e, int& kk, int& nn) {
    if (kAlongY) {
      kk = e % 8 + 8 * (e / (8 * kTileN));
      nn = e / 8 % kTileN;
    } else {
      kk = e / kTileN;
      nn = e % kTileN;
    }
  };
  auto fetch = [&](int q) {
    const int k0 = q % inner_chunks * kChunk, n0 = q / inner_chunks * kTileN;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      int kk, nn;
      place(t + kThreads * j, kk, nn);
      const int ki = k0 + kk, ni = n0 + nn;
      const long long at = kAlongY ? static_cast<long long>(ni) * width + ki
                                   : static_cast<long long>(ki) * width + ni;
      staged[j] = ki < inner && ni < outer ? g_s[at] : T(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      int kk, nn;
      place(t + kThreads * j, kk, nn);
      g_tile[(buf * kChunk + kk) * kStrideN + nn] = staged[j];
    }
  };
  auto make = [&](int buf, int q) {
    const int k0 = q % inner_chunks * kChunk;
    T* dst = made + buf * kChunk * kStrideM + t;
#pragma unroll
    for (int k4 = 0; k4 < kChunk; k4 += 4) {
      T centre[4];
      load4(centre, inner_centres + k0 + k4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < kRepeat; ++r) {
          dst[(k4 + k) * kStrideM + kThreads * r] = gaussian(u[r] - centre[k], c);
        }
      }
    }
  };

  const int warp = t / 32, lane = t % 32;
  const int group = lane % kGroups;
  const int m = (warp * 4 + lane / kGroups) * 4, nn = group * 4;
  T acc[kRowsPer<T>][8];
#pragma unroll
  for (int i = 0; i < kRowsPer<T>; ++i) {
    sums[group * kM + tile_row(m, i)] = T(0);
    sums[(kGroups + group) * kM + tile_row(m, i)] = T(0);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  }
  // The epilogue of an outer tile: each of the thread's particles adds its
  // sums over the thread's columns to its slots (the thread's own).  Past the
  // outer axis G, so A, is 0 and the centres 0: those terms add exactly 0
  // for a finite coordinate (a coordinate that is not gives NaN either way).
  auto reduce = [&](int q) {
    const int n0 = q / inner_chunks * kTileN;
#pragma unroll
    for (int i = 0; i < kRowsPer<T>; ++i) {
      const int mi = tile_row(m, i);
      const T v = outer_coord[mi];
      T k_sum = T(0), kd_sum = T(0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T d = v - outer_centres[n0 + tile_col(nn, j)];
        const T e = acc[i][j] * gaussian(d, c);
        if constexpr (!kAlongY) k_sum += e;
        kd_sum += e * d;
        acc[i][j] = T(0);
      }
      if constexpr (!kAlongY) sums[group * kM + mi] += k_sum;
      sums[(kGroups + group) * kM + mi] += kd_sum;
    }
  };

  const int total = outer_tiles * inner_chunks;
  __syncthreads();  // the centres and the outer coordinates
  fetch(0);
  store(0);
  make(0, 0);
  if (total > 1) fetch(1);
  __syncthreads();
  for (int q = 0; q < total; ++q) {
    const int buf = q & 1;
    store(buf ^ 1);  // chunk q + 1 (past the last: unread)
    fetch(q + 2);    // past the last: zeros
    make(buf ^ 1, q + 1);
    multiply<T, kStrideM, kStrideN>(acc, made + buf * kChunk * kStrideM,
                                   g_tile + buf * kChunk * kStrideN, m, nn);
    if (q % inner_chunks == inner_chunks - 1) reduce(q);
    __syncthreads();
  }

  // A particle's sums are spread over the kGroups column groups of its row
  // group: add them in order.
#pragma unroll
  for (int r = 0; r < kRepeat; ++r) {
    const int mi = t + kThreads * r;
    const long long p = p0 + mi;
    if (p >= n) continue;
    T k_sum = T(0), kd_sum = T(0);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      k_sum += sums[g * kM + mi];
      kd_sum += sums[(kGroups + g) * kM + mi];
    }
    const T w = in.w ? in.w[s * in.w_s + p * in.w_p] : T(1);
    const long long at = s * n + p;
    if (kAlongY) {
      gy[at] = scale * w * kd_sum;
    } else {
      if (gx) gx[at] = scale * w * kd_sum;
      if (gw) gw[at] = k_sum;
    }
  }
}

// The gradient (see the note).  grid: (particle tiles, settings x phases);
// phase first_phase + blockIdx.y / settings: 0 the x phase, 1 the y phase.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) kde_grad_kernel(
    Coordinates<T> in, const T* __restrict__ x_centres, const T* __restrict__ y_centres,
    const T* __restrict__ h_ptr, double h, const T* __restrict__ grad, long long settings,
    long long n, int height, int width, int first_phase, T* __restrict__ gx,
    T* __restrict__ gy, T* __restrict__ gw) {
  extern __shared__ __align__(16) unsigned char kde_shared[];
  const long long s = blockIdx.y % settings;
  const bool along_y = first_phase + static_cast<int>(blockIdx.y / settings) == 1;
  const double hd = bandwidth(h_ptr, h);
  const T c = static_cast<T>(exponent_scale(hd));
  const T scale = static_cast<T>(-1.0 / (hd * hd));
  if (along_y) {
    grad_phase<T, true>(kde_shared, in, x_centres, y_centres, grad, c, scale, s, n, height,
                        width, gx, gy, gw);
  } else {
    grad_phase<T, false>(kde_shared, in, x_centres, y_centres, grad, c, scale, s, n, height,
                         width, gx, gy, gw);
  }
}

template <typename T>
Coordinates<T> coordinates(const void* x, const void* y, const void* w, const long long* strides) {
  return {static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(w),
          strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]};
}

template <typename T>
void launch_image(const void* x, const void* y, const void* w, const long long* strides,
                  const void* x_centres, const void* y_centres, const void* h_ptr, double h,
                  long long settings, long long n, int height, int width, int row_tiles,
                  int col_tiles, int splits, long long span, void* parts, void* out,
                  cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(row_tiles * col_tiles * splits),
                  static_cast<unsigned>(settings));
  kde_image_kernel<T><<<grid, kThreads, 0, stream>>>(
      coordinates<T>(x, y, w, strides), static_cast<const T*>(x_centres),
      static_cast<const T*>(y_centres), static_cast<const T*>(h_ptr), h, n, height, width,
      col_tiles, splits, span, static_cast<T*>(splits > 1 ? parts : out));
  if (splits > 1) {
    const long long pixels = static_cast<long long>(height) * width;
    const long long total = settings * pixels;
    const long long wanted = (total + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(wanted < 4096 ? wanted : 4096);
    kde_sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(parts), static_cast<T*>(out), pixels, total, splits);
  }
}

template <typename T>
int launch_grad(const void* x, const void* y, const void* w, const long long* strides,
                const void* x_centres, const void* y_centres, const void* h_ptr, double h,
                const void* grad, long long settings, long long n, int height, int width,
                void* gx, void* gy, void* gw, cudaStream_t stream) {
  using Layout = GradShared<T>;
  const int first_phase = gx || gw ? 0 : 1;
  const int phases = (gx || gw ? 1 : 0) + (gy ? 1 : 0);
  const int x_phase = Layout::centres(height, width), y_phase = Layout::centres(width, height);
  const size_t bytes = sizeof(T) * static_cast<size_t>(Layout::kStages + Layout::kSums +
                                                       kTileM<T> +
                                                       (x_phase > y_phase ? x_phase : y_phase));
  if (bytes > 48 * 1024) {
    const cudaError_t code = cudaFuncSetAttribute(
        kde_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (code != cudaSuccess) return static_cast<int>(code);
  }
  const dim3 grid(static_cast<unsigned>((n + kTileM<T> - 1) / kTileM<T>),
                  static_cast<unsigned>(settings * phases));
  kde_grad_kernel<T><<<grid, kThreads, bytes, stream>>>(
      coordinates<T>(x, y, w, strides), static_cast<const T*>(x_centres),
      static_cast<const T*>(y_centres), static_cast<const T*>(h_ptr), h,
      static_cast<const T*>(grad), settings, n, height, width, first_phase, static_cast<T*>(gx),
      static_cast<T*>(gy), static_cast<T*>(gw));
  return 0;
}

}  // namespace

extern "C" {

// The images (see the note).  x, y, w: (settings, n) with element strides
// (x_s, x_p, y_s, y_p, w_s, w_p); w null for weights of 1.  x_centres
// (width,), y_centres (height,), contiguous.  h_ptr: the bandwidth as a 0-d
// tensor the kernel reads, or null for h.  row_tiles, col_tiles, splits,
// span: ops/kde.py's kde_plan, the image's tiles of kTileM x kTileN and the
// particles' split (split k takes particles [k span, (k + 1) span)).
// parts: (settings, splits, height, width) where splits > 1; out:
// (settings, height, width).  All float (is_double = 0) or double.  Returns
// cudaGetLastError().
int lynx_kde_image(int is_double, const void* x, const void* y, const void* w, long long x_s,
                   long long x_p, long long y_s, long long y_p, long long w_s, long long w_p,
                   const void* x_centres, const void* y_centres, const void* h_ptr, double h,
                   long long settings, long long n, int height, int width, int row_tiles,
                   int col_tiles, int splits, long long span, void* parts, void* out,
                   void* stream) {
  if (splits < 1 || span < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (settings > 0 && height > 0 && width > 0) {
    const long long strides[6] = {x_s, x_p, y_s, y_p, w_s, w_p};
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch_image<double>(x, y, w, strides, x_centres, y_centres, h_ptr, h, settings, n, height,
                           width, row_tiles, col_tiles, splits, span, parts, out, s);
    } else {
      launch_image<float>(x, y, w, strides, x_centres, y_centres, h_ptr, h, settings, n, height,
                          width, row_tiles, col_tiles, splits, span, parts, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient (see the note) for the images' cotangent grad (settings,
// height, width), contiguous: gx, gy, gw (settings, n), each null where it
// is not wanted.  Operands as lynx_kde_image's.  Returns cudaGetLastError().
int lynx_kde_grad(int is_double, const void* x, const void* y, const void* w, long long x_s,
                  long long x_p, long long y_s, long long y_p, long long w_s, long long w_p,
                  const void* x_centres, const void* y_centres, const void* h_ptr, double h,
                  const void* grad, long long settings, long long n, int height, int width,
                  void* gx, void* gy, void* gw, void* stream) {
  if (settings > 0 && n > 0 && height > 0 && width > 0 && (gx || gy || gw)) {
    const long long strides[6] = {x_s, x_p, y_s, y_p, w_s, w_p};
    auto s = static_cast<cudaStream_t>(stream);
    const int code =
        is_double ? launch_grad<double>(x, y, w, strides, x_centres, y_centres, h_ptr, h, grad,
                                        settings, n, height, width, gx, gy, gw, s)
                  : launch_grad<float>(x, y, w, strides, x_centres, y_centres, h_ptr, h, grad,
                                       settings, n, height, width, gx, gy, gw, s);
    if (code != 0) return code;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// The count-histogram A/B (kernel B7) for Hopper, sm_90a: two kernels that
// count the (lx, ly) pairs of N particles into a (win_x, win_y) int32
// window, the A/B variants of kernel B1's count mode.
//
// Replaces the TPU kernels benchmarks/hist_ab.py:kernel and
// :kernel_twolevel (made by make_kernel, launched by run_variant).  Both
// count the pairs with 0 <= lx < win_x and 0 <= ly < win_y; any other pair
// (a -1 pad, an index outside the window) is dropped, not clipped, as the
// TPU kernels' one-hot compares drop it.
//
// What bounds them on an H100: the function reads 8 bytes a particle and
// writes the 975 KB window once, 0.53 us at 3.35 TB/s at the harness's
// shape (100,000 particles, window (952, 256)).  The one-hot contraction
// does 2 N win_x win_y int8 operations on top, 0.025 ms at the card's dense
// int8 rate (1,979 TOP/s): it cannot win against B1's atomics (0.0036 ms),
// and the A/B records by how much.
//
// onehot: the TPU kernel's formulation, the contraction of the one-hot
// matrices A = (lx == x) and B = (ly == y) over the particles, on Hopper's
// int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32).  A block owns a
// 64 x 32 tile of the window (four warps of 16 rows, four 8-column mma
// tiles each) and a split of the particles, staged kChunk at a time in
// shared memory (the TPU kernel's tile_n / halves, the port's one knob).
// Each lane forms its A and B fragments in registers by comparing its
// staged particles' lx and ly with the fragment's rows and columns: the
// four particles of a fragment register are one 16-byte load.  The splits'
// partial tiles are added with int32 atomics, exact in any order.
//
// twolevel: the TPU kernel's factoring x = 8 h + l becomes the band and the
// row: a block owns a band of band_rows window rows (hi = lx / band_rows),
// keeps it in shared memory and counts its band's pairs there with
// shared-memory atomics (the row lo = lx % band_rows); it writes the band
// once, with plain stores, or int32 atomics where the particles are split
// across blocks.  It asks whether privatising the window beats B1's atomics
// in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kTileX = 16 * kWarps;  // window rows of a onehot block
constexpr int kTileY = 32;           // window columns of a onehot block: four mma tiles
constexpr int kBandThreads = 256;
constexpr int kResidentBlocks = 132 * 4;  // blocks that fill the card's 132 SMs

#ifndef LYNX_HOST_STAND_IN
// d += a b for the warp's fragments: A 16 x 32 s8 (row), B 32 x 8 s8 (col),
// D 16 x 8 s32 (mma.sync, sm_80 and later).
__device__ __forceinline__ void lynx_mma_s8(int (&d)[4], const unsigned (&a)[4],
                                            const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// The s8 one-hot of four particles' indices against `value`: byte i is 1
// where index i equals it (element i of a fragment register is its byte i).
__device__ __forceinline__ unsigned match4(const int4& v, int value) {
  return static_cast<unsigned>(v.x == value) | static_cast<unsigned>(v.y == value) << 8 |
         static_cast<unsigned>(v.z == value) << 16 | static_cast<unsigned>(v.w == value) << 24;
}

template <int kChunk>
__global__ void __launch_bounds__(32 * kWarps) onehot_kernel(
    const int32_t* __restrict__ lx, const int32_t* __restrict__ ly, int32_t* __restrict__ out,
    int64_t n, int win_x, int win_y, int64_t per_split) {
  __shared__ __align__(16) int s_lx[kChunk];
  __shared__ __align__(16) int s_ly[kChunk];
  const int tiles_y = (win_y + kTileY - 1) / kTileY;
  const int x0 = static_cast<int>(blockIdx.x) / tiles_y * kTileX;
  const int y0 = static_cast<int>(blockIdx.x) % tiles_y * kTileY;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * per_split;
  const int64_t end = begin + per_split < n ? begin + per_split : n;
  const int lane = threadIdx.x % 32;
  const int group = lane / 4, quad = lane % 4;  // the PTX fragment layouts' groupID, threadID_in_group
  const int row_lo = x0 + threadIdx.x / 32 * 16 + group;
  const int row_hi = row_lo + 8;

  int acc[4][4] = {};  // per 8-column tile: rows (group, group + 8) x columns (2 quad, + 1)
  for (int64_t c0 = begin; c0 < end; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kChunk; i += 32 * kWarps) {
      const int64_t k = c0 + i;
      s_lx[i] = k < end ? lx[k] : -1;  // a ragged chunk's tail matches no row
      s_ly[i] = k < end ? ly[k] : -1;
    }
    __syncthreads();
    for (int s = 0; s < kChunk; s += 32) {
      // Particles 4 quad .. +3 and 16 + 4 quad .. +3 of the step: the k
      // indices of this lane's A registers and of its B registers alike.
      const int4 xa = *reinterpret_cast<const int4*>(s_lx + s + 4 * quad);
      const int4 xb = *reinterpret_cast<const int4*>(s_lx + s + 16 + 4 * quad);
      const int4 ya = *reinterpret_cast<const int4*>(s_ly + s + 4 * quad);
      const int4 yb = *reinterpret_cast<const int4*>(s_ly + s + 16 + 4 * quad);
      const unsigned a[4] = {match4(xa, row_lo), match4(xa, row_hi), match4(xb, row_lo),
                             match4(xb, row_hi)};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int column = y0 + 8 * t + group;
        const unsigned b[2] = {match4(ya, column), match4(yb, column)};
        lynx_mma_s8(acc[t], a, b);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? row_lo : row_hi;
      const int column = y0 + 8 * t + 2 * quad + (i & 1);
      // Rows and columns past the window (a padded tile) are dropped.
      if (acc[t][i] != 0 && row < win_x && column < win_y) {
        atomicAdd(out + static_cast<int64_t>(row) * win_y + column, acc[t][i]);
      }
    }
  }
}

__global__ void __launch_bounds__(kBandThreads) twolevel_kernel(
    const int32_t* __restrict__ lx, const int32_t* __restrict__ ly, int32_t* __restrict__ out,
    int64_t n, int win_x, int win_y, int band_rows, int64_t per_split, int split) {
  extern __shared__ __align__(16) int s_band[];
  const int band = blockIdx.x;
  const int x0 = band * band_rows;
  const int rows = win_x - x0 < band_rows ? win_x - x0 : band_rows;
  const int cells = rows * win_y;
  for (int i = threadIdx.x; i < cells; i += kBandThreads) s_band[i] = 0;
  __syncthreads();
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * per_split;
  const int64_t end = begin + per_split < n ? begin + per_split : n;
  for (int64_t k = begin + threadIdx.x; k < end; k += kBandThreads) {
    const int x = lx[k], y = ly[k];
    if (x < 0 || y < 0 || x >= win_x || y >= win_y) continue;  // dropped
    const int hi = x / band_rows;  // the first level: the band
    if (hi != band) continue;
    atomicAdd(s_band + (x - hi * band_rows) * win_y + y, 1);  // the second: the row
  }
  __syncthreads();
  int32_t* dst = out + static_cast<int64_t>(x0) * win_y;
  for (int i = threadIdx.x; i < cells; i += kBandThreads) {
    if (!split) {
      dst[i] = s_band[i];
    } else if (s_band[i] != 0) {
      atomicAdd(dst + i, s_band[i]);
    }
  }
}

// Particle splits: enough blocks to fill the card, each split at least one
// staging step of particles.
int64_t splits_for(int64_t n, int64_t blocks, int64_t step) {
  int64_t splits = (kResidentBlocks + blocks - 1) / blocks;
  const int64_t most = (n + step - 1) / step;
  if (splits > most) splits = most;
  return splits < 1 ? 1 : splits;
}

template <int kChunk>
void launch_onehot(const int32_t* lx, const int32_t* ly, int32_t* out, int64_t n, int win_x,
                   int win_y, cudaStream_t stream) {
  const int tiles = (win_x + kTileX - 1) / kTileX * ((win_y + kTileY - 1) / kTileY);
  const int64_t splits = splits_for(n, tiles, kChunk);
  const int64_t per_split = (n + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits));
  onehot_kernel<kChunk><<<grid, 32 * kWarps, 0, stream>>>(lx, ly, out, n, win_x, win_y,
                                                          per_split);
}

}  // namespace

extern "C" {

// Particle splits of a launch (the grid's second dimension).
long long lynx_hist_onehot_splits(long long n, int win_x, int win_y, int chunk) {
  const int tiles = (win_x + kTileX - 1) / kTileX * ((win_y + kTileY - 1) / kTileY);
  return splits_for(n, tiles, chunk);
}

long long lynx_hist_twolevel_splits(long long n, int win_x, int band_rows) {
  return splits_for(n, (win_x + band_rows - 1) / band_rows, kBandThreads);
}

// lx, ly: (n,) int32 window indices; out: (win_x, win_y) int32, zeroed by
// the caller.  chunk: particles staged per step, 256, 1024 or 2048.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another chunk.
int lynx_hist_onehot(const void* lx, const void* ly, void* out, long long n, int win_x,
                     int win_y, int chunk, void* stream) {
  const auto* x = static_cast<const int32_t*>(lx);
  const auto* y = static_cast<const int32_t*>(ly);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    switch (chunk) {
      case 256: launch_onehot<256>(x, y, o, n, win_x, win_y, s); break;
      case 1024: launch_onehot<1024>(x, y, o, n, win_x, win_y, s); break;
      case 2048: launch_onehot<2048>(x, y, o, n, win_x, win_y, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// As lynx_hist_onehot, with bands of band_rows window rows in shared memory
// (band_rows * win_y * 4 bytes, at most the 227 KB of a block).
int lynx_hist_twolevel(const void* lx, const void* ly, void* out, long long n, int win_x,
                       int win_y, int band_rows, void* stream) {
  const int bytes = band_rows * win_y * static_cast<int>(sizeof(int));
  if (band_rows < 1 || bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int bands = (win_x + band_rows - 1) / band_rows;
    const int64_t splits = splits_for(n, bands, kBandThreads);
    const int64_t per_split = (n + splits - 1) / splits;
    cudaFuncSetAttribute(twolevel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    const dim3 grid(static_cast<unsigned>(bands), static_cast<unsigned>(splits));
    twolevel_kernel<<<grid, kBandThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lx), static_cast<const int32_t*>(ly),
        static_cast<int32_t*>(out), n, win_x, win_y, band_rows, per_split, splits > 1);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// shape (100,000 particles, window (952, 256)).
//
// onehot: the TPU kernel's formulation, the contraction of the one-hot
// matrices A = (lx == x) and B = (ly == y) over the particles, on Hopper's
// int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), contracting only
// the row tiles that particles hit.  Each particle falls in one 16-row tile
// of the window, so the particles are first bucketed by row tile:
// - onehot_count_kernel counts each block's in-window pairs per tile with
//   shared-memory atomics (and zeroes the window);
// - onehot_scatter_kernel takes each block's offsets from those counts (an
//   exclusive scan over the tiles, buckets starting on 32-particle
//   boundaries) and writes each pair into its bucket as one int32, the row
//   inside the tile in byte 0 and ly above it; its first block writes the
//   contraction's items, (from, to, tile) of each span of up to `chunk`
//   pairs of a bucket.  Pairs outside the window are dropped here, once;
//   the order inside a bucket does not matter, as the counts are integers.
// - onehot_contract_kernel: a warp (one block) takes an item and 128 of the
//   window's columns: 16 rows x 16 mma tiles of 8 columns.  Per step of 32
//   particles each lane loads its 8 particles as two 16-byte vectors (the
//   next step's while this one's mma run), gathers their rows and columns
//   into four bytes a register (byte_perm) and forms its A and B fragments
//   by byte-wise compares (vcmpeq4: 0xff, which is -1 in s8, where equal;
//   -1 times -1 adds 1); the A fragments serve all 16 column tiles.  Spans
//   that share a tile add their partial tiles with int32 atomics, exact in
//   any order.  The mma count is about (N / 32 + tiles) x win_y / 8 against
//   the dense formulation's N / 32 x win_x win_y / 128.
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

constexpr int kTileRows = 16;       // window rows of a bucket: the mma's M
constexpr int kSliceColumns = 128;  // window columns of a contraction warp: 16 mma tiles
constexpr int kBinThreads = 256;    // threads of the count and scatter blocks
constexpr int kBinChunk = 1024;     // particles of a count and scatter block, at least
constexpr int64_t kBinBlocks = 512;  // count and scatter blocks, at most
constexpr int kMaxTiles = 2048;     // row tiles (win_x <= 32,768): the scatter's 40 KB of offsets
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

__device__ __forceinline__ unsigned lynx_vcmpeq4(unsigned a, unsigned b) {
  return __vcmpeq4(a, b);
}

__device__ __forceinline__ unsigned lynx_byte_perm(unsigned a, unsigned b, unsigned s) {
  return __byte_perm(a, b, s);
}
#endif

// The row tile of a pair, or -1 for a pair outside the window (dropped).
__device__ __forceinline__ int tile_of(int x, int y, int win_x, int win_y) {
  return x < 0 || y < 0 || x >= win_x || y >= win_y ? -1 : x / kTileRows;
}

// Byte kByte of each of four packed pairs, pair i in byte i.
template <unsigned kByte>
__device__ __forceinline__ unsigned gather_bytes(const int4& v) {
  constexpr unsigned kPick = kByte | (4 + kByte) << 4;  // byte kByte of the first, the second word
  const unsigned lo = lynx_byte_perm(v.x, v.y, kPick);
  const unsigned hi = lynx_byte_perm(v.z, v.w, kPick);
  return lynx_byte_perm(lo, hi, 0x5410);
}

// Four packed pairs k .. k + 3, each left as it is if it lies before `to`
// and in the 256 columns block256, else -1: its row byte 0xff matches no
// row.
__device__ __forceinline__ int4 only_in(int4 v, int64_t k, int64_t to, int block256) {
  v.x = k < to && v.x >> 16 == block256 ? v.x : -1;
  v.y = k + 1 < to && v.y >> 16 == block256 ? v.y : -1;
  v.z = k + 2 < to && v.z >> 16 == block256 ? v.z : -1;
  v.w = k + 3 < to && v.w >> 16 == block256 ? v.w : -1;
  return v;
}

// The onehot read's int32 workspace: per tile, each count block's pairs
// (tiles x blocks) and the number of contraction items; then, each on a
// 16-byte boundary, the items (from, to, tile, 0) for the most items the
// pairs can make, and the packed pairs (n + 32 tiles).
struct Buckets {
  int* per_block;
  int* n_items;
  int4* items;
  int* packed;
};

// The most contraction items of n pairs: each bucket's spans of `span`,
// of which each bucket's last may be short.
__host__ __device__ inline int64_t most_items(int64_t n, int tiles, int span) {
  return (n + span - 1) / span + tiles;
}

__host__ __device__ inline int64_t round4(int64_t count) { return (count + 3) / 4 * 4; }

__host__ __device__ inline Buckets buckets_of(int* base, int64_t n, int tiles, int blocks,
                                              int span) {
  Buckets w;
  w.per_block = base;
  w.n_items = base + static_cast<int64_t>(tiles) * blocks;
  int* items = base + round4(static_cast<int64_t>(tiles) * blocks + 1);
  w.items = reinterpret_cast<int4*>(items);
  w.packed = items + 4 * most_items(n, tiles, span);
  return w;
}

// Count and scatter blocks, and the particles of each (whole kBinThreads).
struct BinGrid {
  int blocks;
  int64_t chunk;
};

inline BinGrid bin_grid(int64_t n) {
  int64_t blocks = (n + kBinChunk - 1) / kBinChunk;
  blocks = blocks < 1 ? 1 : blocks > kBinBlocks ? kBinBlocks : blocks;
  int64_t chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + kBinThreads - 1) / kBinThreads * kBinThreads;
  return {static_cast<int>(blocks), chunk < kBinThreads ? kBinThreads : chunk};
}

__global__ void __launch_bounds__(kBinThreads) onehot_count_kernel(
    const int32_t* __restrict__ lx, const int32_t* __restrict__ ly, int32_t* __restrict__ out,
    int* __restrict__ per_block, int64_t n, int win_x, int win_y, int tiles, int64_t chunk) {
  extern __shared__ int s_count[];
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) s_count[t] = 0;
  // The window is zeroed here, before the contraction adds into it.
  const int64_t cells = static_cast<int64_t>(win_x) * win_y;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBinThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBinThreads + threadIdx.x;
  if (cells % 4 == 0) {
    const int4 zero = {0, 0, 0, 0};
    for (int64_t i = first; i < cells / 4; i += stride) reinterpret_cast<int4*>(out)[i] = zero;
  } else {
    for (int64_t i = first; i < cells; i += stride) out[i] = 0;
  }
  __syncthreads();
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  for (int64_t k = begin + threadIdx.x; k < begin + chunk && k < n; k += kBinThreads) {
    const int t = tile_of(lx[k], ly[k], win_x, win_y);
    if (t >= 0) atomicAdd(s_count + t, 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) {
    per_block[static_cast<int64_t>(t) * gridDim.x + blockIdx.x] = s_count[t];
  }
}

__global__ void __launch_bounds__(kBinThreads) onehot_scatter_kernel(
    const int32_t* __restrict__ lx, const int32_t* __restrict__ ly, int* __restrict__ workspace,
    int64_t n, int win_x, int win_y, int tiles, int64_t chunk, int span) {
  extern __shared__ int s_offsets[];
  int* s_base = s_offsets;           // this block's first slot in each bucket
  int* s_total = s_offsets + tiles;  // each bucket's pairs
  int* s_rank = s_offsets + 2 * tiles;
  int* s_begin = s_offsets + 3 * tiles;  // each bucket's first slot
  int* s_first = s_offsets + 4 * tiles;  // each bucket's first item
  const Buckets w = buckets_of(workspace, n, tiles, gridDim.x, span);
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) {
    const int* counts = w.per_block + static_cast<int64_t>(t) * gridDim.x;
    int before = 0, total = 0;
    for (unsigned g = 0; g < gridDim.x; ++g) {
      before += g < blockIdx.x ? counts[g] : 0;
      total += counts[g];
    }
    s_base[t] = before;
    s_total[t] = total;
    s_rank[t] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0, item = 0;
    for (int t = 0; t < tiles; ++t) {
      const int total = s_total[t];
      s_base[t] += start;
      s_begin[t] = start;
      s_first[t] = item;
      start += (total + 31) / 32 * 32;  // buckets start on 16-byte vectors of the warp's step
      item += (total + span - 1) / span;
    }
    if (blockIdx.x == 0) *w.n_items = item;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < tiles; t += kBinThreads) {
      const int end = s_begin[t] + s_total[t];
      int item = s_first[t];
      for (int from = s_begin[t]; from < end; from += span) {
        w.items[item++] = int4{from, from + span < end ? from + span : end, t, 0};
      }
    }
  }
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  for (int64_t k = begin + threadIdx.x; k < begin + chunk && k < n; k += kBinThreads) {
    const int x = lx[k], y = ly[k];
    const int t = tile_of(x, y, win_x, win_y);
    if (t < 0) continue;
    const int slot = s_base[t] + atomicAdd(s_rank + t, 1);
    w.packed[slot] = (x - t * kTileRows) | y << 8;
  }
}

__global__ void __launch_bounds__(32) onehot_contract_kernel(
    const int* __restrict__ workspace, int32_t* __restrict__ out, int64_t n, int win_x,
    int win_y, int tiles, int blocks, int span, int slices) {
  const Buckets w = buckets_of(const_cast<int*>(workspace), n, tiles, blocks, span);
  const int item = static_cast<int>(blockIdx.x) / slices;
  const int slice = static_cast<int>(blockIdx.x) - item * slices;
  const int4 range = w.items[item];  // inside the workspace for every warp of the grid
  if (item >= *w.n_items) return;  // the grid is sized for the most items
  const int64_t from = range.x, to = range.y;
  const int tile = range.z;
  const int lane = threadIdx.x;
  const int group = lane / 4, quad = lane % 4;  // PTX fragments' groupID, threadID_in_group
  const unsigned row_lo = group * 0x01010101u, row_hi = (group + 8) * 0x01010101u;
  const int column0 = slice * kSliceColumns;
  const int block256 = column0 / 256;  // the 256 columns whose low byte a pair carries

  int acc[16][4] = {};  // per 8-column tile: rows (group, group + 8) x columns (2 quad, + 1)
  // Particles 4 quad .. +3 and 16 + 4 quad .. +3 of a step: the k indices of
  // this lane's A registers and of its B registers alike.  The next step's
  // are loaded while this one's mma run.
  const int4* lane_pairs = reinterpret_cast<const int4*>(w.packed + from + 4 * quad);
  int4 u_next = lane_pairs[0], v_next = lane_pairs[4];
  for (int64_t s = from; s < to; s += 32, lane_pairs += 8) {
    int4 u = u_next, v = v_next;
    if (s + 32 < to) u_next = lane_pairs[8], v_next = lane_pairs[12];
    if (s + 32 > to || win_y > 256) {  // the same on every lane
      const int64_t k = s + 4 * quad;
      u = only_in(u, k, to, block256);
      v = only_in(v, k + 16, to, block256);
    }
    const unsigned rows_a = gather_bytes<0>(u), rows_b = gather_bytes<0>(v);
    const unsigned columns_a = gather_bytes<1>(u), columns_b = gather_bytes<1>(v);
    const unsigned a[4] = {lynx_vcmpeq4(rows_a, row_lo), lynx_vcmpeq4(rows_a, row_hi),
                           lynx_vcmpeq4(rows_b, row_lo), lynx_vcmpeq4(rows_b, row_hi)};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (column0 + 8 * t >= win_y) break;  // the same on every lane
      const unsigned column = ((column0 + 8 * t + group) & 0xff) * 0x01010101u;
      const unsigned b[2] = {lynx_vcmpeq4(columns_a, column), lynx_vcmpeq4(columns_b, column)};
      lynx_mma_s8(acc[t], a, b);
    }
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tile * kTileRows + group + (i < 2 ? 0 : 8);
      const int column = column0 + 8 * t + 2 * quad + (i & 1);
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

int onehot_tiles(int win_x) { return (win_x + kTileRows - 1) / kTileRows; }

// The contraction's grid: one warp for each (item, 128-column slice), for
// the most items n pairs can make.
int64_t onehot_warps(int64_t n, int win_x, int win_y, int span) {
  return most_items(n, onehot_tiles(win_x), span) * ((win_y + kSliceColumns - 1) / kSliceColumns);
}

}  // namespace

extern "C" {

// The onehot read's workspace, in int32 (see Buckets), and its
// contraction's grid of one-warp blocks.
long long lynx_hist_onehot_workspace(long long n, int win_x, int chunk) {
  const int tiles = onehot_tiles(win_x);
  const int blocks = bin_grid(n).blocks;
  return round4(static_cast<int64_t>(tiles) * blocks + 1) + 4 * most_items(n, tiles, chunk) + n +
         32LL * tiles;
}

long long lynx_hist_onehot_warps(long long n, int win_x, int win_y, int chunk) {
  return onehot_warps(n, win_x, win_y, chunk);
}

long long lynx_hist_twolevel_splits(long long n, int win_x, int band_rows) {
  return splits_for(n, (win_x + band_rows - 1) / band_rows, kBandThreads);
}

// lx, ly: (n,) int32 window indices; out: (win_x, win_y) int32, zeroed
// here; workspace: lynx_hist_onehot_workspace(n, win_x, chunk) int32, 16-byte
// aligned, as out is.  chunk: the most particles of one bucket a warp
// contracts, a multiple of 32 up to 65,536.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another chunk, a buffer off 16 bytes or a
// window past 32,768 rows or 8,388,607 columns.
int lynx_hist_onehot(const void* lx, const void* ly, void* out, void* workspace, long long n,
                     int win_x, int win_y, int chunk, void* stream) {
  const int tiles = onehot_tiles(win_x);
  const auto aligned = [](const void* pointer) {
    return reinterpret_cast<uintptr_t>(pointer) % 16 == 0;
  };
  if (!aligned(out) || !aligned(workspace) || chunk < 32 || chunk > 65536 || chunk % 32 != 0 ||
      win_x < 1 || win_y < 1 || tiles > kMaxTiles || win_y > (1 << 23) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const int32_t*>(lx);
  const auto* y = static_cast<const int32_t*>(ly);
  auto* o = static_cast<int32_t*>(out);
  auto* w = static_cast<int*>(workspace);
  auto s = static_cast<cudaStream_t>(stream);
  const BinGrid bins = bin_grid(n);
  const int count_bytes = tiles * static_cast<int>(sizeof(int));
  onehot_count_kernel<<<bins.blocks, kBinThreads, count_bytes, s>>>(x, y, o, w, n, win_x, win_y,
                                                                     tiles, bins.chunk);
  onehot_scatter_kernel<<<bins.blocks, kBinThreads, 5 * count_bytes, s>>>(
      x, y, w, n, win_x, win_y, tiles, bins.chunk, chunk);
  const int slices = (win_y + kSliceColumns - 1) / kSliceColumns;
  onehot_contract_kernel<<<static_cast<unsigned>(onehot_warps(n, win_x, win_y, chunk)), 32, 0,
                           s>>>(w, o, n, win_x, win_y, tiles, bins.blocks, chunk, slices);
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

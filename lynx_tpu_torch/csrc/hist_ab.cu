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
// twolevel: the TPU kernel's factoring x = 8 h + l becomes "which block of
// a thread-block cluster" and "which row of that block's shared memory".
// A cluster of C blocks (8, or 16 with non-portable clusters) holds the
// whole int32 window in its blocks' distributed shared memory: window row
// x lives in block x % C at row x / C, so the spot's busy central rows
// spread over every block of the cluster.  Each block zeroes its rows, the
// cluster syncs, each block reads its share of the pairs once (16-byte
// loads) and adds each in-window pair into the owning block's rows with an
// int32 atomicAdd through map_shared_rank; the cluster syncs again (no
// block may exit while another can still write into its shared memory),
// and each block writes its rows once with 16-byte stores.  K clusters
// split the pairs to fill the card; then, and only then, the output is
// zeroed first (in the entry point) and the partial windows merge with
// int32 atomics of their non-zero cells.  Each pair is read once per
// cluster, where blocks that each held a band of rows would read it once
// per band.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 16;       // window rows of a bucket: the mma's M
constexpr int kSliceColumns = 128;  // window columns of a contraction warp: 16 mma tiles
constexpr int kBinThreads = 256;    // threads of the count and scatter blocks
constexpr int kBinChunk = 1024;     // particles of a count and scatter block, at least
constexpr int64_t kBinBlocks = 512;  // count and scatter blocks, at most
constexpr int kMaxTiles = 2048;     // row tiles (win_x <= 32,768): the scatter's 40 KB of offsets
// Threads of a twolevel block: one block an SM (its shared memory), so as
// many warps as a block may have keep the loads and atomics in flight.  The
// host stand-in runs every thread of a cluster as a std::thread, and takes
// fewer.
#ifdef LYNX_HOST_STAND_IN
constexpr int kClusterThreads = 64;
#else
constexpr int kClusterThreads = 1024;
#endif
constexpr int kMaxCluster = 16;  // blocks of a cluster: 8 portable, 16 non-portable

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

// One pair into the cluster's window, or dropped.
__device__ __forceinline__ void twolevel_add(const cg::cluster_group& cluster, int* s_rows,
                                             int x, int y, int win_x, int win_y, int blocks) {
  if (x < 0 || y < 0 || x >= win_x || y >= win_y) return;  // dropped
  int* owner = cluster.map_shared_rank(s_rows, static_cast<unsigned>(x % blocks));  // the block
  atomicAdd(owner + (x / blocks) * win_y + y, 1);  // the row in it
}

// Window rows of block `rank` of a cluster of `blocks`: rank, rank + blocks, ...
__host__ __device__ __forceinline__ int twolevel_rows(int win_x, int rank, int blocks) {
  return win_x > rank ? (win_x - rank + blocks - 1) / blocks : 0;
}

// The grid is (C K) blocks in clusters of C; cluster k counts the pairs
// [k per_split, (k + 1) per_split).  vector: lx and ly lie on 16 bytes and
// per_split is a multiple of 4.  merge: K > 1, the output was zeroed.
__global__ void __launch_bounds__(kClusterThreads) twolevel_kernel(
    const int32_t* __restrict__ lx, const int32_t* __restrict__ ly, int32_t* __restrict__ out,
    int64_t n, int win_x, int win_y, int64_t per_split, int vector, int merge) {
  extern __shared__ __align__(16) int s_rows[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = twolevel_rows(win_x, rank, blocks);
  for (int i = threadIdx.x; i < rows * win_y; i += blockDim.x) s_rows[i] = 0;
  cluster.sync();  // every block's rows are zero before any pair lands

  const int64_t begin = static_cast<int64_t>(blockIdx.x / blocks) * per_split;
  const int64_t end = begin + per_split < n ? begin + per_split : n;
  const int64_t thread = static_cast<int64_t>(rank) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(blocks) * blockDim.x;
  int64_t scalar_from = begin;
  if (vector) {
    const int64_t quads = end > begin ? (end - begin) / 4 : 0;
    const int4* x4 = reinterpret_cast<const int4*>(lx + begin);
    const int4* y4 = reinterpret_cast<const int4*>(ly + begin);
    for (int64_t q = thread; q < quads; q += stride) {
      const int4 x = x4[q], y = y4[q];
      twolevel_add(cluster, s_rows, x.x, y.x, win_x, win_y, blocks);
      twolevel_add(cluster, s_rows, x.y, y.y, win_x, win_y, blocks);
      twolevel_add(cluster, s_rows, x.z, y.z, win_x, win_y, blocks);
      twolevel_add(cluster, s_rows, x.w, y.w, win_x, win_y, blocks);
    }
    scalar_from = begin + 4 * quads;
  }
  for (int64_t k = scalar_from + thread; k < end; k += stride) {
    twolevel_add(cluster, s_rows, lx[k], ly[k], win_x, win_y, blocks);
  }
  cluster.sync();  // every pair of the cluster is in; no remote write is left

  if (!merge && win_y % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int quads = win_y / 4;
    for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
      const int row = i / quads, q = i - row * quads;
      reinterpret_cast<int4*>(out + static_cast<int64_t>(rank + row * blocks) * win_y)[q] =
          reinterpret_cast<const int4*>(s_rows + row * win_y)[q];
    }
  } else {
    for (int i = threadIdx.x; i < rows * win_y; i += blockDim.x) {
      const int row = i / win_y, column = i - row * win_y;
      int32_t* dst = out + static_cast<int64_t>(rank + row * blocks) * win_y + column;
      if (!merge) {
        *dst = s_rows[i];
      } else if (s_rows[i] != 0) {
        atomicAdd(dst, s_rows[i]);
      }
    }
  }
}

// A twolevel launch's configuration: `splits` clusters of `cluster` blocks,
// a block's window rows in dynamic shared memory; sets the kernel's
// attributes the launch needs.  Returns 0, or cudaErrorInvalidValue for a
// cluster outside 1..16, splits < 1 or rows past a block's shared memory.
int twolevel_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attribute, int win_x,
                    int win_y, int cluster, int splits, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || splits < 1 || win_x < 1 || win_y < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int64_t bytes = static_cast<int64_t>(twolevel_rows(win_x, 0, cluster)) * win_y * 4;
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t code = cudaFuncSetAttribute(
      twolevel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (code == cudaSuccess && cluster > 8) {
    code = cudaFuncSetAttribute(twolevel_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (code != cudaSuccess) return static_cast<int>(code);
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = static_cast<unsigned>(cluster);
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.gridDim = dim3(static_cast<unsigned>(cluster * splits));
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = static_cast<size_t>(bytes);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attribute;
  config.numAttrs = 1;
  return 0;
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

// Clusters of `cluster` blocks (1-16) that the card can hold at once for
// this window (cudaOccupancyMaxActiveClusters), or minus an error code.
int lynx_hist_twolevel_max_clusters(int win_x, int win_y, int cluster) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute = {};
  int code = twolevel_config(config, attribute, win_x, win_y, cluster, 1, nullptr);
  if (code != 0) return -code;
  int clusters = 0;
  code = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, twolevel_kernel, &config));
  return code != 0 ? -code : clusters;
}

// As lynx_hist_onehot, with the window in the distributed shared memory of
// `splits` clusters of `cluster` blocks (cluster 1-16, splits >= 1); the
// output is written whole, zeroed first where splits > 1.  Returns
// cudaErrorInvalidValue for a window whose rows pass a block's shared
// memory, cudaErrorInvalidConfiguration where the card can hold no such
// cluster, else cudaGetLastError() after the launch.
int lynx_hist_twolevel(const void* lx, const void* ly, void* out, long long n, int win_x,
                       int win_y, int cluster, int splits, void* stream) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute = {};
  int code = twolevel_config(config, attribute, win_x, win_y, cluster, splits, stream);
  if (code != 0) return code;
  int clusters = 0;
  code = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, twolevel_kernel, &config));
  if (code != 0) return code;
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (splits > 1) {
    code = static_cast<int>(cudaMemsetAsync(out, 0, static_cast<size_t>(win_x) * win_y * 4,
                                            config.stream));
    if (code != 0) return code;
  }
  const auto aligned = [](const void* pointer) {
    return reinterpret_cast<uintptr_t>(pointer) % 16 == 0;
  };
  const int64_t per_split = ((n + splits - 1) / splits + 3) / 4 * 4;
  code = static_cast<int>(cudaLaunchKernelEx(
      &config, twolevel_kernel, static_cast<const int32_t*>(lx), static_cast<const int32_t*>(ly),
      static_cast<int32_t*>(out), static_cast<int64_t>(n), win_x, win_y, per_split,
      static_cast<int>(aligned(lx) && aligned(ly)), static_cast<int>(splits > 1)));
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

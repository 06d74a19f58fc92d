// Particle moment sweep, the packed-Gram route (kernel B6), for Hopper,
// sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_packed_gram_kernel
// (launched by _moment_sweep_packed_impl).  The final coordinates of a
// particle are an affine image T x of its incoming ones, so the moments after
// the plan are T (sum_n W_n x x^T) T^T: only the survival weights W depend
// on the setting through the apertures.  For each setting b and particle n
// the kernel forms each aperture's plane position as the sparse dot of the
// setting's prefix-map row with the augmented particle aug = [x_0..x_6,
// valid] (the plane centre rides on valid), and the survival mask m_bn, the
// product of the apertures' 0/1 masks.  The 36 sums G_b,jk = sum_n m_bn q_njk
// with q_njk = w0_n (aug_j aug_k), j <= k < 8, are the joint Gram.  The 7x7
// sandwich with T runs in PyTorch afterwards, as the JAX package runs it
// outside its kernel.
//
// What bounds it on an H100: arithmetic.  The Gram is a (B x N) by (N x 36)
// product whose left operand is exactly 0 or 1; the planes add an FMA per
// plane row and (setting, particle), and the masks a few compares.  At path
// A's B = 256, N = 100,000 and 14 plane rows the planes are 7e8 flops, 11 us
// at 67 TFLOP/s outside the tensor cores, and the Gram in float 3 x 72 flops
// a pair on the tensor cores, 6 us at 989 TFLOP/s (chip_smoke.py's
// gram_bound); the cloud is 3.6 MB.  A thread that sums the 36 products of
// its setting with FMAs reads all 36 of every particle from shared memory,
// a wavefront per value and warp: the shared-memory pipe, not the FMAs,
// then sets its time.
//
// Design: a block owns a tile of settings and one split of the particles,
// walked in chunks of 128.  Per chunk the block stages the chunk's 8 aug
// rows and w0 in shared memory with cp.async, two buffers deep, so that the
// next chunk loads while this one is summed, and forms the products q once
// for the block's settings.  The planes are staged once per block in dense
// form, a coefficient per aug row and plane with a mask of the rows each
// plane uses, so that the x and y planes of an aperture share each aug load
// and the sums keep the plain version's row order.
//   float: the Gram runs on the tensor cores, mma.sync m16n8k16 in bf16
//   with an FP32 accumulator.  The mask is exactly 0 or 1, so it is exact in
//   bf16; q is split into three bf16 parts, q = q0 + q1 + q2 with q1 and q2
//   the rounded remainders, which carry its 24 bits.  A warp owns 16
//   settings; each lane forms the masks of its fragment's 2 settings x 4
//   particles per step of 16 particles and packs them as bf16, and the warp
//   multiplies them into 15 column tiles of 8: 5 groups of 8 sums (36
//   padded to 40), each in its 3 parts, so that a lane holds the 3 parts of
//   its sums and adds them in a fixed order at the end.
//   double: one thread per setting and FP64 FMAs of the 0/1 mask with q,
//   over the same staging, four particles at a time.
// Each (setting, split) writes its 36 sums to a (B, splits, 36) buffer, and
// moment_sums.cuh's reduce_partials adds the splits in a fixed order: the
// result does not change from run to run.  lynx_packed_gram_splits sizes the
// splits to fill the card.  A ragged B computes on the last setting and
// stores nothing; a ragged chunk is padded with zero particles (q = 0 adds
// an exact 0).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "moment_sums.cuh"

namespace {

// Aperture records; lynx_tpu_torch/ops/fused_track.py has the same layout:
// shape (0 rectangular), first x plane row, x row count, first y plane row,
// y row count, 3 unused.  A plane's rows name distinct aug rows in
// ascending order.
constexpr int kRecord = 8;
constexpr int kChunk = 128;     // particles per stage
constexpr int kMaxTile = 128;   // settings per block at most
constexpr int kStageRows = 9;   // the 8 aug rows and w0
constexpr int kPlaneRows = 16;  // dense coefficients of an aperture: 8 aug rows x 2 planes
constexpr int kDefaultShared = 48 * 1024;
constexpr int kDoesNotFit = -1;  // launch(): the block's operands exceed the shared memory
constexpr int kDevices = 64;     // devices whose shared-memory limits are cached
constexpr int64_t kTargetWarps = 132 * 16;  // 16 warps on each of an H100's SMs
// The tensor-core Gram (float).
constexpr int kWarpSettings = 16;  // the mma's rows
constexpr int kStep = 16;          // particles per mma (its depth)
constexpr int kGroups = 5;         // groups of 8 sums: 36 padded to 40
constexpr int kParts = 3;          // bf16 parts of q
constexpr int kTiles = kGroups * kParts;  // column tiles of 8: part p of group g is tile 3 g + p
constexpr int kQRow = kChunk + 16;  // a column of the q parts, padded so that a half-warp's
                                    // 8-byte fragment loads fall in 32 banks

#ifndef LYNX_HOST_STAND_IN
// Device intrinsics, each behind a helper with a host stand-in in the tests.
// cp.async (sm_80 and later): one value from device to shared memory, its
// commit, and waits that leave the newest group in flight (prior) or none.
template <typename T>
__device__ __forceinline__ void lynx_cp_async(T* shared_dst, const T* src) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared_dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(address), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void lynx_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void lynx_cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void lynx_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// lo and hi rounded to bf16 (to nearest, even) and packed: lo in the low
// half; and the float of 32 bits.
__device__ __forceinline__ unsigned lynx_bf16x2(float lo, float hi) {
  unsigned packed;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(packed) : "f"(hi), "f"(lo));
  return packed;
}
__device__ __forceinline__ float lynx_float_of(unsigned bits) { return __uint_as_float(bits); }
// d += a b for the warp's fragments: A 16 x 16 bf16 (row), B 16 x 8 bf16
// (col), D 16 x 8 float, in the PTX ISA's m16n8k16 layouts.
__device__ __forceinline__ void lynx_mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

template <typename T>
constexpr bool kTensorCores = std::is_same<T, float>::value;

// Settings per block: float, the batch in whole warps of 16 settings;
// double, in whole warps of 32; at most kMaxTile.
template <typename T>
__host__ __device__ inline int tile_of(int64_t batch) {
  const int64_t unit = kTensorCores<T> ? kWarpSettings : 32;
  const int64_t tile = (batch + unit - 1) / unit * unit;
  return tile < kMaxTile ? static_cast<int>(tile) : kMaxTile;
}

// Threads per block: a warp per 16 settings (float), a thread per setting
// (double).
template <typename T>
__host__ __device__ inline int threads_of(int tile) {
  return kTensorCores<T> ? tile / kWarpSettings * 32 : tile;
}

// Where setting s of a tile sits in the staged coefficients and bounds:
// float keeps the two settings of a fragment's lane, s and s + 8 of its
// warp's 16, side by side; double, in order.
template <typename T>
__host__ __device__ inline int slot_of(int s) {
  return kTensorCores<T> ? (s & ~15) + 2 * (s & 7) + ((s >> 3) & 1) : s;
}

// Bytes of the products q of a chunk: float, its bf16 parts, column-major
// (kTiles x 8 columns of kQRow); double, [kChunk][36].
template <typename T>
__host__ __device__ constexpr int64_t q_bytes() {
  return kTensorCores<T> ? int64_t{kTiles} * 8 * kQRow * 2
                         : int64_t{kChunk} * lynx::kSums * static_cast<int64_t>(sizeof(T));
}

// Dynamic shared memory of a block: the two stage buffers, q, the tile's
// dense coefficients and bounds, then each aperture's rows and shape and
// each plane row's place among the coefficients.
template <typename T>
int64_t shared_bytes(int n_apertures, int n_rows, int tile) {
  const int64_t values = 2 * kStageRows * kChunk +
                         static_cast<int64_t>((kPlaneRows + 4) * n_apertures) * tile;
  return values * static_cast<int64_t>(sizeof(T)) + q_bytes<T>() +
         static_cast<int64_t>(n_apertures + n_rows) * 4;
}

// Particle splits of a launch: enough blocks for kTargetWarps, each split a
// whole number of chunks and none empty.
template <typename T>
int64_t splits_of(int64_t batch, int64_t n) {
  const int tile = tile_of<T>(batch);
  const int64_t tiles = (batch + tile - 1) / tile;
  const int64_t warps = tiles * (threads_of<T>(tile) / 32);
  const int64_t chunks = n > 0 ? (n + kChunk - 1) / kChunk : 1;
  int64_t wanted = (kTargetWarps + warps - 1) / warps;
  if (wanted > chunks) wanted = chunks;
  const int64_t per_split = (chunks + wanted - 1) / wanted;
  return (chunks + per_split - 1) / per_split;
}

// Four neighbouring values from 16-byte aligned shared memory, and two
// from 8-byte aligned.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load2(const float* p, float& x0, float& x1) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  x0 = a.x; x1 = a.y;
}
__device__ __forceinline__ void store4(float* p, float x0, float x1, float x2, float x3) {
  *reinterpret_cast<float4*>(p) = make_float4(x0, x1, x2, x3);
}
__device__ __forceinline__ void store4(double* p, double x0, double x1, double x2, double x3) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x0, x1);
  reinterpret_cast<double2*>(p)[1] = make_double2(x2, x3);
}

// The survival test of one aperture at plane positions (px, py) with its
// bounds [x_max, y_max, 1/x_max^2, 1/y_max^2] at stride `stride`: the TPU
// kernel's formulas, rectangular strict, elliptical inclusive in the
// reciprocal form px^2 * (1 / x_max^2).
template <typename T>
__device__ __forceinline__ bool inside(bool rectangular, T px, T py, const T* bound, int stride) {
  if (rectangular) {
    const T x_max = bound[0];
    const T y_max = bound[stride];
    return px > -x_max && px < x_max && py > -y_max && py < y_max;
  }
  const T t = px * px * bound[2 * stride];
  return t + py * py * bound[3 * stride] <= T(1);
}

// An aperture's info word: bits 0-7 the aug rows of its x plane, 8-15 of
// its y plane, bit 16 set for a rectangle.
constexpr unsigned kRectangular = 1u << 16;

// Plane positions of `Width` settings x 4 particles (aug values at
// `column` of the stage): for each plane the sum over its rows j, in
// ascending order from an exact 0 (0 + x is x), of coef[j] * aug[j].  The
// coefficients of setting i sit at coef[(plane * 8 + j) * tile + i].
template <int Width, typename T>
__device__ __forceinline__ void aperture_planes(const T* stage, int column, const T* coef,
                                                unsigned info, int tile, T (&px)[Width][4],
                                                T (&py)[Width][4]) {
#pragma unroll
  for (int i = 0; i < Width; ++i) {
#pragma unroll
    for (int l = 0; l < 4; ++l) px[i][l] = py[i][l] = T(0);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in_x = (info >> j) & 1u;
    const bool in_y = (info >> (8 + j)) & 1u;
    if (!in_x && !in_y) continue;
    T x[4];
    load4(stage + j * kChunk + column, x);
#pragma unroll
    for (int i = 0; i < Width; ++i) {
      const T cx = coef[j * tile + i];
      const T cy = coef[(8 + j) * tile + i];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (in_x) px[i][l] = px[i][l] + cx * x[l];
        if (in_y) py[i][l] = py[i][l] + cy * x[l];
      }
    }
  }
}

// in[i][l] &= survival of settings i at the 4 particles at `column`,
// through every aperture.
template <int Width, typename T>
__device__ __forceinline__ void survive(const T* stage, int column, const T* s_coef,
                                        const T* s_bounds, const unsigned* s_info,
                                        int n_apertures, int tile, int slot,
                                        bool (&in)[Width][4]) {
  for (int ap = 0; ap < n_apertures; ++ap) {
    const unsigned info = s_info[ap];
    T px[Width][4], py[Width][4];
    aperture_planes<Width>(stage, column, s_coef + ap * kPlaneRows * tile + slot, info, tile, px,
                           py);
    const T* bound = s_bounds + ap * 4 * tile + slot;
#pragma unroll
    for (int i = 0; i < Width; ++i) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        in[i][l] = in[i][l] && inside((info & kRectangular) != 0, px[i][l], py[i][l], bound + i,
                                      tile);
      }
    }
  }
}

// -- float: the Gram on the tensor cores ------------------------------------
//
// Particle order within a step of 16: the lane with t = lane % 4 takes
// particles 4t .. 4t + 3 as the mma's k = 2t, 2t + 1, 2t + 8, 2t + 9, so
// that its aug values and its B fragments are one 16-byte and one 8-byte
// load (any order of k is the same product, as long as A and B agree).

// The column of qT (as 32-bit pairs of particles) that holds part `part`
// of sum k: column 8 (3 g + part) + i for k = 8 g + i.
__device__ __forceinline__ int q_column(int k, int part) {
  return 8 * (kParts * (k / 8) + part) + k % 8;
}

// q's bf16 parts for the chunk's particles.  A task is a pair of particles
// and a quarter of the 36 sums; a warp's tasks take one quarter.
__device__ __forceinline__ void form_q_parts(const float* stage, unsigned* qT) {
  constexpr int kPairs = kChunk / 2;
  constexpr int kQuarter = lynx::kSums / 4;
  for (int task = threadIdx.x; task < kPairs * 4; task += blockDim.x) {
    const int pair = task % kPairs;
    const int quarter = task / kPairs;
    float a[8], b[8], wa, wb;
#pragma unroll
    for (int j = 0; j < 8; ++j) load2(stage + j * kChunk + 2 * pair, a[j], b[j]);
    load2(stage + 8 * kChunk + 2 * pair, wa, wb);
    int k = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int m = j; m < 8; ++m, ++k) {
        if (k / kQuarter != quarter) continue;
        float lo = wa * (a[j] * a[m]);
        float hi = wb * (b[j] * b[m]);
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          const unsigned bits = lynx_bf16x2(lo, hi);
          qT[q_column(k, part) * (kQRow / 2) + pair] = bits;
          lo = lo - lynx_float_of(bits << 16);
          hi = hi - lynx_float_of(bits & 0xffff0000u);
        }
      }
    }
  }
}

// The bf16 pair (lo, hi) of two 0/1 masks.
__device__ __forceinline__ unsigned mask_pair(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

// The warp's 16 settings over `count` staged particles: acc[tile][4] += the
// masks' product with q's parts.
__device__ __forceinline__ void gram_mma(const float* stage, const unsigned* qT,
                                         const float* s_coef, const float* s_bounds,
                                         const unsigned* s_info, int n_apertures, int tile,
                                         int count, float (&acc)[kTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int slot = threadIdx.x / 32 * kWarpSettings + 2 * g;  // settings g and g + 8
  const int steps = (count + kStep - 1) / kStep;
  for (int step = 0; step < steps; ++step) {
    const int column = step * kStep + 4 * t;
    bool in[2][4] = {{true, true, true, true}, {true, true, true, true}};
    survive<2>(stage, column, s_coef, s_bounds, s_info, n_apertures, tile, slot, in);
    const unsigned a[4] = {mask_pair(in[0][0], in[0][1]), mask_pair(in[1][0], in[1][1]),
                           mask_pair(in[0][2], in[0][3]), mask_pair(in[1][2], in[1][3])};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const uint2 col = *reinterpret_cast<const uint2*>(qT + (8 * j + g) * (kQRow / 2) + column / 2);
      const unsigned b[2] = {col.x, col.y};
      lynx_mma_bf16(acc[j], a, b);
    }
  }
}

// -- double: FP64 FMAs, one thread per setting ------------------------------
//
// (Templated on the value type; only double takes this path.)

template <typename T>
__device__ __forceinline__ void form_q(const T* stage, T* q) {
  for (int p = threadIdx.x; p < kChunk; p += blockDim.x) {
    T a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = stage[j * kChunk + p];
    const T w = stage[8 * kChunk + p];
    T prod[lynx::kSums];
    int k = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int m = j; m < 8; ++m) prod[k++] = w * (a[j] * a[m]);
    }
#pragma unroll
    for (int v = 0; v < lynx::kSums; v += 4) {
      store4(q + p * lynx::kSums + v, prod[v], prod[v + 1], prod[v + 2], prod[v + 3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void gram_fma(const T* stage, const T* q, const T* s_coef,
                                         const T* s_bounds, const unsigned* s_info,
                                         int n_apertures, int tile, int count,
                                         T (&acc)[lynx::kSums]) {
  const int groups = (count + 3) / 4;
  for (int group = 0; group < groups; ++group) {
    const int p = 4 * group;
    bool in[1][4] = {{true, true, true, true}};
    survive<1>(stage, p, s_coef, s_bounds, s_info, n_apertures, tile, threadIdx.x, in);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T m = in[0][i] ? T(1) : T(0);
      const T* qp = q + (p + i) * lynx::kSums;
#pragma unroll
      for (int v = 0; v < lynx::kSums; v += 4) {
        T x[4];
        load4(qp + v, x);
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[v + l] = acc[v + l] + m * x[l];
      }
    }
  }
}

// -- the kernel -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(2 * kMaxTile) packed_gram_kernel(
    const int* __restrict__ apertures, int n_apertures, const int* __restrict__ row_index,
    int n_rows, const T* __restrict__ planes, const T* __restrict__ bounds,
    const T* __restrict__ aug, const T* __restrict__ w0, T* __restrict__ partials, int64_t batch,
    int64_t n, int64_t tiles, int64_t splits) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int tile = tile_of<T>(batch);
  T* const stage = reinterpret_cast<T*>(shared_raw);  // [2][kStageRows][kChunk]
  unsigned char* const q_raw = shared_raw + 2 * kStageRows * kChunk * sizeof(T);
  T* const s_coef = reinterpret_cast<T*>(q_raw + q_bytes<T>());  // [A][2][8][tile]
  T* const s_bounds = s_coef + n_apertures * kPlaneRows * tile;   // [A][4][tile]
  unsigned* const s_info = reinterpret_cast<unsigned*>(s_bounds + n_apertures * 4 * tile);
  int* const s_place = reinterpret_cast<int*>(s_info + n_apertures);  // of each plane row

  const int64_t split = blockIdx.x / tiles;
  const int64_t first_setting = (blockIdx.x % tiles) * tile;

  // The apertures' rows and shapes, and where each plane row's coefficient
  // goes; then the tile's coefficients and bounds (a setting past the batch
  // takes the last one's), once per block.
  for (int ap = threadIdx.x; ap < n_apertures; ap += blockDim.x) {
    const int* rec = apertures + ap * kRecord;
    unsigned info = rec[0] == 0 ? kRectangular : 0u;
    for (int plane = 0; plane < 2; ++plane) {
      for (int r = rec[1 + 2 * plane]; r < rec[1 + 2 * plane] + rec[2 + 2 * plane]; ++r) {
        info |= 1u << (8 * plane + row_index[r]);
        s_place[r] = ap * kPlaneRows + 8 * plane + row_index[r];
      }
    }
    s_info[ap] = info;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < (n_rows + 4 * n_apertures) * tile; k += blockDim.x) {
    const int row = k / tile;
    const int s = k - row * tile;
    const int64_t b = first_setting + s < batch ? first_setting + s : batch - 1;
    if (row < n_rows) {
      s_coef[s_place[row] * tile + slot_of<T>(s)] = planes[row * batch + b];
    } else {
      s_bounds[(row - n_rows) * tile + slot_of<T>(s)] = bounds[(row - n_rows) * batch + b];
    }
  }
  if constexpr (kTensorCores<T>) {  // the padding sums 36 .. 39, never written again
    auto* qT = reinterpret_cast<unsigned*>(q_raw);
    for (int k = threadIdx.x; k < (kGroups * 8 - lynx::kSums) * kParts * (kChunk / 2);
         k += blockDim.x) {
      const int pair = k % (kChunk / 2);
      const int column = k / (kChunk / 2);
      qT[q_column(lynx::kSums + column / kParts, column % kParts) * (kQRow / 2) + pair] = 0u;
    }
  }

  // This split's particles: whole chunks, the last one ragged.
  const int64_t all_chunks = (n + kChunk - 1) / kChunk;
  const int64_t per_split = (all_chunks + splits - 1) / splits;
  const int64_t first = split * per_split * kChunk;
  const int64_t last = first + per_split * kChunk < n ? first + per_split * kChunk : n;
  const int chunks = first < last ? static_cast<int>((last - first + kChunk - 1) / kChunk) : 0;

  // Chunk c into stage buffer c % 2; particles past the end are zeros.
  auto load = [&](int c) {
    T* buffer = stage + (c & 1) * kStageRows * kChunk;
    const int64_t base = first + static_cast<int64_t>(c) * kChunk;
    const int64_t count = last - base;
    for (int k = threadIdx.x; k < kStageRows * kChunk; k += blockDim.x) {
      const int row = k / kChunk;
      const int p = k - row * kChunk;
      if (p < count) {
        lynx_cp_async(buffer + k, (row < 8 ? aug + row * n : w0) + base + p);
      } else {
        buffer[k] = T(0);
      }
    }
    lynx_cp_async_commit();
  };

  // float: acc[3 g + part][c] of the mma's fragment; double: the 36 sums.
  typename std::conditional<kTensorCores<T>, float[kTiles][4], T[lynx::kSums]>::type acc;
  if constexpr (kTensorCores<T>) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < lynx::kSums; ++k) acc[k] = T(0);
  }

  if (chunks > 0) load(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load(c + 1);  // into the buffer that chunk c - 1 used
      lynx_cp_async_wait_prior();
    } else {
      lynx_cp_async_wait_all();
    }
    __syncthreads();  // chunk c is staged (on c = 0: the coefficients too)
    const T* buffer = stage + (c & 1) * kStageRows * kChunk;
    const int64_t left = last - (first + static_cast<int64_t>(c) * kChunk);
    const int count = left < kChunk ? static_cast<int>(left) : kChunk;
    if constexpr (kTensorCores<T>) {
      auto* qT = reinterpret_cast<unsigned*>(q_raw);
      form_q_parts(buffer, qT);
      __syncthreads();
      gram_mma(buffer, qT, s_coef, s_bounds, s_info, n_apertures, tile, count, acc);
    } else {
      auto* q = reinterpret_cast<T*>(q_raw);
      form_q(buffer, q);
      __syncthreads();
      gram_fma(buffer, q, s_coef, s_bounds, s_info, n_apertures, tile, count, acc);
    }
    __syncthreads();  // the next load reuses this chunk's buffer, and q
  }

  if constexpr (kTensorCores<T>) {
    // Lane (g, t) holds sums 8 grp + 2 t + e of settings g (c = e) and
    // g + 8 (c = 2 + e): their three parts add in order.
    const int lane = threadIdx.x % 32;
    const int warp_first = threadIdx.x / 32 * kWarpSettings;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t b = first_setting + warp_first + lane / 4 + 8 * half;
      if (b >= batch) continue;
      T* out = partials + (b * splits + split) * lynx::kSums;
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * grp + 2 * (lane % 4) + e;
          const int c = 2 * half + e;
          if (k < lynx::kSums) out[k] = (acc[3 * grp][c] + acc[3 * grp + 1][c]) + acc[3 * grp + 2][c];
        }
      }
    }
  } else {
    const int64_t b = first_setting + threadIdx.x;
    if (b < batch) {
      T* out = partials + (b * splits + split) * lynx::kSums;
#pragma unroll
      for (int k = 0; k < lynx::kSums; ++k) out[k] = acc[k];
    }
  }
}

// Lets packed_gram_kernel<T> take `bytes` of dynamic shared memory on the
// current device: raises its limit past the default where no launch before
// needed as much; false if the device's opt-in limit is smaller.
template <typename T>
bool allow_shared(int64_t bytes) {
  static std::atomic<int> allowed[kDevices];  // per device: the kernel's limit so far
  if (bytes <= kDefaultShared) return true;
  int device = 0;
  cudaGetDevice(&device);
  if (device < kDevices && bytes <= allowed[device].load(std::memory_order_relaxed)) return true;
  int limit = 0;
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (bytes > limit) return false;
  cudaFuncSetAttribute(packed_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  if (device < kDevices) allowed[device].store(static_cast<int>(bytes), std::memory_order_relaxed);
  return true;
}

template <typename T>
int launch(const void* apertures, int n_apertures, const void* row_index, int n_rows,
           const void* planes, const void* bounds, const void* aug, const void* w0,
           void* partials, void* scratch, void* out, long long batch, long long n,
           long long splits, cudaStream_t stream) {
  const int tile = tile_of<T>(batch);
  const int64_t bytes = shared_bytes<T>(n_apertures, n_rows, tile);
  if (!allow_shared<T>(bytes)) return kDoesNotFit;
  const int64_t tiles = (batch + tile - 1) / tile;
  packed_gram_kernel<T><<<static_cast<unsigned>(tiles * splits), threads_of<T>(tile), bytes,
                          stream>>>(
      static_cast<const int*>(apertures), n_apertures, static_cast<const int*>(row_index), n_rows,
      static_cast<const T*>(planes), static_cast<const T*>(bounds), static_cast<const T*>(aug),
      static_cast<const T*>(w0), static_cast<T*>(partials), batch, n, tiles, splits);
  lynx::reduce_partials<T>(static_cast<T*>(partials), static_cast<T*>(scratch),
                           static_cast<T*>(out), batch, splits, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// apertures: (n_apertures, 8) int32 records; row_index: (n_rows,) int32, the
// aug row of each plane row; planes: (n_rows, batch); bounds: (n_apertures,
// 4, batch); aug: (8, n); w0: (n,); partials: (batch, splits, 36) and
// scratch: (batch, ceil(splits / 64), 36) workspace, splits from
// lynx_packed_gram_splits; out: (batch, 36), the Gram's upper triangle (j <=
// k, row-major).  All float (is_double = 0) or double (is_double = 1),
// contiguous.  Returns -1 if a block's operands do not fit in the device's
// shared memory per block, else cudaGetLastError().
int lynx_packed_gram(int is_double, const void* apertures, int n_apertures, const void* row_index,
                     int n_rows, const void* planes, const void* bounds, const void* aug,
                     const void* w0, void* partials, void* scratch, void* out, long long batch,
                     long long n, long long splits, void* stream) {
  if (batch <= 0 || splits <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(apertures, n_apertures, row_index, n_rows, planes, bounds, aug, w0,
                          partials, scratch, out, batch, n, splits, s);
  }
  return launch<float>(apertures, n_apertures, row_index, n_rows, planes, bounds, aug, w0,
                       partials, scratch, out, batch, n, splits, s);
}

// Particle splits of a launch over batch settings and n particles.
long long lynx_packed_gram_splits(int is_double, long long batch, long long n) {
  return is_double ? splits_of<double>(batch, n) : splits_of<float>(batch, n);
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

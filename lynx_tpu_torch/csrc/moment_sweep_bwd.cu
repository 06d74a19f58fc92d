// Backward of the fused moment sweep (kernel B4) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_bwd_kernel
// (launched by _fused_moment_sweep_bwd_impl): the vector-Jacobian product
// of kernel B3.  With T = R_{E-1} ... R_0, out_mu = T mu, out_cov = T C T^T:
//
//   d_mu  = T^T dmu,   d_cov = T^T dcov T
//   dT    = dmu mu^T + dcov T C^T + dcov^T T C
//   dR_i  = L_i^T dT M_i^T,  L_i = R_{E-1} .. R_{i+1},  M_i = R_{i-1} .. R_0
//
// A dynamic entry's parameter and energy cotangents contract dR_i with
// dR_i/dp, which the kernel gets by evaluating the entry's builder in
// forward-mode dual numbers, once per input (fused_builders.cuh).  A const
// entry's cotangents are dR_i at its non-literal cells, written per setting
// as (cells, B) rows; the caller sums them over the batch, as the JAX
// package sums them outside its kernel.
//
// What bounds it on an H100: memory.  Its own input and output is ~720
// bytes a setting in f32; per setting it does a forward pass of one 7x7
// product per entry, a reverse pass of two, and one dual-number builder
// evaluation per input of each dynamic entry.  Counted on the maps'
// structural supports, the products are ~7e3 flops a setting on the path-T
// plan of 11 entries (chip_smoke.py's sweep_flops; the builders' own
// arithmetic uncounted), half the memory term at 3.35 TB/s and 67 TFLOP/s.
// One thread per setting would keep ~10 49-cell arrays live, past the
// 255-register limit, and its prefix products M_i would need an (E, 49, B)
// device workspace: 215 MB each way at B = 100,000.
//
// Design: a team of kLanes = 8 lanes per setting, four settings per warp.
// Lane r < 7 owns row r of every 7x7 matrix and keeps it in 7 registers; it
// reads the other operand's rows from shared memory, where each setting
// keeps its prefix products and three scratch matrices (no device
// workspace), rows padded to 8 cells so that a row moves in 16-byte loads.
// The number of settings per block is sized at launch from the tape length
// and the dtype to fit the device's shared memory; a ragged last block
// computes on the last setting and stores nothing.  In the reverse pass
// every lane evaluates the entry's builder in dual numbers, lane q seeded on
// input q (parameters, then the energy), so one warp-wide pass gives up to 8
// derivatives (a dipole's 9 take two passes); the value part of the same
// pass is R_i.  A custom map's cells are its parameters: their cotangents
// are dR_i's cells, as a const entry's.  The builders are
// fused_builders.cuh's, inlined so that their maps stay in registers;
// instantiated with the full lattice's kinds (kFull) only for a tape that
// holds one.  Sums run in the same order as the one-thread-per-setting
// kernel they replace, so the numbers differ from it only by FMA
// contraction.  A team synchronises with __syncwarp: its lanes share one
// warp.
//
// A tape whose prefix products M_0 .. M_{E-1} would leave fewer than 32
// settings a block (past 28 entries in float, 12 in double; past about 514
// and 1,033 one setting would not fit at all) is cut into segments of K
// entries: the forward pass keeps only each segment's first prefix product
// (a checkpoint, in a device scratch buffer of (B, checkpoints, 56) values),
// and the reverse pass recomputes a segment's prefix products from its
// checkpoint into shared memory before it walks the segment backwards: one
// more forward pass in all.  K is the longest segment that keeps 32 settings
// (eight warps) a block, 28 entries in float and 12 in double.  Kept whole,
// a 68-entry tape in float held 12 settings a block, three warps an SM.
// Path T's tape of 11 entries stays whole: its forward pass stores every
// prefix product and nothing is recomputed, in an instantiation without the
// segments' bookkeeping (kSegmented false), which cost it 4% on the card.

#include <atomic>

#include "fused_builders.cuh"

namespace {

constexpr int kLanes = 8;       // lanes per setting; lane r < 7 owns row r
constexpr int kMaxTeams = 32;   // settings per block at most (256 threads)
constexpr int kRow = 8;         // a row in shared memory: 7 cells and padding
constexpr int kMatrix = 7 * kRow;
constexpr int kScratch = 3;     // scratch matrices per setting
constexpr int kDevices = 64;    // devices whose launch settings are cached

// Shared-memory elements per setting: a segment of prefix products, T, the
// scratch matrices and one slot, rounded so that a setting starts on 16
// bytes and the four settings of a warp start in four other banks (a stride
// of 4 mod 8).
__host__ __device__ inline int setting_stride(int segment) {
  return ((segment + 1 + kScratch) * kMatrix + 1 + 7) / 8 * 8 + 4;
}

// Cell c of a 7x7 map in its padded place.
__device__ __forceinline__ int padded(int c) { return c / 7 * kRow + c % 7; }

// The lanes of this thread's warp that exist (a block need not fill its
// last warp).
__device__ __forceinline__ unsigned warp_mask() {
  const unsigned first = threadIdx.x & ~31u;
  const unsigned n = blockDim.x - first;
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// A padded row in 16-byte loads and stores (the padding is written 0).
__device__ __forceinline__ void load_row(const float* p, float (&x)[7]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z;
}
__device__ __forceinline__ void load_row(const double* p, double (&x)[7]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  const double2 c = reinterpret_cast<const double2*>(p)[2];
  const double2 d = reinterpret_cast<const double2*>(p)[3];
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y; x[4] = c.x; x[5] = c.y; x[6] = d.x;
}
__device__ __forceinline__ void store_row(float* p, const float (&x)[7]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], 0.0f);
}
__device__ __forceinline__ void store_row(double* p, const double (&x)[7]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
  reinterpret_cast<double2*>(p)[2] = make_double2(x[4], x[5]);
  reinterpret_cast<double2*>(p)[3] = make_double2(x[6], 0.0);
}

// out = l @ R for a row l and a padded 7x7 R, in the order of a dense
// product (j ascending).
template <typename T>
__device__ __forceinline__ void row_times(const T (&l)[7], const T* R, T (&out)[7]) {
  T rows[7][7];
#pragma unroll
  for (int j = 0; j < 7; ++j) load_row(R + j * kRow, rows[j]);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    T acc = l[0] * rows[0][k];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + l[j] * rows[j][k];
    out[k] = acc;
  }
}

// Column r of a padded 7x7 matrix.
template <typename T>
__device__ __forceinline__ void load_column(const T* M, int r, T (&x)[7]) {
#pragma unroll
  for (int j = 0; j < 7; ++j) x[j] = M[j * kRow + r];
}

// Row i of the map R (values) goes to shared memory from lane i: the whole
// matrix from the team, without indexing registers at run time.
template <typename S, typename T>
__device__ __forceinline__ void scatter_rows(const S (&R)[49], T* out, int lane) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (i == lane) {
      T x[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) x[k] = lynx::value_of(R[i * 7 + k]);
      store_row(out + i * kRow, x);
    }
  }
}

// A dynamic entry's parameters for setting b (at most kP), loaded without a
// run-time index into the register array.
template <bool kFull, int kP, typename T>
__device__ __forceinline__ void entry_params(const lynx::TapeEntry& entry,
                                             const T* __restrict__ params, int64_t batch,
                                             int64_t b, T (&p)[kP]) {
  const int n = lynx::tape_params<kFull>(entry.kind);
#pragma unroll
  for (int k = 0; k < kP; ++k) p[k] = k < n ? params[(entry.offset + k) * batch + b] : T(0);
}

// One step of the forward pass: M (this entry's prefix product, in shared
// memory) <- row, then row <- row r of R_i M.  S1 is scratch for a dynamic
// entry's map; a const entry's and a custom map's rows are read directly.
// The entry comes by value, a copy in registers: a reference into the tape
// would be read again from device memory after each store.
template <bool kFull, typename T>
__device__ __forceinline__ void forward_step(const lynx::TapeEntry entry, T* M, T* checkpoint,
                                             T* S1, const T* __restrict__ params,
                                             const T* __restrict__ consts, int64_t batch,
                                             int64_t b, T e_b, T rest, T mass, int r, int lane,
                                             bool owner, unsigned mask, T (&row)[7]) {
  constexpr int kP = kFull ? lynx::kMaxParams : 5;
  if (owner) {
    store_row(M + r * kRow, row);
    if (checkpoint != nullptr) store_row(checkpoint + r * kRow, row);
  }
  T rrow[7];  // row r of R_i
  const bool custom = kFull && entry.kind == lynx::kCustom;
  if (entry.kind == lynx::kConst) {
    const T* cells = consts + static_cast<int64_t>(entry.offset) * 49 + r * 7;
#pragma unroll
    for (int k = 0; k < 7; ++k) rrow[k] = cells[k];
  } else if (custom) {
#pragma unroll
    for (int k = 0; k < 7; ++k) rrow[k] = params[(entry.offset + r * 7 + k) * batch + b];
  } else {
    T p[kP], R[49];
    entry_params<kFull>(entry, params, batch, b, p);
    lynx::build_dynamic<kFull, T, T>(entry.kind, p, e_b, rest, mass, R);
    scatter_rows(R, S1, lane);
  }
  __syncwarp(mask);
  if (entry.kind != lynx::kConst && !custom) load_row(S1 + r * kRow, rrow);
  row_times(rrow, M, row);
  __syncwarp(mask);
}

// One dual-number pass over a dynamic entry: lane q = base + lane is seeded
// on input q (parameters, then the energy), contracts dR_i (M, in shared
// memory) with dR_i/d(input q), and writes that input's cotangent (the
// energy's to the slot); the pass that seeds the last input also scatters
// R_i's rows to S1.
template <bool kFull, int kP, typename T>
__device__ __forceinline__ void dual_pass(const lynx::TapeEntry& entry, const T (&p)[kP], int base,
                                          int n, const T* M, T* S1, T* slot,
                                          T* __restrict__ d_params, int64_t batch, int64_t b,
                                          bool active, T e_b, T rest, T mass, int lane) {
  const int q = base + lane;  // the input this lane is seeded on
  lynx::Dual<T> pd[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) pd[k] = lynx::Dual<T>(p[k], k == q ? T(1) : T(0));
  const lynx::Dual<T> ed(e_b, q == n ? T(1) : T(0));
  lynx::Dual<T> Rd[49];
  lynx::build_dynamic<kFull, T, lynx::Dual<T>>(entry.kind, pd, ed, rest, mass, Rd);
  T g = T(0);
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    T dri[7];
    load_row(M + i * kRow, dri);
#pragma unroll
    for (int k = 0; k < 7; ++k) g = g + dri[k] * Rd[i * 7 + k].d;
  }
  if (q < n) {
    if (active) d_params[(entry.offset + q) * batch + b] = g;
  } else if (q == n) {
    *slot = g;
  }
  if (!kFull || base + kLanes > n) scatter_rows(Rd, S1, lane);  // the last pass
}

template <typename T, bool kFull, bool kSegmented>
__global__ void __launch_bounds__(kLanes * kMaxTeams) moment_sweep_bwd_kernel(
    const lynx::TapeEntry* __restrict__ tape, int n_entries, int checkpoints, int segment,
    T* __restrict__ saved_all, const int* __restrict__ cell_pos, const T* __restrict__ params,
    const T* __restrict__ consts, const T* __restrict__ energy, const T* __restrict__ mu,
    const T* __restrict__ cov, const T* __restrict__ dmu, const T* __restrict__ dcov,
    T* __restrict__ d_params, T* __restrict__ d_consts, T* __restrict__ d_energy,
    T* __restrict__ d_mu, T* __restrict__ d_cov, int64_t batch, T rest, T mass) {
  constexpr int kP = kFull ? lynx::kMaxParams : 5;
  constexpr int kPasses = kFull ? 2 : 1;  // dual passes: up to kLanes inputs each
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int teams = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int r = lane < 7 ? lane : 6;  // lane 7 repeats row 6 and stores nothing
  const bool owner = lane < 7;
  const int64_t setting = static_cast<int64_t>(blockIdx.x) * teams + threadIdx.x / kLanes;
  const bool active = setting < batch;
  const int64_t b = active ? setting : batch - 1;
  const unsigned mask = warp_mask();

  T* const saved = saved_all + b * checkpoints * kMatrix;  // this setting's checkpoints
  T* const prefix = reinterpret_cast<T*>(shared_raw) +
                    static_cast<int64_t>(threadIdx.x / kLanes) *
                        setting_stride(segment);  // one segment's M_i
  T* const Tm = prefix + segment * kMatrix;       // M_E = T
  T* const S0 = Tm + kMatrix;                       // dcov, then T C, then A
  T* const S1 = S0 + kMatrix;                       // cov, then dcov T, then R_i
  T* const S2 = S1 + kMatrix;                       // T C^T
  T* const slot = S2 + kMatrix;                     // an entry's energy cotangent
  const T e_b = energy[b];
  const int segments =
      !kSegmented ? (n_entries > 0) : n_entries == 0 ? 0 : (n_entries + segment - 1) / segment;

  // Forward pass: M_{i+1} = R_i M_i, each M_i to its place in the segment
  // buffer (the last segment's stay there), and with checkpoints each
  // segment's first.
  T row[7];  // row r of M_i
#pragma unroll
  for (int k = 0; k < 7; ++k) row[k] = T(k == r ? 1 : 0);
  for (int e = 0; e < n_entries; ++e) {
    const int place = kSegmented ? e % segment : e;
    // A ragged last block's repeated setting writes the same checkpoints.
    T* checkpoint = kSegmented && place == 0 ? saved + (e / segment) * kMatrix : nullptr;
    forward_step<kFull>(tape[e], prefix + place * kMatrix, checkpoint, S1, params, consts,
                        batch, b, e_b, rest, mass, r, lane, owner, mask, row);
  }
  if (owner) store_row(Tm + r * kRow, row);

  // d_mu = T^T dmu, d_cov = T^T (dcov T), dT = dmu mu^T + dcov (T C^T) +
  // dcov^T (T C).
  for (int c = lane; c < 49; c += kLanes) {
    S0[padded(c)] = dcov[b * 49 + c];
    S1[padded(c)] = cov[b * 49 + c];
  }
  __syncwarp(mask);
  const T* g_mu = dmu + b * 7;
  T grow[7], gcol[7], tcol[7], x[7], tct[7], tc[7];
  load_row(S0 + r * kRow, grow);  // row r of dcov
  load_column(S0, r, gcol);       // column r of dcov
  load_column(Tm, r, tcol);       // column r of T
  row_times(grow, Tm, x);         // row r of dcov T
  row_times(row, S1, tc);         // row r of T C
#pragma unroll
  for (int k = 0; k < 7; ++k) {   // row r of T C^T
    T c[7];
    load_row(S1 + k * kRow, c);
    T acc = row[0] * c[0];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + row[j] * c[j];
    tct[k] = acc;
  }
  {
    T acc = tcol[0] * g_mu[0];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + tcol[j] * g_mu[j];
    if (owner && active) d_mu[b * 7 + r] = acc;
  }
  __syncwarp(mask);
  if (owner) {
    store_row(S1 + r * kRow, x);
    store_row(S2 + r * kRow, tct);
    store_row(S0 + r * kRow, tc);
  }
  __syncwarp(mask);
  T a[7];  // row r of dT, then of the suffix-applied L_i^T dT
  {
    T dc[7], xs[7], ys[7];
    row_times(tcol, S1, dc);  // row r of T^T (dcov T)
    row_times(grow, S2, xs);  // row r of dcov (T C^T)
    row_times(gcol, S0, ys);  // row r of dcov^T (T C)
    const T* m = mu + b * 7;
    const T g = g_mu[r];
#pragma unroll
    for (int l = 0; l < 7; ++l) {
      if (owner && active) d_cov[b * 49 + r * 7 + l] = dc[l];
      a[l] = g * m[l] + (xs[l] + ys[l]);
    }
  }
  __syncwarp(mask);

  // Reverse pass, segment by segment from the last: a segment's prefix
  // products are recomputed from its checkpoint (the last segment's are in
  // place); then per entry dR_i = A M_i^T replaces M_i, and A <- R_i^T A.
  T d_e = T(0);
  for (int s = segments - 1; s >= 0; --s) {
    const int first = kSegmented ? s * segment : 0;
    const int end = !kSegmented || first + segment >= n_entries ? n_entries : first + segment;
    if (kSegmented && s != segments - 1) {
      T m[7];
      load_row(saved + s * kMatrix + r * kRow, m);
      for (int e = first; e < end; ++e) {
        forward_step<kFull>(tape[e], prefix + (e - first) * kMatrix, static_cast<T*>(nullptr), S1,
                            params, consts, batch, b, e_b, rest, mass, r, lane, owner, mask, m);
      }
    }
    for (int e = end - 1; e >= first; --e) {
      const lynx::TapeEntry entry = tape[e];
      T* M = prefix + (e - first) * kMatrix;
      T dr[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        T mc[7];
        load_row(M + c * kRow, mc);
        T acc = a[0] * mc[0];
#pragma unroll
        for (int k = 1; k < 7; ++k) acc = acc + a[k] * mc[k];
        dr[c] = acc;
      }
      if (owner) store_row(S0 + r * kRow, a);
      __syncwarp(mask);
      if (owner) store_row(M + r * kRow, dr);
      __syncwarp(mask);

      const bool custom = kFull && entry.kind == lynx::kCustom;
      const bool dynamic =
          entry.kind != lynx::kConst && entry.kind != lynx::kIdentity && !custom;
      T rcol[7];  // column r of R_i
      if (entry.kind == lynx::kConst) {
        for (int q = lane; q < entry.cell_count; q += kLanes) {
          const int cell = entry.cell_start + q;
          if (active) d_consts[cell * batch + b] = M[padded(cell_pos[cell])];
        }
        const T* cells = consts + static_cast<int64_t>(entry.offset) * 49 + r;
#pragma unroll
        for (int j = 0; j < 7; ++j) rcol[j] = cells[j * 7];
      } else if (custom) {
        for (int q = lane; q < 49; q += kLanes) {
          if (active) d_params[(entry.offset + q) * batch + b] = M[padded(q)];
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) rcol[j] = params[(entry.offset + j * 7 + r) * batch + b];
      } else if (dynamic) {
        // A pass's break is uniform over the team: n is the entry's.
        const int n = lynx::tape_params<kFull>(entry.kind);
        if constexpr (kFull && sizeof(T) == 8) {
          // In double the full builders' dual numbers keep within 255
          // registers only if the passes stay a loop and reload their
          // parameters (measured with ptxas: unrolled, 764 bytes spill).
#pragma unroll 1
          for (int pass = 0; pass < kPasses; ++pass) {
            if (pass * kLanes > n) break;
            T p[kP];
            entry_params<kFull>(entry, params, batch, b, p);
            dual_pass<kFull>(entry, p, pass * kLanes, n, M, S1, slot, d_params, batch, b, active,
                             e_b, rest, mass, lane);
          }
        } else {
          T p[kP];
          entry_params<kFull>(entry, params, batch, b, p);
          for (int pass = 0; pass < kPasses; ++pass) {
            if (pass > 0 && pass * kLanes > n) break;
            dual_pass<kFull>(entry, p, pass * kLanes, n, M, S1, slot, d_params, batch, b, active,
                             e_b, rest, mass, lane);
          }
        }
      }
      __syncwarp(mask);
      if (dynamic) {
        d_e = d_e + *slot;
        load_column(S1, r, rcol);
      }
      if (entry.kind != lynx::kIdentity) row_times(rcol, S0, a);
      __syncwarp(mask);
    }
  }
  if (lane == 0 && active) d_energy[b] = d_e;
}

// The current device and its shared memory per block (opt-in), read from
// the driver once per device.
int shared_limit(int* device) {
  static std::atomic<int> limits[kDevices];  // 0: not read yet
  cudaGetDevice(device);
  int limit = *device < kDevices ? limits[*device].load(std::memory_order_relaxed) : 0;
  if (limit == 0) {
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
    if (*device < kDevices) limits[*device].store(limit, std::memory_order_relaxed);
  }
  return limit;
}

// A launch's shape: settings per block, checkpoints a setting (0: one
// segment) and the segment length.
struct Layout {
  int teams;
  int checkpoints;
  int segment;
};

// As many settings per block as `limit` bytes of shared memory hold, at most
// kMaxTeams, whole warps where there are four or more: the whole tape in one
// segment if that keeps kMaxTeams settings a block, else the longest
// segments that do.
template <typename T>
Layout plan_layout(int n_entries, int limit) {
  auto teams_for = [limit](int segment) {
    const int64_t per_setting = static_cast<int64_t>(setting_stride(segment)) * sizeof(T);
    int teams = static_cast<int>(limit / per_setting);
    if (teams > kMaxTeams) teams = kMaxTeams;
    if (teams >= 4) teams -= teams % 4;
    return teams;
  };
  const int whole = teams_for(n_entries);
  if (whole == kMaxTeams) return {whole, 0, n_entries};
  int segment = n_entries;
  while (segment > 1 && teams_for(segment) < kMaxTeams) --segment;
  return {teams_for(segment), (n_entries + segment - 1) / segment, segment};
}

template <typename T, bool kFull, bool kSegmented>
int launch(const void* tape, int n_entries, void* saved, const void* cell_pos,
           const void* params, const void* consts, const void* energy, const void* mu,
           const void* cov, const void* dmu, const void* dcov, void* d_params, void* d_consts,
           void* d_energy, void* d_mu, void* d_cov, long long batch, double rest, double mass,
           cudaStream_t stream) {
  int device = 0;
  const Layout layout = plan_layout<T>(n_entries, shared_limit(&device));
  if (layout.teams < 1 || (layout.checkpoints && saved == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = layout.teams * setting_stride(layout.segment) * static_cast<int>(sizeof(T));
  // The kernel's dynamic shared-memory limit, raised only past the largest
  // launch so far on this device.
  static std::atomic<int> allowed[kDevices];  // one per instantiation
  if (device >= kDevices || bytes > allowed[device].load(std::memory_order_relaxed)) {
    cudaFuncSetAttribute(moment_sweep_bwd_kernel<T, kFull, kSegmented>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (device < kDevices) allowed[device].store(bytes, std::memory_order_relaxed);
  }
  const int64_t blocks = (batch + layout.teams - 1) / layout.teams;
  moment_sweep_bwd_kernel<T, kFull, kSegmented><<<static_cast<unsigned>(blocks),
                                                  layout.teams * kLanes, bytes, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, layout.checkpoints, layout.segment,
      static_cast<T*>(saved), static_cast<const int*>(cell_pos), static_cast<const T*>(params),
      static_cast<const T*>(consts), static_cast<const T*>(energy), static_cast<const T*>(mu),
      static_cast<const T*>(cov), static_cast<const T*>(dmu), static_cast<const T*>(dcov),
      static_cast<T*>(d_params), static_cast<T*>(d_consts), static_cast<T*>(d_energy),
      static_cast<T*>(d_mu), static_cast<T*>(d_cov), batch, static_cast<T>(rest),
      static_cast<T>(mass));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int full, const void* tape, int n_entries, void* saved, const void* cell_pos,
           const void* params, const void* consts, const void* energy, const void* mu,
           const void* cov, const void* dmu, const void* dcov, void* d_params, void* d_consts,
           void* d_energy, void* d_mu, void* d_cov, long long batch, double rest, double mass,
           cudaStream_t stream) {
  int device = 0;
  const bool segmented = plan_layout<T>(n_entries, shared_limit(&device)).checkpoints > 0;
  auto run = [&](auto kernel_launch) {
    return kernel_launch(tape, n_entries, saved, cell_pos, params, consts, energy, mu, cov, dmu,
                         dcov, d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, mass,
                         stream);
  };
  if (full) return segmented ? run(launch<T, true, true>) : run(launch<T, true, false>);
  return segmented ? run(launch<T, false, true>) : run(launch<T, false, false>);
}

template <typename T>
Layout layout_on_this_device(int n_entries) {
  int device = 0;
  return plan_layout<T>(n_entries, shared_limit(&device));
}

}  // namespace

extern "C" {

// Settings per block of a launch with n_entries tape entries on the current
// device.
int lynx_moment_sweep_bwd_tile(int is_double, int n_entries) {
  return is_double ? layout_on_this_device<double>(n_entries).teams
                   : layout_on_this_device<float>(n_entries).teams;
}

// Entries per segment of such a launch: n_entries when the whole tape fits.
int lynx_moment_sweep_bwd_segment(int is_double, int n_entries) {
  return is_double ? layout_on_this_device<double>(n_entries).segment
                   : layout_on_this_device<float>(n_entries).segment;
}

// Checkpoints a setting of such a launch: 0 when the whole tape fits, else
// the caller passes a scratch buffer of batch * checkpoints * 56 values.
int lynx_moment_sweep_bwd_checkpoints(int is_double, int n_entries) {
  return is_double ? layout_on_this_device<double>(n_entries).checkpoints
                   : layout_on_this_device<float>(n_entries).checkpoints;
}

// tape: (n_entries, 5) int32; saved: (batch, checkpoints, 56) scratch, or
// null where lynx_moment_sweep_bwd_checkpoints is 0; cell_pos: (C,) int32; params: (P, batch);
// consts: (n_consts, 49); energy, d_energy: (batch,); mu, dmu, d_mu:
// (batch, 7); cov, dcov, d_cov: (batch, 7, 7); d_params: (P, batch);
// d_consts: (C, batch).  All float (is_double = 0) or double (is_double =
// 1), contiguous.  full: 1 if the tape holds a kind from kFirstFullKind on.
// rest, mass: the electron rest energy (m_e c^2 / e) and the CODATA electron
// mass, in eV.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// without a scratch buffer where one is needed.
int lynx_moment_sweep_bwd(int is_double, int full, const void* tape, int n_entries,
                          void* saved, const void* cell_pos, const void* params,
                          const void* consts,
                          const void* energy, const void* mu, const void* cov, const void* dmu,
                          const void* dcov, void* d_params, void* d_consts, void* d_energy,
                          void* d_mu, void* d_cov, long long batch, double rest, double mass,
                          void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(full, tape, n_entries, saved, cell_pos, params, consts, energy, mu, cov,
                          dmu, dcov, d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, mass,
                          s);
  }
  return launch<float>(full, tape, n_entries, saved, cell_pos, params, consts, energy, mu, cov,
                       dmu, dcov, d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, mass, s);
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

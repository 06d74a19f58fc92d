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
// keeps its prefix products M_0 .. M_E and three scratch matrices (no device
// workspace), rows padded to 8 cells so that a row moves in 16-byte loads.
// The number of settings per block is sized at launch from the tape length
// and the dtype to fit the device's shared memory; a ragged last block
// computes on the last setting and stores nothing.  In the reverse pass
// every lane evaluates the entry's builder once in dual numbers, lane q
// seeded on input q (parameters, then the energy), so one warp-wide pass
// gives all of an entry's <= 6 derivatives; the value part of the same pass
// is R_i.  The builders are fused_builders.cuh's, inlined so that their
// maps stay in registers.  Sums run in the same order as the one-thread-per-setting
// kernel they replace, so the numbers differ from it only by FMA
// contraction.  A team synchronises with __syncwarp: its lanes share one
// warp.

#include <atomic>

#include "fused_builders.cuh"

namespace {

constexpr int kLanes = 8;       // lanes per setting; lane r < 7 owns row r
constexpr int kMaxTeams = 32;   // settings per block at most (256 threads)
constexpr int kRow = 8;         // a row in shared memory: 7 cells and padding
constexpr int kMatrix = 7 * kRow;
constexpr int kScratch = 3;     // scratch matrices per setting
constexpr int kDevices = 64;    // devices whose launch settings are cached
constexpr int kDoesNotFit = -1; // launch(): one setting exceeds the shared memory

// Shared-memory elements per setting: M_0 .. M_E, the scratch matrices and
// one slot, rounded so that a setting starts on 16 bytes and the four
// settings of a warp start in four other banks (a stride of 4 mod 8).
__host__ __device__ inline int setting_stride(int n_entries) {
  return ((n_entries + 1 + kScratch) * kMatrix + 1 + 7) / 8 * 8 + 4;
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

// A dynamic entry's parameters for setting b (at most 5), loaded without a
// run-time index into the register array.
template <typename T>
__device__ __forceinline__ void entry_params(const lynx::TapeEntry& entry,
                                             const T* __restrict__ params, int64_t batch,
                                             int64_t b, T (&p)[5]) {
  const int n = lynx::tape_params(entry.kind);
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = k < n ? params[(entry.offset + k) * batch + b] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxTeams) moment_sweep_bwd_kernel(
    const lynx::TapeEntry* __restrict__ tape, int n_entries, const int* __restrict__ cell_pos,
    const T* __restrict__ params, const T* __restrict__ consts, const T* __restrict__ energy,
    const T* __restrict__ mu, const T* __restrict__ cov, const T* __restrict__ dmu,
    const T* __restrict__ dcov, T* __restrict__ d_params, T* __restrict__ d_consts,
    T* __restrict__ d_energy, T* __restrict__ d_mu, T* __restrict__ d_cov, int64_t batch,
    T rest) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int teams = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int r = lane < 7 ? lane : 6;  // lane 7 repeats row 6 and stores nothing
  const bool owner = lane < 7;
  const int64_t setting = static_cast<int64_t>(blockIdx.x) * teams + threadIdx.x / kLanes;
  const bool active = setting < batch;
  const int64_t b = active ? setting : batch - 1;
  const unsigned mask = warp_mask();

  T* prefix = reinterpret_cast<T*>(shared_raw) +
              static_cast<int64_t>(threadIdx.x / kLanes) * setting_stride(n_entries);
  T* const Tm = prefix + n_entries * kMatrix;  // M_E = T
  T* const S0 = Tm + kMatrix;                  // dcov, then T C, then A
  T* const S1 = S0 + kMatrix;                  // cov, then dcov T, then R_i
  T* const S2 = S1 + kMatrix;                  // T C^T
  T* const slot = S2 + kMatrix;                // an entry's energy cotangent
  const T e_b = energy[b];

  // Forward pass: M_{i+1} = R_i M_i, each M_i to shared memory.
  T row[7];  // row r of M_i
#pragma unroll
  for (int k = 0; k < 7; ++k) row[k] = T(k == r ? 1 : 0);
  for (int e = 0; e < n_entries; ++e) {
    const lynx::TapeEntry entry = tape[e];
    T* M = prefix + e * kMatrix;
    if (owner) store_row(M + r * kRow, row);
    T rrow[7];  // row r of R_i
    if (entry.kind == lynx::kConst) {
      const T* cells = consts + static_cast<int64_t>(entry.offset) * 49 + r * 7;
#pragma unroll
      for (int k = 0; k < 7; ++k) rrow[k] = cells[k];
    } else {
      T p[5], R[49];
      entry_params(entry, params, batch, b, p);
      lynx::build_dynamic<T, T>(entry.kind, p, e_b, rest, R);
      scatter_rows(R, S1, lane);
    }
    __syncwarp(mask);
    if (entry.kind != lynx::kConst) load_row(S1 + r * kRow, rrow);
    row_times(rrow, M, row);
    __syncwarp(mask);
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

  // Reverse pass: dR_i = A M_i^T replaces M_i; then A <- R_i^T A.
  T d_e = T(0);
  for (int e = n_entries - 1; e >= 0; --e) {
    const lynx::TapeEntry entry = tape[e];
    T* M = prefix + e * kMatrix;
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

    const bool dynamic = entry.kind != lynx::kConst && entry.kind != lynx::kIdentity;
    T rcol[7];  // column r of R_i
    if (entry.kind == lynx::kConst) {
      for (int q = lane; q < entry.cell_count; q += kLanes) {
        const int cell = entry.cell_start + q;
        if (active) d_consts[cell * batch + b] = M[padded(cell_pos[cell])];
      }
      const T* cells = consts + static_cast<int64_t>(entry.offset) * 49 + r;
#pragma unroll
      for (int j = 0; j < 7; ++j) rcol[j] = cells[j * 7];
    } else if (dynamic) {
      const int n = lynx::tape_params(entry.kind);
      T p[5];
      entry_params(entry, params, batch, b, p);
      lynx::Dual<T> pd[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) pd[k] = lynx::Dual<T>(p[k], k == lane ? T(1) : T(0));
      const lynx::Dual<T> ed(e_b, lane == n ? T(1) : T(0));
      lynx::Dual<T> Rd[49];
      lynx::build_dynamic<T, lynx::Dual<T>>(entry.kind, pd, ed, rest, Rd);
      T g = T(0);
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        T dri[7];
        load_row(M + i * kRow, dri);
#pragma unroll
        for (int k = 0; k < 7; ++k) g = g + dri[k] * Rd[i * 7 + k].d;
      }
      if (lane < n) {
        if (active) d_params[(entry.offset + lane) * batch + b] = g;
      } else if (lane == n) {
        *slot = g;
      }
      scatter_rows(Rd, S1, lane);
    }
    __syncwarp(mask);
    if (dynamic) {
      d_e = d_e + *slot;
      load_column(S1, r, rcol);
    }
    if (entry.kind != lynx::kIdentity) row_times(rcol, S0, a);
    __syncwarp(mask);
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

// Settings per block: as many as `limit` bytes of shared memory hold, at
// most kMaxTeams, whole warps where there are four or more; 0 if one setting
// does not fit.
template <typename T>
int settings_per_block(int n_entries, int limit) {
  const int64_t per_setting = static_cast<int64_t>(setting_stride(n_entries)) * sizeof(T);
  int teams = static_cast<int>(limit / per_setting);
  if (teams > kMaxTeams) teams = kMaxTeams;
  if (teams >= 4) teams -= teams % 4;
  return teams;
}

template <typename T>
int launch(const void* tape, int n_entries, const void* cell_pos, const void* params,
           const void* consts, const void* energy, const void* mu, const void* cov,
           const void* dmu, const void* dcov, void* d_params, void* d_consts, void* d_energy,
           void* d_mu, void* d_cov, long long batch, double rest, cudaStream_t stream) {
  int device = 0;
  const int teams = settings_per_block<T>(n_entries, shared_limit(&device));
  if (teams < 1) return kDoesNotFit;
  const int bytes = teams * setting_stride(n_entries) * static_cast<int>(sizeof(T));
  // The kernel's dynamic shared-memory limit, raised only past the largest
  // launch so far on this device.
  static std::atomic<int> allowed[kDevices];
  if (device >= kDevices || bytes > allowed[device].load(std::memory_order_relaxed)) {
    cudaFuncSetAttribute(moment_sweep_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    if (device < kDevices) allowed[device].store(bytes, std::memory_order_relaxed);
  }
  const int64_t blocks = (batch + teams - 1) / teams;
  moment_sweep_bwd_kernel<T><<<static_cast<unsigned>(blocks), teams * kLanes, bytes, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, static_cast<const int*>(cell_pos),
      static_cast<const T*>(params), static_cast<const T*>(consts),
      static_cast<const T*>(energy), static_cast<const T*>(mu), static_cast<const T*>(cov),
      static_cast<const T*>(dmu), static_cast<const T*>(dcov), static_cast<T*>(d_params),
      static_cast<T*>(d_consts), static_cast<T*>(d_energy), static_cast<T*>(d_mu),
      static_cast<T*>(d_cov), batch, static_cast<T>(rest));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Settings per block of a launch with n_entries tape entries on the current
// device; 0 if one setting's shared memory exceeds the device's limit.
int lynx_moment_sweep_bwd_tile(int is_double, int n_entries) {
  int device = 0;
  const int limit = shared_limit(&device);
  return is_double ? settings_per_block<double>(n_entries, limit)
                   : settings_per_block<float>(n_entries, limit);
}

// tape: (n_entries, 4) int32; cell_pos: (C,) int32; params: (P, batch);
// consts: (n_consts, 49); energy, d_energy: (batch,); mu, dmu, d_mu:
// (batch, 7); cov, dcov, d_cov: (batch, 7, 7); d_params: (P, batch);
// d_consts: (C, batch).  All float (is_double = 0) or double (is_double =
// 1), contiguous.  rest: the electron rest energy in eV.  Returns -1 if one
// setting's prefix products do not fit in the device's shared memory per
// block (lynx_moment_sweep_bwd_tile is 0), else cudaGetLastError().
int lynx_moment_sweep_bwd(int is_double, const void* tape, int n_entries, const void* cell_pos,
                          const void* params, const void* consts, const void* energy,
                          const void* mu, const void* cov, const void* dmu, const void* dcov,
                          void* d_params, void* d_consts, void* d_energy, void* d_mu,
                          void* d_cov, long long batch, double rest, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(tape, n_entries, cell_pos, params, consts, energy, mu, cov, dmu, dcov,
                          d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, s);
  }
  return launch<float>(tape, n_entries, cell_pos, params, consts, energy, mu, cov, dmu, dcov,
                       d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, s);
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused moment sweep (kernel B3) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_kernel (launched by
// _fused_moment_sweep_impl).  For each of B settings it builds every
// dynamic plan entry's 7x7 map from the setting's parameters, composes it
// with the pre-composed const groups, T = R_{E-1} ... R_0, and writes
// mu' = T mu and cov' = T cov T^T in the port's (B, 7) and (B, 7, 7)
// layout.  The plan reaches the kernel as an op tape (fused_builders.cuh).
//
// What bounds it on an H100: memory.  Per setting it reads the parameters
// (4-8 bytes each), mu and cov (56 values) and writes 56 values: ~53 MB in
// f32 at B = 100,000, 16 us at 3.35 TB/s.  Counted on the maps' structural
// supports its products are ~1.5e3 flops a setting on path S's plan
// (chip_smoke.py's sweep_flops), 2.2 us at 67 TFLOP/s; the builders'
// transcendentals come on top.  The kernel it replaces ran one thread per
// setting with dense 343-FMA products and 49-value strided loads and stores
// (a warp touched 32 sectors per access), at 7.7x that bound.
//
// Design: one thread per setting, 64 settings a block.  The chain runs on
// each entry's structural support (compose_support): a dynamic entry's from
// its builder, a const entry's from the support class that the tape gives
// it (a drift group's map has 3 cells off the diagonal), so a drift costs
// 21 FMAs where a dense product costs 343, and rows of a map that are the
// identity's cost nothing.  The block moves its settings' mu and cov into
// shared memory, and its outputs back, as contiguous 16-byte vectors, so
// that a warp's accesses to device memory are neighbouring addresses; in
// shared memory each thread's 49 cells sit at a stride of 49 words (no bank
// conflicts).  T C and then (T C) T^T are formed in place there, column by
// column and row by row.  A ragged last block computes on its last setting
// and stores nothing.  Templated on float and double: the kernel computes in
// the beam's dtype, as the TPU kernel does.

#include "fused_builders.cuh"

namespace {

constexpr int kSettings = 64;  // settings (threads) per block

template <typename T> struct Vector16;
template <> struct Vector16<float> { using type = float4; };
template <> struct Vector16<double> { using type = double2; };

// count values from src to dst, as 16-byte vectors where `vectors` holds.
template <typename T>
__device__ __forceinline__ void copy_block(const T* __restrict__ src, T* __restrict__ dst,
                                           int count, bool vectors) {
  using V = typename Vector16<T>::type;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (vectors) {
    for (int k = threadIdx.x; k < count / kPer; k += kSettings) {
      reinterpret_cast<V*>(dst)[k] = reinterpret_cast<const V*>(src)[k];
    }
  } else {
    for (int k = threadIdx.x; k < count; k += kSettings) dst[k] = src[k];
  }
}

// total <- (the map of entry `entry` for setting b) @ total.
template <typename T>
__device__ __forceinline__ void compose_entry(const lynx::TapeEntry& entry,
                                              const T* __restrict__ params,
                                              const T* __restrict__ consts, int64_t batch,
                                              int64_t b, T energy, T rest, T* total) {
  using namespace lynx;
  if (entry.kind == kIdentity) return;
  T R[49];
  if (entry.kind == kConst) {
    const T* cells = consts + static_cast<int64_t>(entry.offset) * 49;
#pragma unroll
    for (int c = 0; c < 49; ++c) R[c] = cells[c];  // loads of cells off the support are dead
    if (entry.support == kDriftConst) {
      compose_support<kDriftCells, kIdentityCells>(R, total);
    } else if (entry.support == kKickedDriftConst) {
      compose_support<kDriftCells | kKickCells, kIdentityCells>(R, total);
    } else {
      compose_support<kAllCells, 0>(R, total);
    }
    return;
  }
  T p[5];
  const int n = tape_params(entry.kind);
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = k < n ? params[(entry.offset + k) * batch + b] : T(0);
  if (entry.kind == kQuad) {
    build_quadrupole<T>(p, energy, rest, R);
    compose_support<kQuadCells, kQuadOnes>(R, total);
    return;
  }
  build_dynamic<T, T>(entry.kind, p, energy, rest, R);
  if (entry.kind == kDrift) {
    compose_support<kDriftCells, kIdentityCells>(R, total);
  } else if (entry.kind == kHCor) {
    compose_support<kHCorCells, kIdentityCells>(R, total);
  } else {
    compose_support<kVCorCells, kIdentityCells>(R, total);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSettings) moment_sweep_kernel(
    const lynx::TapeEntry* __restrict__ tape, int n_entries, const T* __restrict__ params,
    const T* __restrict__ consts, const T* __restrict__ energy, const T* __restrict__ mu,
    const T* __restrict__ cov, T* __restrict__ out_mu, T* __restrict__ out_cov, int64_t batch,
    T rest) {
  __shared__ __align__(16) T s_cov[kSettings * 49];
  __shared__ __align__(16) T s_mu[kSettings * 7];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSettings;
  const int count = batch - first < kSettings ? static_cast<int>(batch - first) : kSettings;
  // A full block whose tensors start on 16 bytes moves as vectors (a block
  // starts 64 * 49 values further on); anything else value by value.
  const bool vectors =
      count == kSettings && ((reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(cov) |
                              reinterpret_cast<uintptr_t>(out_mu) |
                              reinterpret_cast<uintptr_t>(out_cov)) & 15) == 0;
  copy_block(cov + first * 49, s_cov, count * 49, vectors);
  copy_block(mu + first * 7, s_mu, count * 7, vectors);

  const int t = threadIdx.x;
  const int64_t b = first + (t < count ? t : count - 1);
  const T e_b = energy[b];
  T total[49];
  lynx::set_identity(total);
  for (int e = 0; e < n_entries; ++e) {
    compose_entry(tape[e], params, consts, batch, b, e_b, rest, total);
  }
  __syncthreads();  // mu and cov are staged

  // mu' = T mu, in place.
  T* m = s_mu + t * 7;
  {
    T x[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) x[j] = m[j];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      T acc = total[i * 7] * x[0];
#pragma unroll
      for (int j = 1; j < 7; ++j) acc = acc + total[i * 7 + j] * x[j];
      m[i] = acc;
    }
  }
  // T C, column by column in place (a column of T C needs only the same
  // column of C); then (T C) T^T, row by row in place.
  T* c = s_cov + t * 49;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    T x[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) x[j] = c[j * 7 + k];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      T acc = total[i * 7] * x[0];
#pragma unroll
      for (int j = 1; j < 7; ++j) acc = acc + total[i * 7 + j] * x[j];
      c[i * 7 + k] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    T x[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) x[k] = c[i * 7 + k];
#pragma unroll
    for (int l = 0; l < 7; ++l) {
      T acc = x[0] * total[l * 7];
#pragma unroll
      for (int k = 1; k < 7; ++k) acc = acc + x[k] * total[l * 7 + k];
      c[i * 7 + l] = acc;
    }
  }
  __syncthreads();  // every output is in shared memory
  copy_block(s_cov, out_cov + first * 49, count * 49, vectors);
  copy_block(s_mu, out_mu + first * 7, count * 7, vectors);
}

template <typename T>
void launch(const void* tape, int n_entries, const void* params, const void* consts,
            const void* energy, const void* mu, const void* cov, void* out_mu, void* out_cov,
            long long batch, double rest, cudaStream_t stream) {
  const int64_t blocks = (batch + kSettings - 1) / kSettings;
  moment_sweep_kernel<T><<<static_cast<unsigned>(blocks), kSettings, 0, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, static_cast<const T*>(params),
      static_cast<const T*>(consts), static_cast<const T*>(energy), static_cast<const T*>(mu),
      static_cast<const T*>(cov), static_cast<T*>(out_mu), static_cast<T*>(out_cov), batch,
      static_cast<T>(rest));
}

}  // namespace

extern "C" {

// tape: (n_entries, 5) int32; params: (P, batch); consts: (n_consts, 49);
// energy: (batch,); mu, out_mu: (batch, 7); cov, out_cov: (batch, 7, 7);
// all float (is_double = 0) or double (is_double = 1), contiguous.
// rest: the electron rest energy in eV.  Returns cudaGetLastError().
int lynx_moment_sweep(int is_double, const void* tape, int n_entries, const void* params,
                      const void* consts, const void* energy, const void* mu, const void* cov,
                      void* out_mu, void* out_cov, long long batch, double rest, void* stream) {
  if (batch > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(tape, n_entries, params, consts, energy, mu, cov, out_mu, out_cov, batch,
                     rest, s);
    } else {
      launch<float>(tape, n_entries, params, consts, energy, mu, cov, out_mu, out_cov, batch,
                    rest, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

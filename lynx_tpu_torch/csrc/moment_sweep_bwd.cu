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
// What bounds it on an H100: like B3, per-setting arithmetic (a forward
// re-pass, a reverse pass of two dense 7x7 products per entry, and 2-6
// dual-number builder evaluations per dynamic entry) and the prefix
// products M_i, which the forward re-pass writes to a (E, 49, B) workspace
// tensor and the reverse pass reads back: at B = 100,000 and 11 entries
// that is 215 MB each way in f32.
//
// Design: one thread per setting.  M_i goes to the workspace tensor, laid
// out so that a warp's threads touch neighbouring addresses; the suffix
// product is carried backwards in registers (A_{i-1} = R_i^T A_i), and R_i
// is rebuilt in the reverse pass instead of stored.

#include "fused_builders.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void moment_sweep_bwd_kernel(
    const lynx::TapeEntry* __restrict__ tape, int n_entries, const int* __restrict__ cell_pos,
    const T* __restrict__ params, const T* __restrict__ consts, const T* __restrict__ energy,
    const T* __restrict__ mu, const T* __restrict__ cov, const T* __restrict__ dmu,
    const T* __restrict__ dcov, T* __restrict__ prefix, T* __restrict__ d_params,
    T* __restrict__ d_consts, T* __restrict__ d_energy, T* __restrict__ d_mu,
    T* __restrict__ d_cov, int64_t batch, T rest) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T e_b = energy[b];

  // Forward re-pass: M_i to workspace, T = M_E in registers.
  T M[49];
  lynx::set_identity(M);
  for (int e = 0; e < n_entries; ++e) {
    T* slot = prefix + static_cast<int64_t>(e) * 49 * batch + b;
#pragma unroll
    for (int c = 0; c < 49; ++c) slot[c * batch] = M[c];
    T R[49];
    lynx::build_entry(tape[e], params, consts, batch, b, e_b, rest, R);
    lynx::left_multiply(R, M);
  }

  // d_mu = T^T dmu; d_cov = T^T (dcov T).
  T X[49], Y[49];
  const T* g_mu = dmu + b * 7;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    T acc = M[i] * g_mu[0];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + M[j * 7 + i] * g_mu[j];
    d_mu[b * 7 + i] = acc;
  }
  T G[49];  // dcov
#pragma unroll
  for (int c = 0; c < 49; ++c) G[c] = dcov[b * 49 + c];
  lynx::matmul7(G, M, X);  // dcov T
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int l = 0; l < 7; ++l) {
      T acc = M[i] * X[l];
#pragma unroll
      for (int k = 1; k < 7; ++k) acc = acc + M[k * 7 + i] * X[k * 7 + l];
      d_cov[b * 49 + i * 7 + l] = acc;
    }
  }

  // dT = dmu mu^T + (dcov (T C^T) + dcov^T (T C)).
  T C[49];
#pragma unroll
  for (int c = 0; c < 49; ++c) C[c] = cov[b * 49 + c];
  T A[49];  // becomes dT, then the suffix-applied L_i^T dT
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      T tc = M[i * 7] * C[k * 7];   // (T C^T)[i][k]
      T tct = M[i * 7] * C[k];      // (T C)[i][k]
#pragma unroll
      for (int j = 1; j < 7; ++j) {
        tc = tc + M[i * 7 + j] * C[k * 7 + j];
        tct = tct + M[i * 7 + j] * C[j * 7 + k];
      }
      X[i * 7 + k] = tc;
      Y[i * 7 + k] = tct;
    }
  }
  const T* m = mu + b * 7;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      T x = G[i * 7] * X[k];     // (dcov (T C^T))[i][k]
      T y = G[i] * Y[k];         // (dcov^T (T C))[i][k]
#pragma unroll
      for (int j = 1; j < 7; ++j) {
        x = x + G[i * 7 + j] * X[j * 7 + k];
        y = y + G[j * 7 + i] * Y[j * 7 + k];
      }
      A[i * 7 + k] = g_mu[i] * m[k] + (x + y);
    }
  }

  // Reverse pass.
  T d_e = T(0);
  for (int e = n_entries - 1; e >= 0; --e) {
    const lynx::TapeEntry entry = tape[e];
    const T* slot = prefix + static_cast<int64_t>(e) * 49 * batch + b;
#pragma unroll
    for (int c = 0; c < 49; ++c) M[c] = slot[c * batch];
    T dR[49];  // A M_i^T
#pragma unroll
    for (int r = 0; r < 7; ++r) {
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        T acc = A[r * 7] * M[c * 7];
#pragma unroll
        for (int k = 1; k < 7; ++k) acc = acc + A[r * 7 + k] * M[c * 7 + k];
        dR[r * 7 + c] = acc;
      }
    }

    if (entry.kind == lynx::kConst) {
      for (int q = 0; q < entry.cell_count; ++q) {
        const int cell = entry.cell_start + q;
        d_consts[cell * batch + b] = dR[cell_pos[cell]];
      }
    } else if (entry.kind != lynx::kIdentity) {
      const int n = lynx::tape_params(entry.kind);
      T p[5];
      for (int k = 0; k < n; ++k) p[k] = params[(entry.offset + k) * batch + b];
      for (int q = 0; q <= n; ++q) {  // q == n: the energy
        lynx::Dual<T> pd[5];
        for (int k = 0; k < n; ++k) pd[k] = lynx::Dual<T>(p[k], k == q ? T(1) : T(0));
        const lynx::Dual<T> ed(e_b, q == n ? T(1) : T(0));
        lynx::Dual<T> Rd[49];
        lynx::build_dynamic<T, lynx::Dual<T>>(entry.kind, pd, ed, rest, Rd);
        T g = T(0);
#pragma unroll
        for (int c = 0; c < 49; ++c) g = g + dR[c] * Rd[c].d;
        if (q < n) {
          d_params[(entry.offset + q) * batch + b] = g;
        } else {
          d_e = d_e + g;
        }
      }
    }

    // A <- R_i^T A.
    T R[49];
    lynx::build_entry(entry, params, consts, batch, b, e_b, rest, R);
#pragma unroll
    for (int i = 0; i < 7; ++i) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        T acc = R[i] * A[k];
#pragma unroll
        for (int j = 1; j < 7; ++j) acc = acc + R[j * 7 + i] * A[j * 7 + k];
        X[i * 7 + k] = acc;
      }
    }
#pragma unroll
    for (int c = 0; c < 49; ++c) A[c] = X[c];
  }
  d_energy[b] = d_e;
}

template <typename T>
void launch(const void* tape, int n_entries, const void* cell_pos, const void* params,
            const void* consts, const void* energy, const void* mu, const void* cov,
            const void* dmu, const void* dcov, void* prefix, void* d_params, void* d_consts,
            void* d_energy, void* d_mu, void* d_cov, long long batch, double rest,
            cudaStream_t stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  moment_sweep_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, static_cast<const int*>(cell_pos),
      static_cast<const T*>(params), static_cast<const T*>(consts),
      static_cast<const T*>(energy), static_cast<const T*>(mu), static_cast<const T*>(cov),
      static_cast<const T*>(dmu), static_cast<const T*>(dcov), static_cast<T*>(prefix),
      static_cast<T*>(d_params), static_cast<T*>(d_consts), static_cast<T*>(d_energy),
      static_cast<T*>(d_mu), static_cast<T*>(d_cov), batch, static_cast<T>(rest));
}

}  // namespace

extern "C" {

// tape: (n_entries, 4) int32; cell_pos: (C,) int32; params: (P, batch);
// consts: (n_consts, 49); energy, d_energy: (batch,); mu, dmu, d_mu:
// (batch, 7); cov, dcov, d_cov: (batch, 7, 7); prefix: (n_entries, 49,
// batch) workspace; d_params: (P, batch); d_consts: (C, batch).  All float
// (is_double = 0) or double (is_double = 1), contiguous.  rest: the
// electron rest energy in eV.  Returns cudaGetLastError().
int lynx_moment_sweep_bwd(int is_double, const void* tape, int n_entries, const void* cell_pos,
                          const void* params, const void* consts, const void* energy,
                          const void* mu, const void* cov, const void* dmu, const void* dcov,
                          void* prefix, void* d_params, void* d_consts, void* d_energy,
                          void* d_mu, void* d_cov, long long batch, double rest,
                          void* stream) {
  if (batch > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(tape, n_entries, cell_pos, params, consts, energy, mu, cov, dmu, dcov,
                     prefix, d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, s);
    } else {
      launch<float>(tape, n_entries, cell_pos, params, consts, energy, mu, cov, dmu, dcov,
                    prefix, d_params, d_consts, d_energy, d_mu, d_cov, batch, rest, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

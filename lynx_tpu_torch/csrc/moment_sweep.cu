// Fused moment sweep (kernel B3) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_kernel (launched by
// _fused_moment_sweep_impl).  For each of B settings it builds every
// dynamic plan entry's 7x7 map from the setting's parameters, composes it
// with the pre-composed const groups, T = R_{E-1} ... R_0, and writes
// mu' = T mu and cov' = T cov T^T in the port's (B, 7) and (B, 7, 7)
// layout.  The plan reaches the kernel as an op tape (fused_builders.cuh).
//
// What bounds it on an H100: per setting it reads the parameters (4-8
// bytes each), mu and cov (56 values) and writes 56 values, and does a few
// thousand flops (one 343-FMA dense compose per entry plus the builders'
// transcendentals).  At B = 100,000 that is ~53 MB of traffic in f32 and
// ~0.5 GFLOP: both well under a millisecond, so launch and occupancy
// matter more than either roofline.
//
// Design: one thread per setting, maps dense in registers and local
// memory, no shared memory: the settings are independent and the 7x7
// algebra is too small for the tensor cores.  The builders skip their
// structural zeros; the compose of the entries is dense.  Templated on float and double: the
// kernel computes in the beam's dtype, as the TPU kernel does.

#include "fused_builders.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void moment_sweep_kernel(const lynx::TapeEntry* __restrict__ tape, int n_entries,
                                    const T* __restrict__ params, const T* __restrict__ consts,
                                    const T* __restrict__ energy, const T* __restrict__ mu,
                                    const T* __restrict__ cov, T* __restrict__ out_mu,
                                    T* __restrict__ out_cov, int64_t batch, T rest) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T e_b = energy[b];

  T total[49];
  lynx::set_identity(total);
  for (int e = 0; e < n_entries; ++e) {
    T R[49];
    lynx::build_entry(tape[e], params, consts, batch, b, e_b, rest, R);
    lynx::left_multiply(R, total);
  }

  const T* m = mu + b * 7;
  T* om = out_mu + b * 7;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    T acc = total[i * 7] * m[0];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + total[i * 7 + j] * m[j];
    om[i] = acc;
  }

  // cov' = (T C) T^T
  T C[49];
  const T* c = cov + b * 49;
#pragma unroll
  for (int k = 0; k < 49; ++k) C[k] = c[k];
  T TC[49];
  lynx::matmul7(total, C, TC);
  T* oc = out_cov + b * 49;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int l = 0; l < 7; ++l) {
      T acc = TC[i * 7] * total[l * 7];
#pragma unroll
      for (int k = 1; k < 7; ++k) acc = acc + TC[i * 7 + k] * total[l * 7 + k];
      oc[i * 7 + l] = acc;
    }
  }
}

template <typename T>
void launch(const void* tape, int n_entries, const void* params, const void* consts,
            const void* energy, const void* mu, const void* cov, void* out_mu, void* out_cov,
            long long batch, double rest, cudaStream_t stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  moment_sweep_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, static_cast<const T*>(params),
      static_cast<const T*>(consts), static_cast<const T*>(energy), static_cast<const T*>(mu),
      static_cast<const T*>(cov), static_cast<T*>(out_mu), static_cast<T*>(out_cov), batch,
      static_cast<T>(rest));
}

}  // namespace

extern "C" {

// tape: (n_entries, 4) int32; params: (P, batch); consts: (n_consts, 49);
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

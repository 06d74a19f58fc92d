// A run's maps built and folded per setting on the card (kernel B10) for
// Hopper, sm_90a.
//
// Replaces the sparse table algebra of the particle moment sweep's plan
// (accelerator/fused.py:particle_moment_plan) on the card: there every
// element's map is built at (B,) and every product of the fold is a
// PyTorch kernel of its own, ~1,600 small kernels a run of the ARES-EA
// segment; it has no TPU counterpart (under jit, XLA fuses that algebra).
// For each of B settings it walks B3's op tape with fused_builders.cuh's
// builders, composing the run's map T_b = R_{E-1} ... R_0 over each entry's
// structural support in B3's order (lynx::compose_entry), as B8 builds its
// map, and writes the composed layout's non-literal cells: bit c of `cells`
// (cell c = 7 i + j) set for each, in ascending c, which is _split_table's
// order.  out is (n_cells, B): row k holds the k-th such cell of every
// setting, so the plan's per-setting scalars are its rows.
//
// What bounds it on an H100: the serial walk.  A 13-entry tape (three
// tilted, misaligned quadrupoles with their transcendentals and sparse
// products) is one dependent chain of some thousands of instructions on one
// thread; the bytes (the tape's parameters in, the cells out: ~60 kB at
// B = 256) take tens of nanoseconds.
//
// Design: one thread a setting, the map in its registers; consecutive
// threads take consecutive settings, so each parameter row is read and each
// cell row written as whole coalesced lines.  Small blocks (kThreads) spread
// a few hundred settings over several SMs.  Templated on float and double
// (the energy's dtype) and on kFull as B3.

#include "fused_builders.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads) map_fold_kernel(
    const lynx::TapeEntry* __restrict__ tape, int n_entries, const T* __restrict__ params,
    const T* __restrict__ consts, const T* __restrict__ energy, T* __restrict__ out,
    int64_t batch, unsigned long long cells, T rest, T mass) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= batch) return;
  T total[49];
  lynx::set_identity(total);
  const T e_b = energy[b];
  for (int e = 0; e < n_entries; ++e) {
    lynx::compose_entry<kFull>(tape[e], params, consts, batch, b, e_b, rest, mass, total);
  }
  int64_t row = 0;
#pragma unroll
  for (int c = 0; c < 49; ++c) {
    if ((cells >> c) & 1ull) {
      out[row * batch + b] = total[c];
      ++row;
    }
  }
}

template <typename T, bool kFull>
void launch(const void* tape, int n_entries, const void* params, const void* consts,
            const void* energy, void* out, long long batch, unsigned long long cells,
            double rest, double mass, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((batch + kThreads - 1) / kThreads);
  map_fold_kernel<T, kFull><<<blocks, kThreads, 0, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, static_cast<const T*>(params),
      static_cast<const T*>(consts), static_cast<const T*>(energy), static_cast<T*>(out), batch,
      cells, static_cast<T>(rest), static_cast<T>(mass));
}

template <typename T>
void launch(int full, const void* tape, int n_entries, const void* params, const void* consts,
            const void* energy, void* out, long long batch, unsigned long long cells,
            double rest, double mass, cudaStream_t stream) {
  if (full) {
    launch<T, true>(tape, n_entries, params, consts, energy, out, batch, cells, rest, mass,
                    stream);
  } else {
    launch<T, false>(tape, n_entries, params, consts, energy, out, batch, cells, rest, mass,
                     stream);
  }
}

}  // namespace

extern "C" {

// tape: (n_entries, 5) int32, B3's; params: (P, batch); consts: (n_consts,
// 49); energy: (batch,); out: (popcount(cells), batch); all float
// (is_double = 0) or double (is_double = 1), contiguous.  full: 1 if the
// tape holds a kind from kFirstFullKind on.  Bit 7 i + j of cells is set
// where cell (i, j) of the composed map is written out.  rest, mass: the
// electron rest energy (m_e c^2 / e) and the CODATA electron mass, in eV.
// Returns cudaGetLastError().
int lynx_map_fold(int is_double, int full, const void* tape, int n_entries, const void* params,
                  const void* consts, const void* energy, void* out, long long batch,
                  unsigned long long cells, double rest, double mass, void* stream) {
  if (batch > 0 && cells != 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(full, tape, n_entries, params, consts, energy, out, batch, cells, rest,
                     mass, s);
    } else {
      launch<float>(full, tape, n_entries, params, consts, energy, out, batch, cells, rest, mass,
                    s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

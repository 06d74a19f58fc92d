// Particle push with its map built on the card (kernel B8) for Hopper, sm_90a.
//
// Replaces the dense route's per-element PyTorch maps for a run of linear
// elements over a particle beam (accelerator/segment.py:flush_run: each
// element's 7x7 map built and the maps folded by hundreds of small kernels a
// run); it has no TPU counterpart.  For each of B settings it walks B3's op
// tape with fused_builders.cuh's builders, composing the run's map T_b =
// R_{E-1} ... R_0 over each entry's structural support in B3's order
// (lynx::compose_entry), and pushes the setting's N particles through it:
// out[b, n] = T_b p[b, n] for (B, N, 7) particles.
//
// What bounds it on an H100: at the screen read's shape (B = 1, N = 100,000,
// float) the serial build, not the bytes.  The push reads and writes 2.8 MB
// each way, 1.7 us at 3.35 TB/s; the walk of a 12-element tape (three tilted,
// misaligned quadrupoles with their transcendentals and sparse products) is
// one dependent chain of some thousands of instructions on one thread.
//
// Design: one launch, one block per span of kSpanBytes of one setting's
// particles (spans never straddle settings), and every block rebuilds its
// setting's map: the first lane of an extra warp walks the tape while the
// block's other kCopyThreads threads stage the span into shared memory (as
// 16-byte vectors, neighbouring threads on neighbouring addresses, where the
// span is whole and aligned, as in B2), so the build overlaps the span's
// loads.  The map then reaches every thread through shared memory.  The push
// is B2's: the host's masks (the composed layout of the tape's builders, the
// plain version's) make a structural zero an exact 0 and a structural one an
// exact 1; a particle with finite coordinates takes the dense sum in column
// order, which gives the plain version's numbers up to FMA contraction, and
// one with an infinite or NaN coordinate skips the structural zeros, as the
// plain version does.  Templated on float and double (the beam's dtype), and
// on kFull as B3: a tape with a kind of the full lattice runs the
// instantiation with those builders, the others keep their registers.

#include "fused_builders.cuh"

namespace {

constexpr int kCopyThreads = 128;            // stage the span and store it back
constexpr int kThreads = kCopyThreads + 32;  // and one warp whose first lane builds the map
constexpr int kSpanBytes = 14336;            // a multiple of 7 * 16 bytes

template <typename T> struct Vector16;
template <> struct Vector16<float> { using type = float4; };
template <> struct Vector16<double> { using type = double2; };

template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads) particle_push_kernel(
    const lynx::TapeEntry* __restrict__ tape, int n_entries, const T* __restrict__ params,
    const T* __restrict__ consts, const T* __restrict__ energy, const T* __restrict__ particles,
    T* __restrict__ out, int64_t batch, int64_t n, int64_t spans, unsigned long long zeros,
    unsigned long long ones, T rest, T mass) {
  using V = typename Vector16<T>::type;
  constexpr int kSpan = kSpanBytes / (7 * static_cast<int>(sizeof(T)));  // particles
  constexpr int kPerThread = kSpanBytes / 16 / kCopyThreads;
  static_assert(kSpanBytes / 16 % kCopyThreads == 0, "a span is whole vectors per thread");
  __shared__ __align__(16) T span[kSpan * 7];
  __shared__ T map[49];

  const int64_t b = blockIdx.x / spans;
  const int64_t first = blockIdx.x % spans * kSpan;  // the span's first particle in setting b
  const int count = n - first < kSpan ? static_cast<int>(n - first) : kSpan;
  const T* src = particles + (b * n + first) * 7;
  T* dst = out + (b * n + first) * 7;
  // A whole span whose ends start on 16 bytes moves as vectors; anything
  // else value by value.
  const bool vectors = count == kSpan && ((reinterpret_cast<uintptr_t>(src) |
                                           reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int t = threadIdx.x;
  if (t < kCopyThreads) {
    if (vectors) {
      V staged[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        staged[k] = reinterpret_cast<const V*>(src)[t + k * kCopyThreads];
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        reinterpret_cast<V*>(span)[t + k * kCopyThreads] = staged[k];
      }
    } else {
      for (int k = t; k < count * 7; k += kCopyThreads) span[k] = src[k];
    }
  } else if (t == kCopyThreads) {
    T total[49];
    lynx::set_identity(total);
    const T e_b = energy[b];
    for (int e = 0; e < n_entries; ++e) {
      lynx::compose_entry<kFull>(tape[e], params, consts, batch, b, e_b, rest, mass, total);
    }
#pragma unroll
    for (int c = 0; c < 49; ++c) map[c] = total[c];
  }
  __syncthreads();  // the span is staged and the map built

  T cell[49];
#pragma unroll
  for (int c = 0; c < 49; ++c) {
    cell[c] = ((zeros >> c) & 1ull) ? T(0) : ((ones >> c) & 1ull) ? T(1) : map[c];
  }
  for (int j = t; j < count; j += kThreads) {
    T* p = span + j * 7;
    T x[7];
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      x[k] = p[k];
      finite = finite && isfinite(x[k]);
    }
    if (finite) {
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        T acc = cell[r * 7] * x[0];
#pragma unroll
        for (int k = 1; k < 7; ++k) acc = acc + cell[r * 7 + k] * x[k];
        p[r] = acc;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        T acc = T(0);
        bool started = false;
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          if ((zeros >> (r * 7 + k)) & 1ull) continue;
          acc = started ? acc + cell[r * 7 + k] * x[k] : cell[r * 7 + k] * x[k];
          started = true;
        }
        p[r] = acc;
      }
    }
  }
  __syncthreads();  // every particle of the span is pushed

  if (t < kCopyThreads) {
    if (vectors) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        reinterpret_cast<V*>(dst)[t + k * kCopyThreads] =
            reinterpret_cast<const V*>(span)[t + k * kCopyThreads];
      }
    } else {
      for (int k = t; k < count * 7; k += kCopyThreads) dst[k] = span[k];
    }
  }
}

template <typename T, bool kFull>
void launch(const void* tape, int n_entries, const void* params, const void* consts,
            const void* energy, const void* particles, void* out, long long batch, long long n,
            unsigned long long zeros, unsigned long long ones, double rest, double mass,
            cudaStream_t stream) {
  constexpr int kSpan = kSpanBytes / (7 * static_cast<int>(sizeof(T)));
  const int64_t spans = (n + kSpan - 1) / kSpan;
  particle_push_kernel<T, kFull><<<static_cast<unsigned>(batch * spans), kThreads, 0, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), n_entries, static_cast<const T*>(params),
      static_cast<const T*>(consts), static_cast<const T*>(energy),
      static_cast<const T*>(particles), static_cast<T*>(out), batch, n, spans, zeros, ones,
      static_cast<T>(rest), static_cast<T>(mass));
}

template <typename T>
void launch(int full, const void* tape, int n_entries, const void* params, const void* consts,
            const void* energy, const void* particles, void* out, long long batch, long long n,
            unsigned long long zeros, unsigned long long ones, double rest, double mass,
            cudaStream_t stream) {
  if (full) {
    launch<T, true>(tape, n_entries, params, consts, energy, particles, out, batch, n, zeros,
                    ones, rest, mass, stream);
  } else {
    launch<T, false>(tape, n_entries, params, consts, energy, particles, out, batch, n, zeros,
                     ones, rest, mass, stream);
  }
}

}  // namespace

extern "C" {

// tape: (n_entries, 5) int32, B3's; params: (P, batch); consts: (n_consts,
// 49); energy: (batch,); particles, out: (batch, n, 7); all float (is_double
// = 0) or double (is_double = 1), contiguous.  full: 1 if the tape holds a
// kind from kFirstFullKind on.  Bit 7 i + j of zeros (ones) is set where cell
// (i, j) of the composed map is a structural zero (one).  rest, mass: the
// electron rest energy (m_e c^2 / e) and the CODATA electron mass, in eV.
// Returns cudaGetLastError().
int lynx_particle_push(int is_double, int full, const void* tape, int n_entries,
                       const void* params, const void* consts, const void* energy,
                       const void* particles, void* out, long long batch, long long n,
                       unsigned long long zeros, unsigned long long ones, double rest,
                       double mass, void* stream) {
  if (batch > 0 && n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(full, tape, n_entries, params, consts, energy, particles, out, batch, n,
                     zeros, ones, rest, mass, s);
    } else {
      launch<float>(full, tape, n_entries, params, consts, energy, particles, out, batch, n,
                    zeros, ones, rest, mass, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

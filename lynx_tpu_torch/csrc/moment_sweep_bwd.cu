// Backward of the fused moment sweep (kernel B4) for Hopper, sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_bwd_kernel
// (launched by _fused_moment_sweep_bwd_impl): the vector-Jacobian product
// of kernel B3.  B3 carries each setting's beam through the tape, mu_{i+1} =
// R_i mu_i and Sigma_{i+1} = R_i Sigma_i R_i^T; with the cotangents g, G of
// mu_{i+1}, Sigma_{i+1}, autograd's VJP of that step is
//
//   dR_i = g mu_i^T + (G + G^T) R_i Sigma_i      (Sigma_i symmetric)
//   g   <- R_i^T g,   G <- R_i^T G R_i,
//
// and an input p of the entry's builder takes <dR_i, dR_i/dp>.  The kernel
// gets dR_i/dp by evaluating the builder in forward-mode dual numbers,
// seeded on p (fused_builders.cuh); a const entry's cells and a custom map's
// are inputs themselves, their cotangents dR_i's cells.  d_mu is g after
// the first entry; d_cov is T^T dcov T, T = R_{E-1} .. R_0 composed in the
// forward pass, as autograd forms it through B3's composed map (G pulled
// back entry by entry gathers ~40 times more rounding on the full
// lattice's 96-entry plan).
//
// What bounds it on an H100.  Per setting it reads its parameters and its
// moments and their cotangents (112 values), and writes the cotangents asked
// for: ~0.5 KB a setting in f32 on path T's tape.  The state entering each
// entry that has an input to differentiate (mu_i and Sigma_i's upper
// triangle, 35 values) goes to a device workspace and comes back: 50 states
// a setting on the full tuner's tape, 1.4 GB at B = 100,000, >= 0.42 ms at
// 3.35 TB/s.  The arithmetic, counted on the maps' structural supports, is
// ~1.5k FMAs a setting per dynamic entry (the forward step, dR_i, the pull
// back and one dual pass) and ~0.4k per const entry, plus the builders'
// transcendentals; one thread holds ~250 values, so registers (255, 8 warps
// an SM) and the spills past them bound it more than the FMA rate.
//
// The previous design ran a team of 8 lanes per setting that passed 7x7
// matrices through shared memory: every product read the other operand's
// whole rows (14 16-byte loads for 49 FMAs), which took a warp's share of
// its SM's shared-memory pipe for ~224 cycles an entry, and every lane
// evaluated each builder, once for its value and once per input of the
// entry, whether autograd asked for it or not.  Its prefix products capped
// the block at 32 settings and walked long tapes twice.
//
// Design: one thread per setting, 64 settings a block.  The map R_i, the
// beam's state and the cotangents stay in registers; every product runs on
// the maps' compile-time supports (a drift's pull-back costs a few dozen
// FMAs, a quadrupole's a few hundred), so structural zeros and ones cost
// nothing.  The forward pass rebuilds each map and writes the state entering
// each entry that needs one to the workspace, laid out (slots, 35, B) with
// the settings innermost so that a warp's stores and loads are contiguous;
// where d_cov is asked for it also composes T in the thread's own cells of
// the block's staging buffer.  The reverse pass rebuilds each map again,
// reads its state back, forms dR_i on the map's support into the thread's
// staging cells (not registers: they would spill), pulls the cotangents
// back, and runs one dual pass per input asked for.  The wrapper passes a
// mask (EntryWants): which of each entry's inputs and whether the energy
// want a cotangent, built from autograd's needs_input_grad, so a tuner that
// tunes one field of an element runs one dual pass for it, and an entry with
// nothing asked for needs no state and no dR_i.  Any tape length works: the
// workspace grows with the entries that need a state, not with shared
// memory.  The block stages its settings' moments and cotangents through
// shared memory in contiguous 16-byte vectors, as B3 does; a ragged last
// block's missing settings only reach the barriers.  Sums of a product run j
// ascending, as a dense product's; the values differ from autograd's through
// the composed map only in rounding order.  dR_i's cells, their contractions
// and the energy's sum are formed in double: where the beam's offset term
// g mu^T and its spread's term nearly cancel (the energy's cotangent on some
// settings), float sums lost the difference (on the host at B = 100,000 the
// float energy cotangent's worst error fell 2.5 times).  Templated on float
// and double (double need not be fast: it spills) and on kFull, the full
// lattice's builders, for a tape that holds one of its kinds.

#include "fused_builders.cuh"

namespace {

constexpr int kSettings = 64;  // settings (threads) per block
constexpr int kState = 35;     // mu and the upper triangle of Sigma

template <typename T> struct Vector16;
template <> struct Vector16<float> { using type = float4; };
template <> struct Vector16<double> { using type = double2; };

// Per entry: which of its inputs want a cotangent.  Bit k of (hi, lo) is its
// value k (a dynamic entry's parameter, a custom map's cell) or, for a const
// entry, cell k of its 49; a dynamic entry's bit n (n its parameters) is the
// energy.  row is its first output row (of d_params, or of d_consts for a
// const entry); slot is its state's place in the workspace, -1 for none.
struct EntryWants {
  unsigned lo;
  unsigned hi;
  int row;
  int slot;
};

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

#ifndef LYNX_HOST_STAND_IN
__device__ __forceinline__ int lynx_popcount(uint64_t x) { return __popcll(x); }
#endif

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Row i of a map with support S and ones O is the identity's row.
__host__ __device__ constexpr bool identity_row(uint64_t S, uint64_t O, int i) {
  return ((S >> (i * 7)) & 0x7full) == (1ull << i) && lynx::has(O, i, i);
}

// Column k of such a map is the identity's column.
__host__ __device__ constexpr bool identity_column(uint64_t S, uint64_t O, int k) {
  for (int i = 0; i < 7; ++i) {
    if (lynx::has(S, i, k) != (i == k)) return false;
  }
  return lynx::has(O, k, k);
}

// Column c of P = R s over R's support (s dense), summed in A: a row of R
// that is the identity's copies s's cell.
template <uint64_t S, uint64_t O, typename A, typename T>
__device__ __forceinline__ void state_column(const T* R, const T* s, int c, A* column) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (identity_row(S, O, i)) {
      column[i] = s[i * 7 + c];
      continue;
    }
    A acc = A(0);
    bool started = false;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (!lynx::has(S, i, j)) continue;
      lynx::add_term(acc, started,
                     lynx::has(O, i, j) ? A(s[j * 7 + c]) : A(R[i * 7 + j]) * s[j * 7 + c]);
    }
    column[i] = acc;
  }
}

// One step of the beam: m <- R m, s <- R s R^T, s symmetric (its upper
// triangle formed, then mirrored).
template <uint64_t S, uint64_t O, typename T>
__device__ __forceinline__ void advance(const T* R, T* m, T* s) {
  T x[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) x[j] = m[j];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (identity_row(S, O, i)) continue;
    T acc = T(0);
    bool started = false;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (!lynx::has(S, i, j)) continue;
      lynx::add_term(acc, started, lynx::has(O, i, j) ? x[j] : R[i * 7 + j] * x[j]);
    }
    m[i] = acc;
  }
  T P[49];  // R s
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    T column[7];
    state_column<S, O, T>(R, s, c, column);
#pragma unroll
    for (int i = 0; i < 7; ++i) P[i * 7 + c] = column[i];
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int l = i; l < 7; ++l) {
      T value;
      if (identity_row(S, O, l)) {
        value = P[i * 7 + l];
      } else {
        T acc = T(0);
        bool started = false;
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          if (!lynx::has(S, l, k)) continue;
          lynx::add_term(acc, started,
                         lynx::has(O, l, k) ? P[i * 7 + k] : P[i * 7 + k] * R[l * 7 + k]);
        }
        value = acc;
      }
      s[i * 7 + l] = value;
      s[l * 7 + i] = value;
    }
  }
}

// The cotangents through one map: g <- R^T g, G <- R^T G R.
template <uint64_t S, uint64_t O, typename T>
__device__ __forceinline__ void pull_back(const T* R, T* g, T* G) {
  T x[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) x[i] = g[i];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    if (identity_column(S, O, j)) continue;
    T acc = T(0);
    bool started = false;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      if (!lynx::has(S, i, j)) continue;
      lynx::add_term(acc, started, lynx::has(O, i, j) ? x[i] : R[i * 7 + j] * x[i]);
    }
    g[j] = acc;
  }
  T Q[49];  // G R
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (identity_column(S, O, k)) {
        Q[i * 7 + k] = G[i * 7 + k];
        continue;
      }
      T acc = T(0);
      bool started = false;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        if (!lynx::has(S, j, k)) continue;
        lynx::add_term(acc, started,
                       lynx::has(O, j, k) ? G[i * 7 + j] : G[i * 7 + j] * R[j * 7 + k]);
      }
      Q[i * 7 + k] = acc;
    }
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (identity_column(S, O, j)) {
        G[j * 7 + k] = Q[j * 7 + k];
        continue;
      }
      T acc = T(0);
      bool started = false;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        if (!lynx::has(S, i, j)) continue;
        lynx::add_term(acc, started,
                       lynx::has(O, i, j) ? Q[i * 7 + k] : R[i * 7 + j] * Q[i * 7 + k]);
      }
      G[j * 7 + k] = acc;
    }
  }
}

// A kernel's read-only operands and one thread's setting.
template <typename T>
struct Walk {
  const T* __restrict__ params;
  const T* __restrict__ consts;
  T* __restrict__ states;
  T* __restrict__ d_params;
  T* __restrict__ d_consts;
  int64_t batch;
  int64_t b;
  T energy;
  T rest;
  T mass;
};

// The state entering an entry, to its slot of the workspace and back:
// value v of setting b at states[(slot * kState + v) * batch + b].
template <typename T>
__device__ __forceinline__ void store_state(const Walk<T>& w, int slot, const T* m, const T* s) {
  T* out = w.states + static_cast<int64_t>(slot) * kState * w.batch + w.b;
#pragma unroll
  for (int j = 0; j < 7; ++j) out[j * w.batch] = m[j];
  int v = 7;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int l = i; l < 7; ++l) out[(v++) * w.batch] = s[i * 7 + l];
  }
}

template <typename T>
__device__ __forceinline__ void load_state(const Walk<T>& w, int slot, T* m, T* s) {
  const T* in = w.states + static_cast<int64_t>(slot) * kState * w.batch + w.b;
#pragma unroll
  for (int j = 0; j < 7; ++j) m[j] = in[j * w.batch];
  int v = 7;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int l = i; l < 7; ++l) {
      s[i * 7 + l] = in[(v++) * w.batch];
      s[l * 7 + i] = s[i * 7 + l];
    }
  }
}

// Builds the map of a (non-identity) entry for this setting and calls
// visit.template run<kKind, S, O>(R, p): its kind, support and ones as
// compile-time values, its map and (a dynamic entry's) parameters.  The
// builders are fused_builders.cuh's, as B3's compose_entry calls them.
template <bool kFull, typename T, typename Visit>
__device__ __forceinline__ void visit_map(const Walk<T>& w, const lynx::TapeEntry& entry,
                                          Visit& visit) {
  using namespace lynx;
  constexpr int kP = kFull ? kMaxParams : 5;
  T R[49];
  T p[kP];
  if (entry.kind == kConst) {
    const T* cells = w.consts + static_cast<int64_t>(entry.offset) * 49;
#pragma unroll
    for (int c = 0; c < 49; ++c) R[c] = cells[c];  // loads of cells off the support are dead
    if (entry.support == kDriftConst) {
      visit.template run<kConst, kDriftCells, kIdentityCells>(R, p);
    } else if (entry.support == kKickedDriftConst) {
      visit.template run<kConst, kDriftCells | kKickCells, kIdentityCells>(R, p);
    } else {
      visit.template run<kConst, kAllCells, 0>(R, p);
    }
    return;
  }
  if (kFull && entry.kind == kCustom) {
#pragma unroll
    for (int c = 0; c < 49; ++c) R[c] = w.params[(entry.offset + c) * w.batch + w.b];
    visit.template run<kCustom, kAllCells, 0>(R, p);
    return;
  }
  const int n = tape_params<kFull>(entry.kind);
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    p[k] = k < n ? w.params[(entry.offset + k) * w.batch + w.b] : T(0);
  }
  if (entry.kind == kQuad) {
    build_quadrupole<T>(p, w.energy, w.rest, R);
    visit.template run<kQuad, kQuadCells, kQuadOnes>(R, p);
    return;
  }
  if constexpr (kFull) {
    if (entry.kind == kCavity) {
      build_cavity<T>(p, w.energy, w.rest, w.mass, R);
      visit.template run<kCavity, kCavityCells, kLastOne>(R, p);
      return;
    }
    if (entry.kind == kSolenoid) {
      build_solenoid<T>(p, w.energy, w.rest, R);
      visit.template run<kSolenoid, kSolenoidCells, kSolenoidOnes>(R, p);
      return;
    }
    if (entry.kind == kDipole) {
      build_dipole<T>(p, w.energy, w.rest, R);
      visit.template run<kDipole, kDipoleCells, kDipoleOnes>(R, p);
      return;
    }
    if (entry.kind == kUndulator) {
      build_dynamic<kFull, T, T>(kUndulator, p, w.energy, w.rest, w.mass, R);
      visit.template run<kUndulator, kDriftCells, kIdentityCells>(R, p);
      return;
    }
  }
  if (entry.kind == kDrift) {
    build_dynamic<kFull, T, T>(kDrift, p, w.energy, w.rest, w.mass, R);
    visit.template run<kDrift, kDriftCells, kIdentityCells>(R, p);
  } else if (entry.kind == kHCor) {
    build_dynamic<kFull, T, T>(kHCor, p, w.energy, w.rest, w.mass, R);
    visit.template run<kHCor, kHCorCells, kIdentityCells>(R, p);
  } else {
    build_dynamic<kFull, T, T>(kVCor, p, w.energy, w.rest, w.mass, R);
    visit.template run<kVCor, kVCorCells, kIdentityCells>(R, p);
  }
}

// The forward pass's step: the beam through the entry's map (while a later
// entry needs a state), and the map onto the total T (where the moments'
// cotangents are asked for).
template <typename T>
struct Advance {
  T* m;
  T* s;
  T* total;
  bool beam;
  bool compose;
  template <int kKind, uint64_t S, uint64_t O>
  __device__ __forceinline__ void run(const T* R, const T*) {
    if (beam) advance<S, O>(R, m, s);
    if (compose) lynx::compose_support<S, O>(R, total);
  }
};

// The reverse pass's step: the cotangents of the entry's inputs asked for,
// then g and G pulled back through its map.
template <bool kFull, typename T>
struct Reverse {
  const Walk<T>& w;
  uint64_t want;
  int row;
  int slot;
  T* g;
  T* G;
  double& d_energy;
  T* dR;  // dR's cells: this thread's cells of the staging buffer, not registers

  // dR's cell (r, c) from the entry's state m and column c of P, with
  // H = G + G^T formed as it is read.
  __device__ __forceinline__ T cotangent_cell(const T* m, const double* P, int r, int c) {
    double acc = double(g[r]) * m[c];
#pragma unroll
    for (int k = 0; k < 7; ++k) acc = acc + (double(G[r * 7 + k]) + G[k * 7 + r]) * P[k];
    return T(acc);
  }

  template <int kKind, uint64_t S, uint64_t O>
  __device__ __forceinline__ void run(const T* R, const T* p) {
    using namespace lynx;
    constexpr bool kCells = kKind == kConst || kKind == kCustom;  // inputs are dR's cells
    constexpr uint64_t kDerived = S & ~O;  // cells that depend on the builder's inputs
    if (want != 0) {  // uniform over the block: the mask is the entry's
      // dR column by column, its sums in double: where the beam's offset
      // term g mu^T and its spread's H R Sigma nearly cancel, float sums
      // would lose the difference.
      T m[7], s[49];
      load_state(w, slot, m, s);
      T* out = kKind == kConst ? w.d_consts : w.d_params;
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        constexpr uint64_t kColumn = 0x40810204081ull;  // the cells of column 0
        const uint64_t cells = (kCells ? want : kDerived) & (kColumn << c);
        if (cells == 0) continue;
        double P[7];
        state_column<S, O, double>(R, s, c, P);
#pragma unroll
        for (int r = 0; r < 7; ++r) {
          if constexpr (kCells) {
            if ((want >> (r * 7 + c)) & 1ull) {
              // Output rows follow the cells' order: the cells asked for
              // before this one, counted.
              const int before = lynx_popcount(want & ((1ull << (r * 7 + c)) - 1));
              out[static_cast<int64_t>(row + before) * w.batch + w.b] =
                  cotangent_cell(m, P, r, c);
            }
          } else {
            if ((kDerived >> (r * 7 + c)) & 1ull) dR[r * 7 + c] = cotangent_cell(m, P, r, c);
          }
        }
      }
    }
    pull_back<S, O>(R, g, G);
    if constexpr (!kCells) {
      if (want == 0) return;
      // One dual pass per input asked for, seeded on it: <dR, dR/dp>.
      constexpr int kP = kFull ? kMaxParams : 5;
      const int n = tape_params<kFull>(kKind);
      int q = row;
#pragma unroll 1
      for (int k = 0; k <= n; ++k) {
        if (!((want >> k) & 1ull)) continue;
        Dual<T> pd[kP];
#pragma unroll
        for (int j = 0; j < kP; ++j) pd[j] = Dual<T>(p[j], j == k ? T(1) : T(0));
        const Dual<T> ed(w.energy, k == n ? T(1) : T(0));
        Dual<T> Rd[49];
        build_dynamic<kFull, T, Dual<T>>(kKind, pd, ed, w.rest, w.mass, Rd);
        double acc = 0.0;
        bool started = false;
#pragma unroll
        for (int c = 0; c < 49; ++c) {
          if ((kDerived >> c) & 1ull) add_term(acc, started, double(dR[c]) * Rd[c].d);
        }
        if (k < n) {
          w.d_params[static_cast<int64_t>(q) * w.batch + w.b] = T(acc);
          ++q;
        } else {
          d_energy = d_energy + acc;
        }
      }
    }
  }
};

template <typename T, bool kFull>
__global__ void __launch_bounds__(kSettings) moment_sweep_bwd_kernel(
    const lynx::TapeEntry* __restrict__ tape, const EntryWants* __restrict__ wants, int n_entries,
    int n_forward, T* __restrict__ states, T* __restrict__ totals, const T* __restrict__ params,
    const T* __restrict__ consts, const T* __restrict__ energy, const T* __restrict__ mu,
    const T* __restrict__ cov, const T* __restrict__ dmu, const T* __restrict__ dcov,
    T* __restrict__ d_params, T* __restrict__ d_consts, T* __restrict__ d_energy,
    T* __restrict__ d_mu, T* __restrict__ d_cov, int64_t batch, T rest, T mass) {
  __shared__ __align__(16) T s_mat[kSettings * 49];
  __shared__ __align__(16) T s_vec[kSettings * 7];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSettings;
  const int count = batch - first < kSettings ? static_cast<int>(batch - first) : kSettings;
  // A full block whose tensors start on 16 bytes moves as vectors (a block
  // starts 64 * 49 values further on); anything else value by value.
  const bool vectors = count == kSettings && aligned16(mu) && aligned16(cov) && aligned16(dmu) &&
                       aligned16(dcov) && aligned16(d_mu) && aligned16(d_cov);
  const int t = threadIdx.x;
  const bool active = t < count;  // the others only reach the barriers
  const Walk<T> w{params, consts, states, d_params, d_consts, batch, first + t,
                  active ? energy[first + t] : T(0), rest, mass};

  // Forward pass: the state entering each entry with a slot, to the
  // workspace (past the last such entry the state is not needed); with
  // totals, T = R_{E-1} .. R_0 composed over the whole tape, to totals.
  const int walk = totals != nullptr ? n_entries : n_forward;
  if (walk > 0) {
    copy_block(cov + first * 49, s_mat, count * 49, vectors);
    copy_block(mu + first * 7, s_vec, count * 7, vectors);
    __syncthreads();
    if (active) {
      T m[7], s[49];
#pragma unroll
      for (int j = 0; j < 7; ++j) m[j] = s_vec[t * 7 + j];
#pragma unroll
      for (int i = 0; i < 7; ++i) {
#pragma unroll
        for (int l = i; l < 7; ++l) {
          s[i * 7 + l] = s_mat[t * 49 + i * 7 + l];
          s[l * 7 + i] = s[i * 7 + l];
        }
      }
      // T is composed in this thread's own cells of the staging buffer (its
      // cov is in registers now), column by column: no registers held.
      T* const total = s_mat + t * 49;
      lynx::set_identity(total);
      Advance<T> step{m, s, total, false, totals != nullptr};
      for (int e = 0; e < walk; ++e) {
        const lynx::TapeEntry entry = tape[e];  // by value: a copy in registers
        const int slot = e < n_forward ? wants[e].slot : -1;
        if (slot >= 0) store_state(w, slot, m, s);
        step.beam = e + 1 < n_forward;
        if ((step.beam || step.compose) && entry.kind != lynx::kIdentity) {
          visit_map<kFull>(w, entry, step);
        }
      }
      if (totals != nullptr) {
#pragma unroll
        for (int c = 0; c < 49; ++c) totals[c * batch + w.b] = total[c];
      }
    }
    __syncthreads();  // the buffers take the cotangents next
  }

  // Reverse pass from the moments' cotangents.
  copy_block(dcov + first * 49, s_mat, count * 49, vectors);
  copy_block(dmu + first * 7, s_vec, count * 7, vectors);
  __syncthreads();
  T g[7], G[49];
#pragma unroll
  for (int j = 0; j < 7; ++j) g[j] = s_vec[t * 7 + j];
#pragma unroll
  for (int c = 0; c < 49; ++c) G[c] = s_mat[t * 49 + c];
  double d_e = 0.0;
  if (active) {
    for (int e = n_entries - 1; e >= 0; --e) {
      const lynx::TapeEntry entry = tape[e];
      if (entry.kind == lynx::kIdentity) continue;
      const EntryWants wt = wants[e];
      const uint64_t want = (static_cast<uint64_t>(wt.hi) << 32) | wt.lo;
      Reverse<kFull, T> step{w, want, wt.row, wt.slot, g, G, d_e, s_mat + t * 49};
      visit_map<kFull>(w, entry, step);
    }
    if (d_energy != nullptr) d_energy[w.b] = T(d_e);
    if (d_cov != nullptr && n_entries > 0) {  // without entries T = I: d_cov = dcov
      // d_cov = T^T dcov T from the composed total (see the note above).
      T total[49];
#pragma unroll
      for (int c = 0; c < 49; ++c) total[c] = totals[c * batch + w.b];
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        T x[7];  // column k of dcov T
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          const T* row = dcov + w.b * 49 + i * 7;
          T acc = row[0] * total[k];
#pragma unroll
          for (int j = 1; j < 7; ++j) acc = acc + row[j] * total[j * 7 + k];
          x[i] = acc;
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          T acc = total[j] * x[0];
#pragma unroll
          for (int i = 1; i < 7; ++i) acc = acc + total[i * 7 + j] * x[i];
          G[j * 7 + k] = acc;
        }
      }
    }
  }
  if (d_mu == nullptr && d_cov == nullptr) return;  // uniform: no barrier follows
  __syncthreads();  // every thread has read its cotangents
#pragma unroll
  for (int j = 0; j < 7; ++j) s_vec[t * 7 + j] = g[j];
#pragma unroll
  for (int c = 0; c < 49; ++c) s_mat[t * 49 + c] = G[c];
  __syncthreads();
  if (d_cov != nullptr) copy_block(s_mat, d_cov + first * 49, count * 49, vectors);
  if (d_mu != nullptr) copy_block(s_vec, d_mu + first * 7, count * 7, vectors);
}

template <typename T, bool kFull>
int launch(const void* tape, const void* wants, int n_entries, int n_forward, void* states,
           void* totals, const void* params, const void* consts, const void* energy, const void* mu,
           const void* cov, const void* dmu, const void* dcov, void* d_params, void* d_consts,
           void* d_energy, void* d_mu, void* d_cov, long long batch, double rest, double mass,
           cudaStream_t stream) {
  const int64_t blocks = (batch + kSettings - 1) / kSettings;
  moment_sweep_bwd_kernel<T, kFull><<<static_cast<unsigned>(blocks), kSettings, 0, stream>>>(
      static_cast<const lynx::TapeEntry*>(tape), static_cast<const EntryWants*>(wants), n_entries,
      n_forward, static_cast<T*>(states), static_cast<T*>(totals), static_cast<const T*>(params),
      static_cast<const T*>(consts), static_cast<const T*>(energy), static_cast<const T*>(mu),
      static_cast<const T*>(cov), static_cast<const T*>(dmu), static_cast<const T*>(dcov),
      static_cast<T*>(d_params), static_cast<T*>(d_consts), static_cast<T*>(d_energy),
      static_cast<T*>(d_mu), static_cast<T*>(d_cov), batch, static_cast<T>(rest),
      static_cast<T>(mass));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int full, const void* tape, const void* wants, int n_entries, int n_forward,
           void* states, void* totals, const void* params, const void* consts, const void* energy,
           const void* mu, const void* cov, const void* dmu, const void* dcov, void* d_params,
           void* d_consts, void* d_energy, void* d_mu, void* d_cov, long long batch, double rest,
           double mass, cudaStream_t stream) {
  auto run = [&](auto kernel_launch) {
    return kernel_launch(tape, wants, n_entries, n_forward, states, totals, params, consts, energy,
                         mu, cov, dmu, dcov, d_params, d_consts, d_energy, d_mu, d_cov, batch,
                         rest, mass, stream);
  };
  return full ? run(launch<T, true>) : run(launch<T, false>);
}

}  // namespace

extern "C" {

// Settings per block: the tests hold a batch against it.
int lynx_moment_sweep_bwd_block() { return kSettings; }

// Values of a state in the workspace: mu and the upper triangle of Sigma.
int lynx_moment_sweep_bwd_state() { return kState; }

// tape: (n_entries, 5) int32; wants: (n_entries, 4) int32, EntryWants;
// n_forward: the entries the forward pass walks (through the last with a
// slot; 0 for none); states: (slots, kState, batch) scratch, or null without
// slots; totals: (49, batch) scratch for the composed map where d_cov is
// asked for, else null; params: (P, batch); consts: (n_consts, 49); energy: (batch,); mu,
// dmu: (batch, 7); cov, dcov: (batch, 7, 7), cov symmetric (only its upper
// triangle is read); d_params: (rows, batch), the dynamic values and custom
// cells asked for; d_consts: (rows, batch), the const cells asked for (the
// caller sums them over the batch); d_energy (batch,), d_mu (batch, 7) and
// d_cov (batch, 7, 7) each null where not asked for.  All float (is_double =
// 0) or double (is_double = 1), contiguous.  full: 1 if the tape holds a
// kind from kFirstFullKind on.  rest, mass: the electron rest energy (m_e
// c^2 / e) and the CODATA electron mass, in eV.  Returns cudaGetLastError().
int lynx_moment_sweep_bwd(int is_double, int full, const void* tape, const void* wants,
                          int n_entries, int n_forward, void* states, void* totals,
                          const void* params,
                          const void* consts, const void* energy, const void* mu, const void* cov,
                          const void* dmu, const void* dcov, void* d_params, void* d_consts,
                          void* d_energy, void* d_mu, void* d_cov, long long batch, double rest,
                          double mass, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(full, tape, wants, n_entries, n_forward, states, totals, params, consts,
                          energy, mu, cov, dmu, dcov, d_params, d_consts, d_energy, d_mu, d_cov,
                          batch, rest, mass, s);
  }
  return launch<float>(full, tape, wants, n_entries, n_forward, states, totals, params, consts,
                       energy, mu, cov, dmu, dcov, d_params, d_consts, d_energy, d_mu, d_cov, batch,
                       rest, mass, s);
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

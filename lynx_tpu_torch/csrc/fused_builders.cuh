// Shared device code of the fused moment sweep (kernels B3 and B4): the op
// tape, dense 7x7 algebra, and one device builder per element type.
//
// Each builder repeats its PyTorch counterpart op for op
// (lynx_tpu_torch/accelerator/fused.py over ops/rmatrix.py, the same
// formulas as the JAX package's lynx_tpu/accelerator/fused.py): the
// additive k1 + 1e-12 at k1 == 0, _cos_sinc's small-argument series below
// 0.1 and exp forms above, the tilt sandwich, the misalignment entry/exit
// and the corrector's kick row.  A builder's products skip its factors'
// structural zeros and ones (matmul7_support); the kernels compose the
// entries' maps densely, where a structural zero contributes an exact 0 and
// a structural one an exact product, so the values are those of the sparse
// table algebra up to rounding order.
//
// Builders are templates over their scalar type S, either the value type T
// (float or double) or Dual<T>, a forward-mode dual number.  B4 evaluates
// a builder in Dual<T> once per input, seeded on that input, to get dR/dp;
// this is the chain rule that jax.vjp applies to the same ops, with no
// hand-derived derivative formulas.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace lynx {

// Tape kinds; lynx_tpu_torch/ops/fused_track.py has the same codes.
enum TapeKind : int {
  kConst = 0,
  kDrift = 1,
  kQuad = 2,
  kHCor = 3,
  kVCor = 4,
  kIdentity = 5,
};

// One plan entry: a dynamic entry's parameters are rows offset.. of the
// (P, B) parameter tensor; a const entry's dense 49 cells are row offset of
// the (n_consts, 49) const tensor, and its cell_count non-literal cells sit
// at cell_pos[cell_start ..] of the 49.
struct TapeEntry {
  int kind;
  int offset;
  int cell_start;
  int cell_count;
};

__host__ __device__ constexpr int tape_params(int kind) {
  return kind == kDrift ? 1 : kind == kQuad ? 5 : (kind == kHCor || kind == kVCor) ? 2 : 0;
}

// -- scalars -------------------------------------------------------------

template <typename T>
struct Dual {
  T v;  // value
  T d;  // derivative along the seeded input
  __device__ Dual() : v(T(0)), d(T(0)) {}
  __device__ Dual(T value) : v(value), d(T(0)) {}  // NOLINT: a constant
  __device__ Dual(T value, T tangent) : v(value), d(tangent) {}
};

template <typename T> __device__ __forceinline__ T value_of(T x) { return x; }
template <typename T> __device__ __forceinline__ T value_of(Dual<T> x) { return x.v; }

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  return {q, -q * b.d / b.v};
}

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }

template <typename T>
__device__ __forceinline__ Dual<T> sqrt_(Dual<T> a) {
  const T s = sqrt_(a.v);
  return {s, a.d / (T(2) * s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> abs_(Dual<T> a) {
  // sign(x) * dx, with sign(0) = 0, as jax.numpy.abs differentiates.
  return {abs_(a.v), a.v > T(0) ? a.d : (a.v < T(0) ? -a.d : T(0))};
}
template <typename T>
__device__ __forceinline__ Dual<T> exp_(Dual<T> a) {
  const T e = exp_(a.v);
  return {e, e * a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> cos_(Dual<T> a) { return {cos_(a.v), -sin_(a.v) * a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> sin_(Dual<T> a) { return {sin_(a.v), cos_(a.v) * a.d}; }

// -- dense 7x7 algebra (row-major, 49 cells) -------------------------------

template <typename S>
__device__ __forceinline__ void set_identity(S* R) {
#pragma unroll
  for (int c = 0; c < 49; ++c) R[c] = S(c % 8 == 0 ? 1 : 0);
}

// out = A @ B (out must not alias A or B).
template <typename S>
__device__ __forceinline__ void matmul7(const S* A, const S* B, S* out) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      S acc = A[i * 7] * B[k];
#pragma unroll
      for (int j = 1; j < 7; ++j) acc = acc + A[i * 7 + j] * B[j * 7 + k];
      out[i * 7 + k] = acc;
    }
  }
}

// R <- L @ R, through a temporary.
template <typename S>
__device__ __forceinline__ void left_multiply(const S* L, S* R) {
  S tmp[49];
  matmul7(L, R, tmp);
#pragma unroll
  for (int c = 0; c < 49; ++c) R[c] = tmp[c];
}

// -- builders (ops/rmatrix.py, accelerator/fused.py) -----------------------

// igamma2_from_energy: 1/gamma^2, zero_value where E == 0.
template <typename T, typename S>
__device__ __forceinline__ S igamma2_from_energy(S energy, T rest, T zero_value) {
  const S gamma = energy / rest;
  if (value_of(gamma) == T(0)) return S(zero_value);
  return T(1) / (gamma * gamma);
}

// _safe_div: num / den, fallback where den == 0.
template <typename T, typename S>
__device__ __forceinline__ S safe_div(S num, S den, S fallback) {
  if (value_of(den) == T(0)) return fallback;
  return num / den;
}

// _cos_sinc: (cos(k L), sin(k L)/k) for k = sqrt(k2), k2 of any sign.
template <typename T, typename S>
__device__ __forceinline__ void cos_sinc(S k2, S length, S* c, S* s_over_k) {
  const S abs_k = sqrt_(abs_(k2));
  const S arg = abs_k * length;
  if (value_of(k2) >= T(0)) {
    *c = cos_(arg);
    *s_over_k = safe_div<T>(sin_(arg), abs_k, length);
    return;
  }
  const S x2 = arg * arg;
  if (value_of(arg) < T(0.1)) {
    *c = T(1) + x2 * (T(0.5) + x2 * (T(1.0 / 24.0) + x2 / T(720)));
    *s_over_k = length * (T(1) + x2 * (T(1.0 / 6.0) + x2 * (T(1.0 / 120.0) + x2 / T(5040))));
    return;
  }
  const S exp_pos = exp_(arg);
  const S exp_neg = exp_(-arg);
  *c = T(0.5) * (exp_pos + exp_neg);
  *s_over_k = safe_div<T>(T(0.5) * (exp_pos - exp_neg), abs_k, length);
}

// drift_rmatrix_entries into an identity R.
template <typename T, typename S>
__device__ __forceinline__ void drift_entries(S length, S energy, T rest, S* R) {
  const S igamma2 = igamma2_from_energy<T>(energy, rest, T(0));
  const S beta2 = T(1) - igamma2;
  const S r56 = -length * safe_div<T>(igamma2, beta2, S(T(0)));
  R[0 * 7 + 1] = length;
  R[2 * 7 + 3] = length;
  R[4 * 7 + 5] = r56;
}

// rotation_entries(angle) as a dense map.
template <typename T, typename S>
__device__ __forceinline__ void rotation(S cs, S sn, S* R) {
  set_identity(R);
  R[0 * 7 + 0] = cs;
  R[0 * 7 + 2] = sn;
  R[1 * 7 + 1] = cs;
  R[1 * 7 + 3] = sn;
  R[2 * 7 + 0] = -sn;
  R[2 * 7 + 2] = cs;
  R[3 * 7 + 1] = -sn;
  R[3 * 7 + 3] = cs;
}

// base_rmatrix_entries(length, k1, hx = 0, tilt, energy) of a quadrupole
// with parameters p = (length, k1, tilt, mx, my), into R.
template <typename T, typename S>
__device__ __forceinline__ void quadrupole_base(const S* p, S energy, T rest, S* R) {
  const S length = p[0];
  S k1 = p[1];
  const S hx = S(T(0));

  const S igamma2 = igamma2_from_energy<T>(energy, rest, T(1));
  const S beta = sqrt_(T(1) - igamma2);
  k1 = k1 + (value_of(k1) == T(0) ? T(1e-12) : T(0));
  const S kx2 = k1 + hx * hx;
  const S ky2 = -k1;
  S cx, sx, cy, sy;
  cos_sinc<T>(kx2, length, &cx, &sx);
  cos_sinc<T>(ky2, length, &cy, &sy);
  const S dx = hx / kx2 * (T(1) - cx);
  const bool beta_zero = value_of(beta) == T(0);
  const S inv_beta = beta_zero ? S(T(INFINITY)) : T(1) / beta;
  const S inv_beta2 = inv_beta * inv_beta;
  const S r56 = hx * hx * (length - sx) / kx2 * inv_beta2 - length * inv_beta2 * igamma2;

  set_identity(R);
  R[0 * 7 + 0] = cx;
  R[0 * 7 + 1] = sx;
  R[0 * 7 + 5] = dx * inv_beta;
  R[1 * 7 + 0] = -kx2 * sx;
  R[1 * 7 + 1] = cx;
  R[1 * 7 + 5] = sx * hx * inv_beta;
  R[2 * 7 + 2] = cy;
  R[2 * 7 + 3] = sy;
  R[3 * 7 + 2] = -ky2 * sy;
  R[3 * 7 + 3] = cy;
  R[4 * 7 + 0] = sx * hx * inv_beta;
  R[4 * 7 + 1] = dx * inv_beta;
  R[4 * 7 + 5] = r56;
}

// -- products over structural supports -----------------------------------
//
// A dense product spends most of its multiplies on cells that are zero by
// construction (x * 0.0 is not folded away: it is not 0 for every x).  The
// builders below skip them: a product takes the support of each factor (the
// cells that may be non-zero) and its ones (the cells that are exactly 1) as
// compile-time masks, keeps matmul7's terms in matmul7's order, drops the
// terms with a structural zero and the multiply by a structural one.  For
// finite values that gives the dense product's numbers: a dropped term adds
// an exact zero, a skipped multiply is by an exact one.

// Bit 7 i + j is cell (i, j).
__host__ __device__ constexpr uint64_t cell(int i, int j) { return 1ull << (i * 7 + j); }
constexpr uint64_t kIdentityCells = cell(0, 0) | cell(1, 1) | cell(2, 2) | cell(3, 3) |
                                    cell(4, 4) | cell(5, 5) | cell(6, 6);
__host__ __device__ constexpr bool has(uint64_t mask, int i, int j) {
  return (mask >> (i * 7 + j)) & 1ull;
}

// The support of A @ B.
__host__ __device__ constexpr uint64_t product_support(uint64_t sa, uint64_t sb) {
  uint64_t out = 0;
  for (int i = 0; i < 7; ++i)
    for (int k = 0; k < 7; ++k)
      for (int j = 0; j < 7; ++j)
        if (has(sa, i, j) && has(sb, j, k)) out |= cell(i, k);
  return out;
}

// The cells of A @ B that are exactly 1: a single term, of two ones.
__host__ __device__ constexpr uint64_t product_ones(uint64_t sa, uint64_t oa, uint64_t sb,
                                                   uint64_t ob) {
  uint64_t out = 0;
  for (int i = 0; i < 7; ++i)
    for (int k = 0; k < 7; ++k) {
      int terms = 0;
      bool ones = true;
      for (int j = 0; j < 7; ++j)
        if (has(sa, i, j) && has(sb, j, k)) {
          ++terms;
          ones = ones && has(oa, i, j) && has(ob, j, k);
        }
      if (terms == 1 && ones) out |= cell(i, k);
    }
  return out;
}

// out = A @ B over the supports SA, SB with ones OA, OB (out must not alias
// A or B); cells outside the product's support are exact zeros.
template <uint64_t SA, uint64_t OA, uint64_t SB, uint64_t OB, typename S>
__device__ __forceinline__ void matmul7_support(const S* A, const S* B, S* out) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      S acc = S(0);
      bool started = false;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        if (!has(SA, i, j) || !has(SB, j, k)) continue;
        const S term = has(OA, i, j)   ? B[j * 7 + k]
                       : has(OB, j, k) ? A[i * 7 + j]
                                       : A[i * 7 + j] * B[j * 7 + k];
        acc = started ? acc + term : term;
        started = true;
      }
      out[i * 7 + k] = acc;
    }
  }
}

// _build_quadrupole: exit @ (rot(-tilt) @ (base @ rot(tilt))) @ entry, with
// base = base_rmatrix_entries(length, k1, hx = 0, tilt, energy), through the
// products above; rot(-tilt) from the cosine and sine of tilt.
template <typename T, typename S>
__device__ __forceinline__ void build_quadrupole(const S* p, S energy, T rest, S* R) {
  constexpr uint64_t kBase = kIdentityCells | cell(0, 1) | cell(0, 5) | cell(1, 0) | cell(1, 5) |
                             cell(2, 3) | cell(3, 2) | cell(4, 0) | cell(4, 1) | cell(4, 5);
  constexpr uint64_t kBaseOnes = cell(4, 4) | cell(5, 5) | cell(6, 6);
  constexpr uint64_t kRot = kIdentityCells | cell(0, 2) | cell(1, 3) | cell(2, 0) | cell(3, 1);
  constexpr uint64_t kRotOnes = cell(4, 4) | cell(5, 5) | cell(6, 6);
  constexpr uint64_t kShift = kIdentityCells | cell(0, 6) | cell(2, 6);  // entry and exit
  constexpr uint64_t kShiftOnes = kIdentityCells;
  constexpr uint64_t kTilted = product_support(kBase, kRot);
  constexpr uint64_t kTiltedOnes = product_ones(kBase, kBaseOnes, kRot, kRotOnes);
  constexpr uint64_t kTurned = product_support(kRot, kTilted);
  constexpr uint64_t kTurnedOnes = product_ones(kRot, kRotOnes, kTilted, kTiltedOnes);
  constexpr uint64_t kEntered = product_support(kTurned, kShift);
  constexpr uint64_t kEnteredOnes = product_ones(kTurned, kTurnedOnes, kShift, kShiftOnes);

  const S tilt = p[2], mx = p[3], my = p[4];
  S base[49], M[49], tmp[49];
  quadrupole_base<T>(p, energy, rest, base);
  const S cs = cos_(tilt), sn = sin_(tilt);
  rotation<T>(cs, sn, M);
  matmul7_support<kBase, kBaseOnes, kRot, kRotOnes>(base, M, tmp);  // base @ rot(tilt)
  rotation<T>(cs, -sn, M);  // rot(-tilt): cos and sin are even and odd to the bit
  matmul7_support<kRot, kRotOnes, kTilted, kTiltedOnes>(M, tmp, base);  // rot(-tilt) @ ..
  set_identity(M);  // entry: x -= mx, y -= my
  M[0 * 7 + 6] = -mx;
  M[2 * 7 + 6] = -my;
  matmul7_support<kTurned, kTurnedOnes, kShift, kShiftOnes>(base, M, tmp);
  set_identity(M);  // exit
  M[0 * 7 + 6] = mx;
  M[2 * 7 + 6] = my;
  matmul7_support<kShift, kShiftOnes, kEntered, kEnteredOnes>(M, tmp, R);
}

// The map of a dynamic entry: p holds tape_params(kind) parameters.  Inlined
// into the caller, so that the maps stay in registers.
template <typename T, typename S>
__device__ __forceinline__ void build_dynamic(int kind, const S* p, S energy, T rest, S* R) {
  if (kind == kQuad) {
    build_quadrupole<T>(p, energy, rest, R);
    return;
  }
  set_identity(R);
  if (kind == kIdentity) return;
  drift_entries<T>(p[0], energy, rest, R);  // drift, and the correctors' drift
  // Indices known at compile time, so that R stays in registers.
  if (kind == kHCor) R[1 * 7 + 6] = p[1];
  if (kind == kVCor) R[3 * 7 + 6] = p[1];
}

// The value of entry e's map for setting b.
template <typename T>
__device__ __forceinline__ void build_entry(const TapeEntry& entry, const T* __restrict__ params,
                                            const T* __restrict__ consts, int64_t batch,
                                            int64_t b, T energy, T rest, T* R) {
  if (entry.kind == kConst) {
    const T* cells = consts + static_cast<int64_t>(entry.offset) * 49;
#pragma unroll
    for (int c = 0; c < 49; ++c) R[c] = cells[c];
    return;
  }
  T p[5];
  const int n = tape_params(entry.kind);
  for (int k = 0; k < n; ++k) p[k] = params[(entry.offset + k) * batch + b];
  build_dynamic<T, T>(entry.kind, p, energy, rest, R);
}

}  // namespace lynx

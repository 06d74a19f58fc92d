// Shared device code of the fused moment sweep (kernels B3 and B4) and the
// particle push (kernel B8): the op tape, one device builder per element
// type, the products over structural supports that the builders use, and the
// composition of a tape entry onto a chain (B3's and B8's).
//
// Each builder repeats its PyTorch counterpart op for op
// (lynx_tpu_torch/accelerator/fused.py over ops/rmatrix.py, the same
// formulas as the JAX package's lynx_tpu/accelerator/fused.py): the
// additive k1 + 1e-12 at k1 == 0, _cos_sinc's small-argument series below
// 0.1 and exp forms above, the tilt sandwich, the misalignment entry/exit,
// the corrector's kick row, the inactive cavity's reparametrised map, the
// solenoid's Chao block and the dipole's body, thin branch and edge maps.
// A torch.where of the plain version becomes a branch on the value: only the
// branch taken is evaluated, so the other branch's guards (its division by
// a safe 1) never reach a derivative, as in autograd of the where.  A
// builder's products skip its factors' structural zeros and ones
// (matmul7_support, or in place for the sparse factors of the solenoid and
// the dipole), and so does B3's chain
// (compose_support) over each entry's support (a dynamic entry's from its
// builder, a const entry's from its support class): a structural zero would
// contribute an exact 0 and a structural one an exact product, so the values
// are those of the sparse table algebra up to rounding order.
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
  kCavity = 6,     // an inactive cavity (an active one is not skippable)
  kUndulator = 7,
  kSolenoid = 8,
  kDipole = 9,     // Dipole and RBend
  kCustom = 10,    // a CustomTransferMap: its 49 cells are its parameters
};

// The first kind that only the kernels' full instantiation builds: a tape
// of the older kinds runs an instantiation without the newer builders, whose
// registers it does not pay for.
constexpr int kFirstFullKind = kCavity;
constexpr int kMaxParams = 8;  // a dipole's; a custom map's cells are read like a const entry's

// Support classes of a const entry's map; lynx_tpu_torch/ops/fused_track.py
// has the same codes and masks (_CONST_SUPPORTS).
enum ConstSupport : int {
  kDenseConst = 0,        // any map
  kDriftConst = 1,        // a drift's cells, ones on the diagonal
  kKickedDriftConst = 2,  // and column 6 of rows 0-4 (static correctors among drifts)
};

// One plan entry: a dynamic entry's parameters are rows offset.. of the
// (P, B) parameter tensor; a const entry's dense 49 cells are row offset of
// the (n_consts, 49) const tensor, its cell_count non-literal cells sit at
// cell_pos[cell_start ..] of the 49, and support is its ConstSupport (0 for
// a dynamic entry).
struct TapeEntry {
  int kind;
  int offset;
  int cell_start;
  int cell_count;
  int support;
};

// Parameters of a dynamic entry of `kind`; without kFull only the kinds
// below kFirstFullKind are asked, in fewer compares.
template <bool kFull = true>
__host__ __device__ constexpr int tape_params(int kind) {
  if (!kFull) return kind == kDrift ? 1 : kind == kQuad ? 5 : (kind == kHCor || kind == kVCor) ? 2 : 0;
  return kind == kDrift || kind == kUndulator ? 1
         : kind == kQuad                      ? 5
         : kind == kHCor || kind == kVCor     ? 2
         : kind == kCavity || kind == kSolenoid ? 4
         : kind == kDipole                    ? 8
         : kind == kCustom                    ? 49
                                              : 0;
}

// Besides the rest energy of ops/rmatrix.py (m_e c^2 / e, `rest`), the
// cavity takes the CODATA electron mass (`mass`), both in eV and passed in
// from lynx_tpu_torch.constants.
constexpr double kSpeedOfLight = 299792458.0;  // m/s, exact
constexpr double kPi = 3.14159265358979323846;
constexpr double kDegToRad = 0.017453292519943295769236907684886127134428718885417;  // torch.deg2rad

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
__device__ __forceinline__ float tan_(float x) { return tanf(x); }
__device__ __forceinline__ double tan_(double x) { return tan(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }

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
template <typename T>
__device__ __forceinline__ Dual<T> tan_(Dual<T> a) {
  const T t = tan_(a.v);
  return {t, (T(1) + t * t) * a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> log1p_(Dual<T> a) { return {log1p_(a.v), a.d / (a.v + T(1))}; }

// -- 7x7 maps (row-major, 49 cells) -----------------------------------------

template <typename S>
__device__ __forceinline__ void set_identity(S* R) {
#pragma unroll
  for (int c = 0; c < 49; ++c) R[c] = S(c % 8 == 0 ? 1 : 0);
}

// -- products over structural supports -----------------------------------
//
// A dense product spends most of its multiplies on cells that are zero by
// construction (x * 0.0 is not folded away: it is not 0 for every x).  The
// products below skip them: a product takes the support of each factor (the
// cells that may be non-zero) and its ones (the cells that are exactly 1) as
// compile-time masks, keeps a dense product's terms in its order (j
// ascending in out[i, k] = sum_j A[i, j] B[j, k]), drops the terms with a
// structural zero and the multiply by a structural one.  For finite values
// that gives the dense product's numbers: a dropped term adds an exact zero,
// a skipped multiply is by an exact one.

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

// R <- A @ R for a dense R, over A's support SA with ones OA, column by
// column in place (a new column needs only its old self); rows of A that are
// the identity's are skipped.
template <uint64_t SA, uint64_t OA, typename S>
__device__ __forceinline__ void compose_support(const S* A, S* R) {
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    S column[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) column[j] = R[j * 7 + k];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      if (((SA >> (i * 7)) & 0x7full) == (1ull << i) && has(OA, i, i)) continue;
      S acc = S(0);
      bool started = false;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        if (!has(SA, i, j)) continue;
        const S term = has(OA, i, j) ? column[j] : A[i * 7 + j] * column[j];
        acc = started ? acc + term : term;
        started = true;
      }
      R[i * 7 + k] = acc;
    }
  }
}

// The structural supports and ones of the builders' maps and of the const
// support classes.
constexpr uint64_t kDriftCells = kIdentityCells | cell(0, 1) | cell(2, 3) | cell(4, 5);
constexpr uint64_t kHCorCells = kDriftCells | cell(1, 6);
constexpr uint64_t kVCorCells = kDriftCells | cell(3, 6);
constexpr uint64_t kKickCells = cell(0, 6) | cell(1, 6) | cell(2, 6) | cell(3, 6) | cell(4, 6);
constexpr uint64_t kAllCells = (1ull << 49) - 1;
constexpr uint64_t kQuadBase = kIdentityCells | cell(0, 1) | cell(0, 5) | cell(1, 0) |
                               cell(1, 5) | cell(2, 3) | cell(3, 2) | cell(4, 0) | cell(4, 1) |
                               cell(4, 5);
constexpr uint64_t kQuadBaseOnes = cell(4, 4) | cell(5, 5) | cell(6, 6);
constexpr uint64_t kRot = kIdentityCells | cell(0, 2) | cell(1, 3) | cell(2, 0) | cell(3, 1);
constexpr uint64_t kRotOnes = cell(4, 4) | cell(5, 5) | cell(6, 6);
constexpr uint64_t kShift = kIdentityCells | cell(0, 6) | cell(2, 6);  // entry and exit
constexpr uint64_t kShiftOnes = kIdentityCells;
constexpr uint64_t kTilted = product_support(kQuadBase, kRot);
constexpr uint64_t kTiltedOnes = product_ones(kQuadBase, kQuadBaseOnes, kRot, kRotOnes);
constexpr uint64_t kTurned = product_support(kRot, kTilted);
constexpr uint64_t kTurnedOnes = product_ones(kRot, kRotOnes, kTilted, kTiltedOnes);
constexpr uint64_t kEntered = product_support(kTurned, kShift);
constexpr uint64_t kEnteredOnes = product_ones(kTurned, kTurnedOnes, kShift, kShiftOnes);
constexpr uint64_t kQuadCells = product_support(kShift, kEntered);
constexpr uint64_t kQuadOnes = product_ones(kShift, kShiftOnes, kEntered, kEnteredOnes);

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

// _build_quadrupole: exit @ (rot(-tilt) @ (base @ rot(tilt))) @ entry, with
// base = base_rmatrix_entries(length, k1, hx = 0, tilt, energy), through the
// products above; rot(-tilt) from the cosine and sine of tilt.
template <typename T, typename S>
__device__ __forceinline__ void build_quadrupole(const S* p, S energy, T rest, S* R) {
  const S tilt = p[2], mx = p[3], my = p[4];
  S base[49], M[49], tmp[49];
  quadrupole_base<T>(p, energy, rest, base);
  const S cs = cos_(tilt), sn = sin_(tilt);
  rotation<T>(cs, sn, M);
  matmul7_support<kQuadBase, kQuadBaseOnes, kRot, kRotOnes>(base, M, tmp);  // base @ rot(tilt)
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

// -- the full lattice's kinds (kFirstFullKind on) ---------------------------

// cavity_rmatrix_entries(length, voltage, phase, frequency, energy) of
// p = (length, voltage, phase, frequency), into R.
template <typename T, typename S>
__device__ __forceinline__ void build_cavity(const S* p, S energy, T rest, T mass, S* R) {
  const S length = p[0], voltage = p[1];
  const S phi = p[2] * T(kDegToRad);
  const S cos_phi = cos_(phi), sin_phi = sin_(phi);
  const bool has_beam = value_of(energy) != T(0);
  const S Ei = (has_beam ? energy : S(T(1))) / mass;
  const S Vm = voltage / mass;
  S x = Vm * cos_phi / Ei;
  S Ef = Ei * (T(1) + x);
  const bool valid = has_beam && value_of(Ef) > T(1);
  set_identity(R);
  if (!valid) {  // no beam, or fully decelerated: the drift's map
    const S igamma2 = igamma2_from_energy<T>(energy, rest, T(0));
    const S beta2 = T(1) - igamma2;
    R[0 * 7 + 1] = length;
    R[2 * 7 + 3] = length;
    R[4 * 7 + 5] = -length * safe_div<T>(igamma2, beta2, S(T(0)));
    return;
  }
  const S lx = value_of(x) == T(0) ? S(T(1)) : log1p_(x) / x;  // ln(1 + x) / x
  const S alpha = T(0.3535533905932738) * (Vm / Ei) * lx;       // sqrt(eta / 8)
  const S sin_alpha = sin_(alpha), cos_alpha = cos_(alpha);
  const T sqrt2 = T(1.4142135623730951);                           // sqrt(2 / eta)
  const S r11 = cos_alpha - sqrt2 * cos_phi * sin_alpha;
  const S r12 =
      value_of(Vm) == T(0) ? length : T(2.8284271247461903) * length * (Ei / Vm) * sin_alpha;
  const S r21 = -(Vm / (length * Ef)) * sin_alpha *
                (cos_phi * cos_phi / T(1.4142135623730951) + T(0.3535533905932738));
  const S r22 = Ei / Ef * (cos_alpha + sqrt2 * cos_phi * sin_alpha);
  const S beta0 = sqrt_(T(1) - T(1) / (Ei * Ei));
  const S beta1 = sqrt_(T(1) - T(1) / (Ef * Ef));
  const S k = T(2.0 * kPi) * p[3] / T(kSpeedOfLight);
  const S r56 = -length / (Ef * Ef * Ei * beta1) * (Ef + Ei) / (beta1 + beta0);
  const S gb_sum = Ei * beta0 + Ef * beta1;
  const S ratio = (Ei + Ef) / (value_of(gb_sum) == T(0) ? S(T(1)) : gb_sum);
  const S r55_cor = -k * length * beta0 * Vm * sin_phi * (T(1) + ratio * ratio) /
                    (T(2) * Ei * Ef * (T(1) + beta0 * beta1) * beta1 * Ef);
  R[0 * 7 + 0] = r11;
  R[0 * 7 + 1] = r12;
  R[1 * 7 + 0] = r21;
  R[1 * 7 + 1] = r22;
  R[2 * 7 + 2] = r11;
  R[2 * 7 + 3] = r12;
  R[3 * 7 + 2] = r21;
  R[3 * 7 + 3] = r22;
  R[4 * 7 + 4] = T(1) + r55_cor;
  R[4 * 7 + 5] = r56;
  R[5 * 7 + 4] = k * sin_phi * Vm / (Ef * beta1);
  R[5 * 7 + 5] = Ei / Ef * beta0 / beta1;
}

// _build_undulator: a drift with r56 = L / gamma^2, into an identity R.
template <typename T, typename S>
__device__ __forceinline__ void undulator_entries(S length, S energy, T rest, S* R) {
  R[0 * 7 + 1] = length;
  R[2 * 7 + 3] = length;
  R[4 * 7 + 5] = length * igamma2_from_energy<T>(energy, rest, T(0));
}

// solenoid_entries(length, k, energy) into R.
template <typename T, typename S>
__device__ __forceinline__ void solenoid_body(S length, S k, S energy, T rest, S* R) {
  const S gamma = energy / rest;
  const S c = cos_(length * k), s = sin_(length * k);
  const S s_k = value_of(k) == T(0) ? length : s / k;
  S r56 = S(T(0));
  if (value_of(gamma) != T(0)) {
    const S b2g2 = gamma * gamma - T(1);
    r56 = -length / (value_of(b2g2) == T(0) ? S(T(1)) : b2g2);
  }
  const S c2 = c * c, sc = s * c, s2 = s * s;
  set_identity(R);
  R[0 * 7 + 0] = c2;
  R[0 * 7 + 1] = c * s_k;
  R[0 * 7 + 2] = sc;
  R[0 * 7 + 3] = s * s_k;
  R[1 * 7 + 0] = -k * s * c;
  R[1 * 7 + 1] = c2;
  R[1 * 7 + 2] = -k * s2;
  R[1 * 7 + 3] = sc;
  R[2 * 7 + 0] = -s * c;
  R[2 * 7 + 1] = -s * s_k;
  R[2 * 7 + 2] = c2;
  R[2 * 7 + 3] = c * s_k;
  R[3 * 7 + 0] = k * s2;
  R[3 * 7 + 1] = -s * c;
  R[3 * 7 + 2] = -k * s * c;
  R[3 * 7 + 3] = c2;
  R[4 * 7 + 5] = r56;
}

constexpr uint64_t kCavityCells = cell(0, 0) | cell(0, 1) | cell(1, 0) | cell(1, 1) | cell(2, 2) |
                                  cell(2, 3) | cell(3, 2) | cell(3, 3) | cell(4, 4) | cell(4, 5) |
                                  cell(5, 4) | cell(5, 5) | cell(6, 6);
constexpr uint64_t kLastOne = cell(6, 6);
constexpr uint64_t kSolenoidBody = kIdentityCells | cell(0, 1) | cell(0, 2) | cell(0, 3) |
                                   cell(1, 0) | cell(1, 2) | cell(1, 3) | cell(2, 0) | cell(2, 1) |
                                   cell(2, 3) | cell(3, 0) | cell(3, 1) | cell(3, 2) | cell(4, 5);
constexpr uint64_t kSolenoidBodyOnes = cell(4, 4) | cell(5, 5) | cell(6, 6);
constexpr uint64_t kSolenoidEntered = product_support(kSolenoidBody, kShift);
constexpr uint64_t kSolenoidEnteredOnes =
    product_ones(kSolenoidBody, kSolenoidBodyOnes, kShift, kShiftOnes);
constexpr uint64_t kSolenoidCells = product_support(kShift, kSolenoidEntered);
constexpr uint64_t kSolenoidOnes = product_ones(kShift, kShiftOnes, kSolenoidEntered,
                                                kSolenoidEnteredOnes);
// A dipole's body (or thin kick), its edge maps and the tilt sandwich.
constexpr uint64_t kBend = kQuadBase | cell(2, 6);
constexpr uint64_t kBendOnes = kQuadBaseOnes;
constexpr uint64_t kEdge = kIdentityCells | cell(1, 0) | cell(3, 2);
constexpr uint64_t kEdgeOnes = kIdentityCells;
constexpr uint64_t kBendIn = product_support(kBend, kEdge);
constexpr uint64_t kBendInOnes = product_ones(kBend, kBendOnes, kEdge, kEdgeOnes);
constexpr uint64_t kBendOut = product_support(kEdge, kBendIn);
constexpr uint64_t kBendOutOnes = product_ones(kEdge, kEdgeOnes, kBendIn, kBendInOnes);
constexpr uint64_t kBendTilted = product_support(kBendOut, kRot);
constexpr uint64_t kBendTiltedOnes = product_ones(kBendOut, kBendOutOnes, kRot, kRotOnes);
constexpr uint64_t kDipoleCells = product_support(kRot, kBendTilted);
constexpr uint64_t kDipoleOnes = product_ones(kRot, kRotOnes, kBendTilted, kBendTiltedOnes);

// -- products by sparse factors, in place ---------------------------------
//
// The solenoid's and the dipole's factors (shifts, edge maps, rotations) have
// two or four cells off the identity, so their products update a few rows or
// columns of the other factor in place, with one 7x7 array live instead of
// three.  Each keeps matmul7_support's terms and order (j ascending, a
// structural zero of the dense factor's support SM skipped, a one's multiply
// skipped), so the values are the same.

// Term j of out[i, k] = sum_j M[i, j] F[j, k] or sum_j F[i, j] M[j, k]: the
// running sum `acc`, started or not, plus m * f (or m if f is a one).
template <typename S>
__device__ __forceinline__ void add_term(S& acc, bool& started, S term) {
  acc = started ? acc + term : term;
  started = true;
}

// M <- M @ C for C the identity but for column `to` = column `to` + f *
// (column `from` of the identity), i.e. C[from, to] = f, from < to or from >
// to; support SM.  Column `to` of the result: M[i, from] f and M[i, to] in j
// order.
template <uint64_t SM, int kFrom, int kTo, typename S>
__device__ __forceinline__ void times_column_kick(S* M, S f) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    S acc = S(0);
    bool started = false;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (j == kFrom && has(SM, i, kFrom)) add_term(acc, started, M[i * 7 + kFrom] * f);
      if (j == kTo && has(SM, i, kTo)) add_term(acc, started, M[i * 7 + kTo]);
    }
    if (started) M[i * 7 + kTo] = acc;
  }
}

// M <- R @ M for R the identity but for R[to, from] = f: row `to` of the
// result is f M[from, k] and M[to, k] in j order.
template <uint64_t SM, int kFrom, int kTo, typename S>
__device__ __forceinline__ void row_kick_times(S* M, S f) {
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    S acc = S(0);
    bool started = false;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (j == kFrom && has(SM, kFrom, k)) add_term(acc, started, f * M[kFrom * 7 + k]);
      if (j == kTo && has(SM, kTo, k)) add_term(acc, started, M[kTo * 7 + k]);
    }
    if (started) M[kTo * 7 + k] = acc;
  }
}

// M <- M @ rot(cs, sn), rot as rotation(): columns 0-3 mix, 4-6 stay.
template <uint64_t SM, typename S>
__device__ __forceinline__ void times_rotation(S* M, S cs, S sn) {
  const S msn = -sn;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    S out[4];
    bool any[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // rot[j, k] non-zero for j = k (cs) and j = k ^ 2 (sn above, -sn below).
      S acc = S(0);
      bool started = false;
      const int other = k ^ 2;
      const S f = k < 2 ? msn : sn;  // rot[other, k]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j == k && has(SM, i, k)) add_term(acc, started, M[i * 7 + k] * cs);
        if (j == other && has(SM, i, other)) add_term(acc, started, M[i * 7 + other] * f);
      }
      out[k] = acc;
      any[k] = started;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (any[k]) M[i * 7 + k] = out[k];
    }
  }
}

// M <- rot(cs, sn) @ M: rows 0-3 mix, 4-6 stay.
template <uint64_t SM, typename S>
__device__ __forceinline__ void rotation_times(S* M, S cs, S sn) {
  const S msn = -sn;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    S out[4];
    bool any[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // rot[i, j] non-zero for j = i (cs) and j = i ^ 2 (sn above, -sn below).
      S acc = S(0);
      bool started = false;
      const int other = i ^ 2;
      const S f = i < 2 ? sn : msn;  // rot[i, other]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j == i && has(SM, i, k)) add_term(acc, started, cs * M[i * 7 + k]);
        if (j == other && has(SM, other, k)) add_term(acc, started, f * M[other * 7 + k]);
      }
      out[i] = acc;
      any[i] = started;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (any[i]) M[i * 7 + k] = out[i];
    }
  }
}

// _build_solenoid: exit @ (body @ entry) of p = (length, k, mx, my), in R.
template <typename T, typename S>
__device__ __forceinline__ void build_solenoid(const S* p, S energy, T rest, S* R) {
  solenoid_body<T>(p[0], p[1], energy, rest, R);
  // entry (x -= mx, y -= my): column 6 of R @ entry takes columns 0 and 2.
  const S mmx = -p[2], mmy = -p[3];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    S acc = S(0);
    bool started = false;
    if (has(kSolenoidBody, i, 0)) add_term(acc, started, R[i * 7 + 0] * mmx);
    if (has(kSolenoidBody, i, 2)) add_term(acc, started, R[i * 7 + 2] * mmy);
    if (has(kSolenoidBody, i, 6)) add_term(acc, started, R[i * 7 + 6]);
    if (started) R[i * 7 + 6] = acc;
  }
  // exit: rows 0 and 2 of exit @ M take row 6 (the identity's, 0 0 0 0 0 0 1).
  row_kick_times<kSolenoidEntered, 6, 0>(R, p[2]);
  row_kick_times<kSolenoidEntered, 6, 2>(R, p[3]);
}

// A dipole's thin-wedge edge cells: (1, 0) = hx tan(e), (3, 2) = -hx tan(e - phi).
template <typename T, typename S>
__device__ __forceinline__ void dipole_edge(S hx, S e, S fringe, S gap, S* e10, S* e32) {
  const S sec_e = T(1) / cos_(e);
  const S sin_e = sin_(e);
  const S phi = fringe * hx * gap * sec_e * (T(1) + sin_e * sin_e);
  *e10 = hx * tan_(e);
  *e32 = -hx * tan_(e - phi);
}

// _build_dipole of p = (length, angle, e1, e2, tilt, fint, fintx, gap):
// rot(-tilt) @ (edge2 @ (R @ edge1)) @ rot(tilt), R the body of
// base_rmatrix_entries(length, k1 = 0, hx = angle / length, tilt = 0,
// energy), or at length 0 the thin kick (0, 1) = (2, 3) = length, (2, 6) =
// angle.
template <typename T, typename S>
__device__ __forceinline__ void build_dipole(const S* p, S energy, T rest, S* R) {
  const S length = p[0], angle = p[1];
  const bool thin = value_of(length) == T(0);
  const S hx = thin ? S(T(0)) : angle / length;
  S* A = R;
  set_identity(A);
  if (thin) {
    A[0 * 7 + 1] = length;
    A[2 * 7 + 3] = length;
    A[2 * 7 + 6] = angle;
  } else {
    // base_rmatrix_entries at k1 = 0 (+ 1e-12) and curvature hx.
    const S igamma2 = igamma2_from_energy<T>(energy, rest, T(1));
    const S beta = sqrt_(T(1) - igamma2);
    const S k1 = S(T(1e-12));
    const S kx2 = k1 + hx * hx;
    const S ky2 = -k1;
    S cx, sx, cy, sy;
    cos_sinc<T>(kx2, length, &cx, &sx);
    cos_sinc<T>(ky2, length, &cy, &sy);
    const S dx = hx / kx2 * (T(1) - cx);
    const S inv_beta = value_of(beta) == T(0) ? S(T(INFINITY)) : T(1) / beta;
    const S inv_beta2 = inv_beta * inv_beta;
    const S r56 = hx * hx * (length - sx) / kx2 * inv_beta2 - length * inv_beta2 * igamma2;
    A[0 * 7 + 0] = cx;
    A[0 * 7 + 1] = sx;
    A[0 * 7 + 5] = dx * inv_beta;
    A[1 * 7 + 0] = -kx2 * sx;
    A[1 * 7 + 1] = cx;
    A[1 * 7 + 5] = sx * hx * inv_beta;
    A[2 * 7 + 2] = cy;
    A[2 * 7 + 3] = sy;
    A[3 * 7 + 2] = -ky2 * sy;
    A[3 * 7 + 3] = cy;
    A[4 * 7 + 0] = sx * hx * inv_beta;
    A[4 * 7 + 1] = dx * inv_beta;
    A[4 * 7 + 5] = r56;
  }
  S e10, e32;
  dipole_edge<T>(hx, p[2], p[5], p[7], &e10, &e32);  // entrance: e1, fint
  times_column_kick<kBend, 1, 0>(A, e10);             // A @ edge1: columns 0 and 2
  times_column_kick<kBend, 3, 2>(A, e32);
  dipole_edge<T>(hx, p[3], p[6], p[7], &e10, &e32);  // exit: e2, fintx
  row_kick_times<kBendIn, 0, 1>(A, e10);              // edge2 @ A: rows 1 and 3
  row_kick_times<kBendIn, 2, 3>(A, e32);
  const S cs = cos_(p[4]), sn = sin_(p[4]);
  times_rotation<kBendOut>(A, cs, sn);  // @ rot(tilt)
  rotation_times<kBendTilted>(A, cs, -sn);  // rot(-tilt) @: cos and sin are even and odd to the bit
}

// The map of a dynamic entry other than a custom map's: p holds
// tape_params(kind) parameters.  Inlined into the caller, so that the maps
// stay in registers.  Without kFull only the kinds below kFirstFullKind are
// built (the others are never on such a tape).
template <bool kFull, typename T, typename S>
__device__ __forceinline__ void build_dynamic(int kind, const S* p, S energy, T rest, T mass,
                                              S* R) {
  if (kind == kQuad) {
    build_quadrupole<T>(p, energy, rest, R);
    return;
  }
  if constexpr (kFull) {
    if (kind == kCavity) {
      build_cavity<T>(p, energy, rest, mass, R);
      return;
    }
    if (kind == kSolenoid) {
      build_solenoid<T>(p, energy, rest, R);
      return;
    }
    if (kind == kDipole) {
      build_dipole<T>(p, energy, rest, R);
      return;
    }
  }
  set_identity(R);
  if (kind == kIdentity) return;
  if (kFull && kind == kUndulator) {
    undulator_entries<T>(p[0], energy, rest, R);
    return;
  }
  drift_entries<T>(p[0], energy, rest, R);  // drift, and the correctors' drift
  // Indices known at compile time, so that R stays in registers.
  if (kind == kHCor) R[1 * 7 + 6] = p[1];
  if (kind == kVCor) R[3 * 7 + 6] = p[1];
}

// -- a tape entry composed onto a chain (B3 and B8) -------------------------

// total <- (the map of entry `entry` for setting b) @ total, over the entry's
// structural support: a dynamic entry's from its builder, a const entry's
// from its support class.
template <bool kFull, typename T>
__device__ __forceinline__ void compose_entry(const TapeEntry& entry,
                                              const T* __restrict__ params,
                                              const T* __restrict__ consts, int64_t batch,
                                              int64_t b, T energy, T rest, T mass, T* total) {
  if (entry.kind == kIdentity) return;
  T R[49];
  if (kFull && entry.kind == kCustom) {
#pragma unroll
    for (int c = 0; c < 49; ++c) R[c] = params[(entry.offset + c) * batch + b];
    compose_support<kAllCells, 0>(R, total);
    return;
  }
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
  constexpr int kParams = kFull ? kMaxParams : 5;
  T p[kParams];
  const int n = tape_params<kFull>(entry.kind);
#pragma unroll
  for (int k = 0; k < kParams; ++k) p[k] = k < n ? params[(entry.offset + k) * batch + b] : T(0);
  if (entry.kind == kQuad) {
    build_quadrupole<T>(p, energy, rest, R);
    compose_support<kQuadCells, kQuadOnes>(R, total);
    return;
  }
  if constexpr (kFull) {
    if (entry.kind == kCavity) {
      build_cavity<T>(p, energy, rest, mass, R);
      compose_support<kCavityCells, kLastOne>(R, total);
      return;
    }
    if (entry.kind == kSolenoid) {
      build_solenoid<T>(p, energy, rest, R);
      compose_support<kSolenoidCells, kSolenoidOnes>(R, total);
      return;
    }
    if (entry.kind == kDipole) {
      build_dipole<T>(p, energy, rest, R);
      compose_support<kDipoleCells, kDipoleOnes>(R, total);
      return;
    }
  }
  build_dynamic<kFull, T, T>(entry.kind, p, energy, rest, mass, R);
  if (entry.kind == kDrift || (kFull && entry.kind == kUndulator)) {
    compose_support<kDriftCells, kIdentityCells>(R, total);
  } else if (entry.kind == kHCor) {
    compose_support<kHCorCells, kIdentityCells>(R, total);
  } else {
    compose_support<kVCorCells, kIdentityCells>(R, total);
  }
}

}  // namespace lynx

// The body of the tracking-MPC iLQR kernel, over the type `real`:
// included by ilqr_tracking_mpc.cu once per precision, with ILQR_MPC_NS
// (the namespace to put it in) and ILQR_MPC_REAL (double or float) defined.
// No include guard: it is meant to be included more than once.  The design
// is described at the top of ilqr_tracking_mpc.cu.

namespace ILQR_MPC_NS {

using namespace ilqr_common;

using real = ILQR_MPC_REAL;
// a literal of the solve's type (a bare 1.0 would drag a float32 expression
// into double)
#define R(x) ((real)(x))

constexpr int NX = 7;
constexpr int NU = 2;
constexpr int NC = 4;
constexpr int NV = NX + NU;              // differentiation variables (x, u)
constexpr int NSCAL = 18;
constexpr int NTAB = 5;
constexpr real AL_ZERO = R(1e-4);
constexpr real PI = R(3.141592653589793);

// scalar params and reference tables, in the order of ilqr_tracking_mpc.py
enum Scalar {
  PD, PV, PDELTA, MIN_PDELTA_DOT, PDELTA_DOT, MIN_P_PHI_DOT, P_PHI_DOT,
  P_PHI, P_PHI_REF_DOT_DIFF, PA, PJ, L, V_CH, REF_STEP, MAX_DELTA, MAX_ACC,
  MIN_ACC, A_OFFSET
};
enum Table { T_X, T_Y, T_PHI, T_K, T_V };
// the differentiation variables
enum Var { V_PX, V_PY, V_PHI, V_DELTA, V_V, V_SR, V_A, V_J, V_DDOT };

// per-step derivative block: fx (7,7), fu (7,2), lx (7), lu (2),
// lxx (7,7), luu (2,2), lux (2,7)
constexpr int D_FX = 0;
constexpr int D_FU = D_FX + NX * NX;
constexpr int D_LX = D_FU + NX * NU;
constexpr int D_LU = D_LX + NX;
constexpr int D_LXX = D_LU + NU;
constexpr int D_LUU = D_LXX + NX * NX;
constexpr int D_LUX = D_LUU + NU * NU;
constexpr int ND = D_LUX + NU * NX;

// ---------------------------------------------------------------------
// the compact derivative block (the batched kernel)
//
// Of a step's 139 dense entries the derivative code writes only these with
// a value it computes: the Jacobian entries in the masks of the dynamics'
// rows (14, three of them the constant dt), the cost's 9 gradient entries
// and the 26 upper-triangle Hessian pairs its terms touch (the 21 over
// (px, py, phi, delta, v, s_r), (a, a), (j, j), (v, delta_dot),
// (delta_dot, delta_dot), and (delta, a), which the multiplier term touches
// with exact zeros).  Every other dense entry is a fixed expression: 1 + dt
// * 0 on fx's diagonal, 0 + dt * 0 elsewhere in fx, dt * 0 in fu, a zero
// the clear left in the cost's part, or a mirror of an upper-triangle
// entry.  The compact block keeps the 49 in dense order; the batched kernel
// rebuilds each step's dense block from it (expand_code) with the same
// bits.  The writers check the sets at
// compile time (jac_row against the masks, CompactHessAcc on every touched
// entry), so a term that touches another entry does not compile.

// row I of the dynamics depends on variable J
__host__ __device__ constexpr bool jac_has(int I, int J) {
  return I <= 1 ? (J == V_PHI || J == V_V)
       : I == 2 ? (J == V_DELTA || J == V_V)
       : I == 3 ? J == V_DDOT
       : I == 4 ? J == V_A
       : I == 5 ? (J == V_PX || J == V_PY || J == V_PHI || J == V_V
                   || J == V_SR)
                : J == V_J;
}

// the cost's Hessian entry (I, J), I <= J, is touched by one of its terms
__host__ __device__ constexpr bool hess_has(int I, int J) {
  return J <= V_SR || (I == V_A && J == V_A) || (I == V_J && J == V_J)
         || (I == V_V && J == V_DDOT) || (I == V_DDOT && J == V_DDOT)
         || (I == V_DELTA && J == V_A);
}

// the dense entry e is kept in the compact block
__host__ __device__ constexpr bool stored(int e) {
  return e < D_FU ? jac_has(e / NX, e % NX)
       : e < D_LX ? jac_has((e - D_FU) / NU, NX + (e - D_FU) % NU)
       : e < D_LXX ? true
       : e < D_LUU ? ((e - D_LXX) / NX <= (e - D_LXX) % NX
                      && hess_has((e - D_LXX) / NX, (e - D_LXX) % NX))
       : e < D_LUX ? ((e - D_LUU) / NU <= (e - D_LUU) % NU
                      && hess_has(NX + (e - D_LUU) / NU,
                                  NX + (e - D_LUU) % NU))
                   : hess_has((e - D_LUX) % NX, NX + (e - D_LUX) / NX);
}

// the stored entries among the first e dense ones
__host__ __device__ constexpr int n_stored(int e) {
  int p = 0;
  for (int k = 0; k < e; ++k) p += stored(k) ? 1 : 0;
  return p;
}

// the compact index of dense entry e, or -1
__host__ __device__ constexpr int cpos(int e) {
  return stored(e) ? n_stored(e) : -1;
}

constexpr int NCMP = n_stored(ND);       // reals of a compact block
constexpr int NJAC = n_stored(D_LX);     // the Jacobian's, first
static_assert(NCMP == 49 && NJAC == 14, "compact derivative block");

// how the batch forms dense entry e: a compact index, or one of these, the
// constant at konst[-1 - code] (the batched kernel's block keeps the four)
enum Expand { X_ONE = -1, X_FX_ZERO = -2, X_FU_ZERO = -3, X_ZERO = -4 };
constexpr int NKONST = 4;

__host__ __device__ constexpr int expand_code(int e) {
  // a lower-triangle entry of lxx or luu is its upper mirror's
  const int src =
      e >= D_LXX && e < D_LUU && (e - D_LXX) / NX > (e - D_LXX) % NX
          ? D_LXX + ((e - D_LXX) % NX) * NX + (e - D_LXX) / NX
      : e >= D_LUU && e < D_LUX && (e - D_LUU) / NU > (e - D_LUU) % NU
          ? D_LUU + ((e - D_LUU) % NU) * NU + (e - D_LUU) / NU
          : e;
  return stored(src) ? cpos(src)
       : src < D_FU ? (src / NX == src % NX ? X_ONE : X_FX_ZERO)
       : src < D_LX ? X_FU_ZERO
                    : X_ZERO;
}

// ---------------------------------------------------------------------
// forward-mode numbers over (x, u) with a compile-time set of active
// variables
//
// SD<M, ORD> carries a value, the gradient entries of the variables in the
// bit mask M and (ORD == 2) the upper-triangle Hessian entries over them.
// An entry outside M is a structural zero: it reads as Zero, whose
// arithmetic drops the term.  x + 0 and x - 0 are x and 0 * x is 0 for
// every finite x, so each stored entry has the value the dense formula
// gives.

struct Zero {};
template <int I>
struct Int {
  static constexpr int value = I;
};

__device__ __forceinline__ Zero operator*(Zero, real) { return {}; }
__device__ __forceinline__ Zero operator*(real, Zero) { return {}; }
__device__ __forceinline__ Zero operator*(Zero, Zero) { return {}; }
__device__ __forceinline__ Zero operator/(Zero, real) { return {}; }
__device__ __forceinline__ Zero operator+(Zero, Zero) { return {}; }
__device__ __forceinline__ real operator+(Zero, real b) { return b; }
__device__ __forceinline__ real operator+(real a, Zero) { return a; }
__device__ __forceinline__ Zero operator-(Zero, Zero) { return {}; }
__device__ __forceinline__ real operator-(real a, Zero) { return a; }
__device__ __forceinline__ real operator-(Zero, real b) { return R(0.0) - b; }
__device__ __forceinline__ Zero operator-(Zero) { return {}; }
__device__ __forceinline__ real dbl(Zero) { return R(0.0); }
__device__ __forceinline__ real dbl(real a) { return a; }

__host__ __device__ constexpr int popc(unsigned m) {
  int c = 0;
  for (; m; m >>= 1) c += (int)(m & 1u);
  return c;
}
__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }

template <int I, int N, class F>
__device__ __forceinline__ void sfor(F&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    sfor<I + 1, N>(f);
  }
}

template <unsigned M, int ORD>
struct SD {
  static constexpr unsigned MASK = M;
  static constexpr int ORDER = ORD;
  static constexpr int N = popc(M);
  real v;
  real g[N > 0 ? N : 1];
  real h[(ORD == 2 && N > 0) ? tri(N) : 1];

  template <int I>
  __host__ __device__ static constexpr bool has() {
    return ((M >> I) & 1u) != 0;
  }
  template <int I>
  __host__ __device__ static constexpr int pos() {
    return popc(M & ((1u << I) - 1u));
  }
  template <int I, int J>
  __host__ __device__ static constexpr int hpos() {      // I <= J, both in M
    return pos<I>() * N - (pos<I>() * (pos<I>() - 1)) / 2
           + (pos<J>() - pos<I>());
  }

  template <int I>
  __device__ __forceinline__ auto G() const {
    if constexpr (has<I>()) return g[pos<I>()];
    else return Zero{};
  }
  template <int I, int J>
  __device__ __forceinline__ auto Hs() const {
    if constexpr (ORD == 2 && has<I>() && has<J>()) return h[hpos<I, J>()];
    else return Zero{};
  }
  template <int I, class T>
  __device__ __forceinline__ void setG(T x) {
    g[pos<I>()] = dbl(x);
  }
  template <int I, int J, class T>
  __device__ __forceinline__ void setH(T x) {
    h[hpos<I, J>()] = dbl(x);
  }
};

// r.g[I] = fg(I) for I in r's mask; r.h[I, J] = fh(I, J) for I <= J in it
template <class R, class FG, class FH>
__device__ __forceinline__ void fill(R& r, FG&& fg, FH&& fh) {
  sfor<0, NV>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    if constexpr (R::template has<I>()) r.template setG<I>(fg(ic));
  });
  if constexpr (R::ORDER == 2) {
    sfor<0, NV>([&](auto ic) {
      constexpr int I = decltype(ic)::value;
      if constexpr (R::template has<I>()) {
        sfor<I, NV>([&](auto jc) {
          constexpr int J = decltype(jc)::value;
          if constexpr (R::template has<J>())
            r.template setH<I, J>(fh(ic, jc));
        });
      }
    });
  }
}

#define SD_IJ                                \
  constexpr int I = decltype(ic)::value;     \
  constexpr int J = decltype(jc)::value
#define SD_I constexpr int I = decltype(ic)::value

// the variable I at value c
template <int I, int ORD>
__device__ __forceinline__ SD<(1u << I), ORD> var(real c) {
  SD<(1u << I), ORD> r;
  r.v = c;
  r.g[0] = R(1.0);
  r.h[0] = R(0.0);
  return r;
}

// all-zero number with the mask and order of its argument
__device__ __forceinline__ real zero_like(real) { return R(0.0); }
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> zero_like(const SD<A, O>&) {
  SD<A, O> r;
  r.v = R(0.0);
  fill(r, [](auto) { return R(0.0); }, [](auto, auto) { return R(0.0); });
  return r;
}

template <unsigned A, unsigned B, int O>
__device__ __forceinline__ SD<(A | B), O> operator+(const SD<A, O>& a,
                                                    const SD<B, O>& b) {
  SD<(A | B), O> r;
  r.v = a.v + b.v;
  fill(r,
       [&](auto ic) { SD_I; return a.template G<I>() + b.template G<I>(); },
       [&](auto ic, auto jc) {
         SD_IJ;
         return a.template Hs<I, J>() + b.template Hs<I, J>();
       });
  return r;
}

template <unsigned A, unsigned B, int O>
__device__ __forceinline__ SD<(A | B), O> operator-(const SD<A, O>& a,
                                                    const SD<B, O>& b) {
  SD<(A | B), O> r;
  r.v = a.v - b.v;
  fill(r,
       [&](auto ic) { SD_I; return a.template G<I>() - b.template G<I>(); },
       [&](auto ic, auto jc) {
         SD_IJ;
         return a.template Hs<I, J>() - b.template Hs<I, J>();
       });
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator+(const SD<A, O>& a, real b) {
  SD<A, O> r = a;
  r.v = a.v + b;
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator+(real b, const SD<A, O>& a) {
  SD<A, O> r = a;
  r.v = b + a.v;
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator-(const SD<A, O>& a, real b) {
  SD<A, O> r = a;
  r.v = a.v - b;
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator-(real b, const SD<A, O>& a) {
  SD<A, O> r;
  r.v = b - a.v;
  fill(r, [&](auto ic) { SD_I; return -a.template G<I>(); },
       [&](auto ic, auto jc) { SD_IJ; return -a.template Hs<I, J>(); });
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator*(const SD<A, O>& a, real b) {
  SD<A, O> r;
  r.v = a.v * b;
  fill(r, [&](auto ic) { SD_I; return a.template G<I>() * b; },
       [&](auto ic, auto jc) { SD_IJ; return a.template Hs<I, J>() * b; });
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator*(real b, const SD<A, O>& a) {
  SD<A, O> r;
  r.v = b * a.v;
  fill(r, [&](auto ic) { SD_I; return b * a.template G<I>(); },
       [&](auto ic, auto jc) { SD_IJ; return b * a.template Hs<I, J>(); });
  return r;
}

template <unsigned A, unsigned B, int O>
__device__ __forceinline__ SD<(A | B), O> operator*(const SD<A, O>& a,
                                                    const SD<B, O>& b) {
  SD<(A | B), O> r;
  r.v = a.v * b.v;
  fill(r,
       [&](auto ic) {
         SD_I;
         return a.v * b.template G<I>() + b.v * a.template G<I>();
       },
       [&](auto ic, auto jc) {
         SD_IJ;
         return a.v * b.template Hs<I, J>() + b.v * a.template Hs<I, J>()
                + a.template G<I>() * b.template G<J>()
                + a.template G<J>() * b.template G<I>();
       });
  return r;
}

// q = a / b: a = q b, so q' = (a' - q b') / b and
// q'' = (a'' - q' b'^T - b' q'^T - q b'') / b
template <unsigned A, unsigned B, int O>
__device__ __forceinline__ SD<(A | B), O> operator/(const SD<A, O>& a,
                                                    const SD<B, O>& b) {
  SD<(A | B), O> r;
  r.v = a.v / b.v;
  sfor<0, NV>([&](auto ic) {
    SD_I;
    if constexpr (SD<(A | B), O>::template has<I>())
      r.template setG<I>(
          dbl(a.template G<I>() - r.v * b.template G<I>()) / b.v);
  });
  if constexpr (O == 2) {
    sfor<0, NV>([&](auto ic) {
      SD_I;
      if constexpr (SD<(A | B), O>::template has<I>()) {
        sfor<I, NV>([&](auto jc) {
          constexpr int J = decltype(jc)::value;
          if constexpr (SD<(A | B), O>::template has<J>())
            r.template setH<I, J>(
                dbl(a.template Hs<I, J>()
                    - r.template G<I>() * b.template G<J>()
                    - r.template G<J>() * b.template G<I>()
                    - r.v * b.template Hs<I, J>())
                / b.v);
        });
      }
    });
  }
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator/(const SD<A, O>& a, real b) {
  SD<A, O> r;
  r.v = a.v / b;
  fill(r, [&](auto ic) { SD_I; return a.template G<I>() / b; },
       [&](auto ic, auto jc) { SD_IJ; return a.template Hs<I, J>() / b; });
  return r;
}

// f(a) with f(a.v) = f0, f'(a.v) = f1, f''(a.v) = f2
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> chain(const SD<A, O>& a, real f0,
                                          real f1, real f2) {
  SD<A, O> r;
  r.v = f0;
  fill(r, [&](auto ic) { SD_I; return f1 * a.template G<I>(); },
       [&](auto ic, auto jc) {
         SD_IJ;
         return f1 * a.template Hs<I, J>()
                + f2 * a.template G<I>() * a.template G<J>();
       });
  return r;
}

__device__ __forceinline__ void sincos_r(double a, double* s, double* c) {
  sincos(a, s, c);
}
__device__ __forceinline__ void sincos_r(float a, float* s, float* c) {
  sincosf(a, s, c);
}

// the same math on reals and on SD (distinct names: an SD overload named
// sin would hide ::sin inside this namespace)
__device__ __forceinline__ real val(real a) { return a; }
template <unsigned A, int O>
__device__ __forceinline__ real val(const SD<A, O>& a) { return a.v; }
__device__ __forceinline__ real fsin(real a) { return sin(a); }
__device__ __forceinline__ real fcos(real a) { return cos(a); }
__device__ __forceinline__ real ftan(real a) { return tan(a); }
__device__ __forceinline__ real sq(real a) { return a * a; }
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> fsin(const SD<A, O>& a) {
  const real s = sin(a.v), c = cos(a.v);
  return chain(a, s, c, -s);
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> fcos(const SD<A, O>& a) {
  const real s = sin(a.v), c = cos(a.v);
  return chain(a, c, -s, -c);
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> ftan(const SD<A, O>& a) {
  const real t = tan(a.v), d1 = R(1.0) + t * t;
  return chain(a, t, d1, R(2.0) * t * d1);
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> sq(const SD<A, O>& a) { return a * a; }

// a table lookup whose slope in the query is `slope` and whose curvature
// in the query is zero
__device__ __forceinline__ real lin(real, real value, real) {
  return value;
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> lin(const SD<A, O>& q, real value,
                                        real slope) {
  SD<A, O> r;
  r.v = value;
  fill(r, [&](auto ic) { SD_I; return slope * q.template G<I>(); },
       [&](auto ic, auto jc) { SD_IJ; return slope * q.template Hs<I, J>(); });
  return r;
}

// ---------------------------------------------------------------------
// scalar helpers with torch's semantics

// torch.clamp: NaN passes through
__device__ __forceinline__ real clampd(real x, real lo, real hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.remainder(x, m) for m > 0 (floored, as jnp.mod)
__device__ __forceinline__ real pymod(real x, real m) {
  real r = fmod(x, m);
  if (r != R(0.0) && r < R(0.0)) r += m;
  return r;
}

__device__ __forceinline__ real angle_dist(real a0, real a1) {
  return pymod((a1 - a0) + PI, R(2.0) * PI) - PI;
}

struct Lookup {
  int i0, i1;
  real a;
};

// clamped floor / ceil indices and alpha at fractional index q (a NaN
// query reads row 0; its alpha stays NaN)
__device__ __forceinline__ Lookup lookup(real q, int n) {
  const real qs = isnan(q) ? R(0.0) : q;
  const real f0 = clampd(floor(qs), R(0.0), n - R(1.0));
  const real f1 = clampd(ceil(qs), R(0.0), n - R(1.0));
  Lookup r;
  r.i0 = (int)f0;
  r.i1 = (int)f1;
  r.a = clampd(q - f0, R(0.0), R(1.0));
  return r;
}

// ---------------------------------------------------------------------
// the problem (tpl_tpu_torch/optim/problems.py trajectory_tracking_mpc)

struct Prm {
  const real* s;    // scalars
  const real* tab;  // NTAB rows of n_ref
  const real* sad;  // angle distances: row i to row i + 1, row i to itself
  int n_ref;
};

// sad[i] = angle_dist(ref_phi[i], ref_phi[min(i + 1, n - 1)]) and
// sad[n + i] = angle_dist(ref_phi[i], ref_phi[i]): the only two index pairs
// lerp_angle can ask for
__device__ void tabulate_angle_dist(const real* tab, real* sad, int n) {
  const real* tp = tab + T_PHI * n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const int i0 = i < n ? i : i - n;
    const int i1 = i < n ? (i0 + 1 < n ? i0 + 1 : n - 1) : i0;
    sad[i] = angle_dist(tp[i0], tp[i1]);
  }
}

// what dynamics and cost share: the yaw rate, the offset from and progress
// along the reference, the reference heading and curvature, and the sines
// and cosines of the heading, the reference heading and their difference
template <class TPD, class TDR, class TSD, class TRP, class TRK, class TP,
          class TD>
struct Core {
  TPD phi_dot;
  TDR d_r;
  TSD s_dot;
  TRP r_phi;
  TRK r_k;
  TP s_phi, c_phi;
  TD c_dphi;
  real v_trg;
};

template <class TPD, class TDR, class TSD, class TRP, class TRK, class TP,
          class TD>
__device__ __forceinline__ Core<TPD, TDR, TSD, TRP, TRK, TP, TD> make_core(
    const TPD& phi_dot, const TDR& d_r, const TSD& s_dot, const TRP& r_phi,
    const TRK& r_k, const TP& s_phi, const TP& c_phi, const TD& c_dphi,
    real v_trg) {
  return {phi_dot, d_r, s_dot, r_phi, r_k, s_phi, c_phi, c_dphi, v_trg};
}

// the yaw rate of the single-track model, or the one formed beforehand
struct NoPre {};
template <class TV, class TDEL>
__device__ __forceinline__ auto yaw_rate(const Prm& P, const TV& v,
                                         const TDEL& delta, NoPre) {
  return v / (P.s[L] * (R(1.0) + sq(v / P.s[V_CH]))) * ftan(delta);
}
__device__ __forceinline__ real yaw_rate(const Prm&, real, real,
                                           real pre) {
  return pre;
}

// the five sines and cosines of one evaluation, each thread for itself
struct LocalTrig {
  static constexpr bool LANES = false;
  template <class TP, class TR, class TD>
  __device__ __forceinline__ static void eval(const TP& phi, const TR& r_phi,
                                              const TD& dphi, TP& s_phi,
                                              TP& c_phi, TR& s_r, TR& c_r,
                                              TD& c_d) {
    s_phi = fsin(phi);
    c_phi = fcos(phi);
    s_r = fsin(r_phi);
    c_r = fcos(r_phi);
    c_d = fcos(dphi);
  }
};

// the value lane `src` of the calling group of G lanes holds (every lane
// of the warp calls it; G == WARP is lane_get)
template <int G>
__device__ __forceinline__ real group_get(real v, int src) {
  if constexpr (G == WARP)
    return lane_get(v, src);
  else
    return __shfl_sync(FULL_MASK, v, src, G);
}

// the same for a group of G lanes (the warp, or half of it) that all hold
// the same arguments: lanes 0, 1 and 2 of the group take one angle each in
// one sincos() call and every lane reads the five values back.  sincos()
// returns the bits of sin() and cos() (chip_smoke.py counts the arguments
// at which they differ: none of 12,000,000), and saves the second argument
// reduction.
template <int G>
struct GroupTrig {
  static constexpr bool LANES = true;
  static constexpr int WIDTH = G;
  __device__ __forceinline__ static void eval(const real& phi,
                                              const real& r_phi,
                                              const real& dphi,
                                              real& s_phi, real& c_phi,
                                              real& s_r, real& c_r,
                                              real& c_d) {
    const int lane = threadIdx.x & (G - 1);
    real s, c;
    sincos_r(lane == 0 ? phi : (lane == 1 ? r_phi : dphi), &s, &c);
    s_phi = group_get<G>(s, 0);
    s_r = group_get<G>(s, 1);
    c_phi = group_get<G>(c, 0);
    c_r = group_get<G>(c, 1);
    c_d = group_get<G>(c, 2);
  }
};
using WarpTrig = GroupTrig<WARP>;

template <class Trig, class TPX, class TPY, class TPHI, class TDEL, class TV,
          class TSR, class TPRE = NoPre>
__device__ __forceinline__ auto core(const Prm& P, const TPX& px,
                                     const TPY& py, const TPHI& phi,
                                     const TDEL& delta, const TV& v,
                                     const TSR& s_r, TPRE pre = TPRE{}) {
  const int n = P.n_ref;

  // lerp_multi over (ref_x, ref_y, ref_k, ref_v)
  const TSR q = (s_r - R(0.0)) / P.s[REF_STEP];
  const Lookup lk = lookup(val(q), n);
  const real* tx = P.tab + T_X * n;
  const real* ty = P.tab + T_Y * n;
  const real* tk = P.tab + T_K * n;
  const real* tv = P.tab + T_V * n;
  const real dx = tx[lk.i1] - tx[lk.i0];
  const real dy = ty[lk.i1] - ty[lk.i0];
  const real dk = tk[lk.i1] - tk[lk.i0];
  const real dv = tv[lk.i1] - tv[lk.i0];
  const TSR r_x = lin(q, tx[lk.i0] + lk.a * dx, dx);
  const TSR r_y = lin(q, ty[lk.i0] + lk.a * dy, dy);
  const TSR r_k = lin(q, tk[lk.i0] + lk.a * dk, dk);
  // the velocity target carries no derivative (genopt's fixed())
  const real v_trg = tv[lk.i0] + lk.a * dv;

  // lerp_angle over ref_phi at the clamped query
  const real qc = clampd(val(q), R(0.0), n - R(1.0));
  const Lookup la = lookup(qc, n);
  const real* tp = P.tab + T_PHI * n;
  const real sad = la.i1 == la.i0 ? P.sad[n + la.i0] : P.sad[la.i0];
  const TSR r_phi = lin(q, tp[la.i0] + sad * la.a, sad);

  const auto dphi = phi - r_phi;
  TPHI s_phi, c_phi;
  TSR s_r_phi, c_r_phi;
  auto c_dphi = dphi;
  Trig::eval(phi, r_phi, dphi, s_phi, c_phi, s_r_phi, c_r_phi, c_dphi);

  const auto phi_dot = yaw_rate(P, v, delta, pre);
  const auto d_r = c_r_phi * (py - r_y) - s_r_phi * (px - r_x);
  const auto s_dot = v * c_dphi / (R(1.0) - d_r * r_k);
  return make_core(phi_dot, d_r, s_dot, r_phi, r_k, s_phi, c_phi, c_dphi,
                   v_trg);
}

// sums the cost's terms in the plain order
struct SumAcc {
  real c = R(0.0);
  bool first = true;
  __device__ __forceinline__ void add(real t) {
    c = first ? t : c + t;
    first = false;
  }
};

// adds each term's gradient and Hessian entries into a step's (zeroed)
// derivative block, in the plain order; lxx and luu take the upper triangle
// (mirror() completes them)
struct HessAcc {
  real* d;

  __device__ __forceinline__ void clear() const {
    for (int i = D_LX; i < ND; ++i) d[i] = R(0.0);
  }
  template <int I>
  __host__ __device__ static constexpr int gidx() {
    return I < NX ? D_LX + I : D_LU + (I - NX);
  }
  template <int I, int J>
  __host__ __device__ static constexpr int hidx() {      // I <= J
    return J < NX ? D_LXX + I * NX + J
                  : (I >= NX ? D_LUU + (I - NX) * NU + (J - NX)
                             : D_LUX + (J - NX) * NX + I);
  }
  template <unsigned A>
  __device__ __forceinline__ void add(const SD<A, 2>& t) const {
    sfor<0, NV>([&](auto ic) {
      SD_I;
      if constexpr (SD<A, 2>::template has<I>()) {
        d[gidx<I>()] = d[gidx<I>()] + t.template G<I>();
        sfor<I, NV>([&](auto jc) {
          constexpr int J = decltype(jc)::value;
          if constexpr (SD<A, 2>::template has<J>())
            d[hidx<I, J>()] = d[hidx<I, J>()] + t.template Hs<I, J>();
        });
      }
    });
  }
  __device__ __forceinline__ void mirror() const {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j)
        d[D_LXX + i * NX + j] = d[D_LXX + j * NX + i];
    d[D_LUU + NU] = d[D_LUU + 1];
  }
};

// the same additions into a step's compact block (its cost part); the
// lower triangle is formed where the batch expands the block
struct CompactHessAcc {
  real* c;

  __device__ __forceinline__ void clear() const {
    for (int i = NJAC; i < NCMP; ++i) c[i] = R(0.0);
  }
  template <int E>
  __device__ __forceinline__ void acc(real v) const {
    constexpr int p = cpos(E);
    static_assert(p >= 0, "a cost term touches an entry outside the "
                          "compact block");
    c[p] = c[p] + v;
  }
  template <unsigned A>
  __device__ __forceinline__ void add(const SD<A, 2>& t) const {
    sfor<0, NV>([&](auto ic) {
      SD_I;
      if constexpr (SD<A, 2>::template has<I>()) {
        acc<HessAcc::gidx<I>()>(dbl(t.template G<I>()));
        sfor<I, NV>([&](auto jc) {
          constexpr int J = decltype(jc)::value;
          if constexpr (SD<A, 2>::template has<J>())
            acc<HessAcc::hidx<I, J>()>(dbl(t.template Hs<I, J>()));
        });
      }
    });
  }
  __device__ __forceinline__ void mirror() const {}
};

// cost + sum(g*lam) + sum(inactive ? 0 : w*g*g), term by term into acc
template <class Acc, class TPHI, class TDEL, class TV, class TA, class TJ,
          class TDD, class TCore>
__device__ __forceinline__ void aug_cost(const Prm& P, Acc& acc,
                                         const TPHI& phi, const TDEL& delta,
                                         const TV& v, const TA& a,
                                         const TJ& j, const TDD& delta_dot,
                                         const TCore& e, const real* lam,
                                         const real* bw) {
  const real* p = P.s;
  acc.add((p[MIN_PDELTA_DOT] + p[PDELTA_DOT] * sq(v)) * sq(delta_dot));
  acc.add((p[MIN_P_PHI_DOT] + p[P_PHI_DOT] * sq(v)) * sq(e.phi_dot));
  acc.add(p[PA] * sq(a));
  acc.add(p[PJ] * sq(j));
  acc.add(p[PV] * sq(v - e.v_trg));
  acc.add(p[PD] * sq(e.d_r));
  acc.add(p[P_PHI] * (R(1.0) - e.c_dphi));
  acc.add(p[P_PHI_REF_DOT_DIFF] * sq(e.phi_dot - e.s_dot * e.r_k) * sq(v));

  // the constraints: steering within +-max_delta, acceleration within
  // [min_acc, max_acc]
  const auto g0 = delta - p[MAX_DELTA];
  const auto g1 = (-p[MAX_DELTA]) - delta;
  const auto g2 = a - p[MAX_ACC];
  const auto g3 = p[MIN_ACC] - a;
  const auto s = ((g0 * lam[0] + g1 * lam[1]) + g2 * lam[2]) + g3 * lam[3];
  acc.add(s);
  auto pen = zero_like(s);
  if (!(val(g0) < R(0.0) && fabs(lam[0]) < AL_ZERO))
    pen = pen + (bw[0] * g0) * g0;
  if (!(val(g1) < R(0.0) && fabs(lam[1]) < AL_ZERO))
    pen = pen + (bw[2] * g1) * g1;
  if (!(val(g2) < R(0.0) && fabs(lam[2]) < AL_ZERO))
    pen = pen + (bw[4] * g2) * g2;
  if (!(val(g3) < R(0.0) && fabs(lam[3]) < AL_ZERO))
    pen = pen + (bw[6] * g3) * g3;
  acc.add(pen);
}

__device__ real step_cost(const Prm& P, const real* x, const real* u,
                            const real* lam, const real* bw) {
  const auto e = core<LocalTrig>(P, x[0], x[1], x[2], x[3], x[4], x[5]);
  SumAcc acc;
  aug_cost(P, acc, x[2], x[3], x[4], x[6], u[0], u[1], e, lam, bw);
  return acc.c;
}

// the augmented cost's gradient and Hessian at step (x, u) into the
// step's block through acc (HessAcc: the dense lx, lu, lxx, luu, lux;
// CompactHessAcc: the compact block)
template <class Acc>
__device__ void deriv_cost(const Prm& P, const real* x, const real* u,
                           const real* lam, const real* bw, Acc acc) {
  const auto px = var<V_PX, 2>(x[0]);
  const auto py = var<V_PY, 2>(x[1]);
  const auto phi = var<V_PHI, 2>(x[2]);
  const auto delta = var<V_DELTA, 2>(x[3]);
  const auto v = var<V_V, 2>(x[4]);
  const auto s_r = var<V_SR, 2>(x[5]);
  const auto a = var<V_A, 2>(x[6]);
  const auto j = var<V_J, 2>(u[0]);
  const auto delta_dot = var<V_DDOT, 2>(u[1]);
  const auto e = core<LocalTrig>(P, px, py, phi, delta, v, s_r);
  acc.clear();
  aug_cost(P, acc, phi, delta, v, a, j, delta_dot, e, lam, bw);
  acc.mirror();
}

// where jac_row puts an entry: every entry of the dense block, or the
// compact block's
struct DenseJac {
  static constexpr bool DENSE = true;
  real* d;
  template <int E>
  __device__ __forceinline__ void put(real v) const { d[E] = v; }
};
struct CompactJac {
  static constexpr bool DENSE = false;
  real* c;
  template <int E>
  __device__ __forceinline__ void put(real v) const { c[cpos(E)] = v; }
};

// row I of fx = I + dt*df/dx and fu = dt*df/du from dynamics entry f (a
// compact writer skips the entries outside f's mask, which are constants)
template <int I, class Out, class T>
__device__ __forceinline__ void jac_row(const Out& o, real dt, const T& f) {
  sfor<0, NV>([&](auto jc) {
    constexpr int J = decltype(jc)::value;
    static_assert(T::template has<J>() == jac_has(I, J),
                  "jac_has differs from the dynamics' masks");
    if constexpr (Out::DENSE || T::template has<J>()) {
      real gj;
      if constexpr (T::template has<J>()) gj = f.template G<J>();
      else gj = R(0.0);
      if constexpr (J < NX)
        o.template put<D_FX + I * NX + J>((I == J ? R(1.0) : R(0.0))
                                          + dt * gj);
      else
        o.template put<D_FU + I * NU + (J - NX)>(dt * gj);
    }
  });
}

// the dynamics' Euler Jacobians at step (x, u) into the step's block
// through o
template <class Out>
__device__ void deriv_dyn(const Prm& P, const real* x, const real* u,
                          real dt, const Out& d) {
  const auto px = var<V_PX, 1>(x[0]);
  const auto py = var<V_PY, 1>(x[1]);
  const auto phi = var<V_PHI, 1>(x[2]);
  const auto delta = var<V_DELTA, 1>(x[3]);
  const auto v = var<V_V, 1>(x[4]);
  const auto s_r = var<V_SR, 1>(x[5]);
  const auto a = var<V_A, 1>(x[6]);
  const auto j = var<V_J, 1>(u[0]);
  const auto delta_dot = var<V_DDOT, 1>(u[1]);
  const auto e = core<LocalTrig>(P, px, py, phi, delta, v, s_r);
  jac_row<0>(d, dt, v * e.c_phi);
  jac_row<1>(d, dt, v * e.s_phi);
  jac_row<2>(d, dt, e.phi_dot);
  jac_row<3>(d, dt, delta_dot);
  jac_row<4>(d, dt, a + P.s[A_OFFSET]);
  jac_row<5>(d, dt, e.s_dot);
  jac_row<6>(d, dt, j);
}

template <class Trig, class TPRE = NoPre>
__device__ __forceinline__ void eval_dyn(const Prm& P, const real* x,
                                         const real* u, real* f,
                                         TPRE pre = TPRE{}) {
  const auto e = core<Trig>(P, x[0], x[1], x[2], x[3], x[4], x[5], pre);
  f[0] = x[4] * e.c_phi;
  f[1] = x[4] * e.s_phi;
  f[2] = e.phi_dot;
  f[3] = u[1];
  f[4] = x[6] + P.s[A_OFFSET];
  f[5] = e.s_dot;
  f[6] = u[0];
}

// one discrete step (ilqr._integrate)
template <class Trig>
__device__ void integrate(const Prm& P, const real* x, const real* u,
                          real dt, int integrator, real* xn) {
  real k1[NX], k2[NX], xt[NX];
  if constexpr (Trig::LANES) {
    if (integrator == 1) {          // HEUN, the warp's lanes in lock step
      // The yaw rate depends on (v, delta) alone, whose rates (a + a_offset
      // and delta_dot) are known before the first evaluation: lanes 0 and 1
      // form both evaluations' yaw rates in one pass (a tan and two
      // divisions), from the very values the two evaluations would use.
      const bool second = (threadIdx.x & (Trig::WIDTH - 1)) == 1;
      const real v2 = x[4] + dt * (x[6] + P.s[A_OFFSET]);
      const real delta2 = x[3] + dt * u[1];
      const real pd = yaw_rate(P, second ? v2 : x[4],
                                 second ? delta2 : x[3], NoPre{});
      const real pd1 = group_get<Trig::WIDTH>(pd, 0);
      const real pd2 = group_get<Trig::WIDTH>(pd, 1);
      eval_dyn<Trig>(P, x, u, k1, pd1);
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k1[i];
      eval_dyn<Trig>(P, xt, u, k2, pd2);
#pragma unroll
      for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt / R(2.0) * (k1[i] + k2[i]);
      return;
    }
  }
  eval_dyn<Trig>(P, x, u, k1);
  if (integrator == 0) {            // EULER
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt * k1[i];
    return;
  }
  if (integrator == 1) {            // HEUN
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k1[i];
    eval_dyn<Trig>(P, xt, u, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt / R(2.0) * (k1[i] + k2[i]);
    return;
  }
  real k3[NX], k4[NX];            // RK4
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt / R(2.0) * k1[i];
  eval_dyn<Trig>(P, xt, u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt / R(2.0) * k2[i];
  eval_dyn<Trig>(P, xt, u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k3[i];
  eval_dyn<Trig>(P, xt, u, k4);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    xn[i] = x[i] + dt / R(6.0)
                       * (((k1[i] + R(2.0) * k2[i]) + R(2.0) * k3[i]) + k4[i]);
}

// ---------------------------------------------------------------------
// shared-memory layout (reals)

// mu = 0 if mu_step == 0 else 10^(mu_step - 1), mu_step in [0, 7]
__device__ const real MU_OF_STEP[8] = {R(0.0), R(1.0), R(10.0), R(100.0),
                                       R(1e3), R(1e4),  R(1e5), R(1e6)};

struct Smem {
  real *xs, *us, *lam, *ulim, *bw, *cfg, *alphas, *scal, *tab;
  real *sad, *der, *kk, *KK, *cx, *cu, *cstep, *ccost;
  real *Vx, *Vxx, *A, *B, *Qx, *Qu, *Qxx, *Quu, *Qux;
  size_t in_len;                   // reals copied from the input
  size_t out_len;                  // reals of the packed result
};

__host__ __device__ inline size_t carve(real* base, int H, int n_ref,
                                        Smem* m) {
  size_t o = 0;
  auto take = [&](size_t n) {
    real* p = base ? base + o : nullptr;
    o += n;
    return p;
  };
  Smem s;
  s.xs = take((size_t)(H + 1) * NX);
  s.us = take((size_t)H * NU);
  s.lam = take((size_t)H * NC);
  s.ulim = take((size_t)H * NU * 2);
  s.bw = take(NC * 2);
  s.cfg = take(2);
  s.alphas = take(NA);
  s.scal = take(NSCAL);
  s.tab = take((size_t)NTAB * n_ref);
  s.in_len = o;
  s.sad = take((size_t)2 * n_ref);
  s.der = take((size_t)H * ND);
  s.kk = take((size_t)H * NU);
  s.KK = take((size_t)H * NU * NX);
  s.cx = take((size_t)NA * (H + 1) * NX);
  s.cu = take((size_t)NA * H * NU);
  s.cstep = take((size_t)NA * H);
  s.ccost = take(NA);
  s.Vx = take(NX);
  s.Vxx = take(NX * NX);
  s.A = take(NX * NX);
  s.B = take(NU * NX);
  s.Qx = take(NX);
  s.Qu = take(NU);
  s.Qxx = take(NX * NX);
  s.Quu = take(NU * NU);
  s.Qux = take(NU * NX);
  s.out_len = (size_t)(H + 1) * NX + (size_t)H * (NU + NC) + 3;
  if (m) *m = s;
  return o * sizeof(real);
}

// ---------------------------------------------------------------------
// the phases

// One dot product of 7 of the backward pass, as offsets (in reals) into
// the block's shared memory: out = [add +] sum_k a[k * sa] * b[k * sb].
// An operand that lives in the step's derivative block is marked relative
// and moves with the step.  Every lane of the warp runs the same code on
// its own descriptor, so no lane waits for another's branch; a stage's
// results are stored after all its rounds are formed, so that one round's
// loads do not wait for another's stores.
struct Dot {
  int a, sa, a_rel, b, sb, b_rel, add, add_rel, has_add, out;
};

__device__ __forceinline__ real dot7(const real* sm, const Dot& q,
                                       int step) {
  const real* a = sm + q.a + q.a_rel * step;
  const real* b = sm + q.b + q.b_rel * step;
  real s = R(0.0);
#pragma unroll
  for (int k = 0; k < NX; ++k) s += a[k * q.sa] * b[k * q.sb];
  const real add = sm[q.add + q.add_rel * step];
  return q.has_add ? add + s : s;
}

// the Riccati backward pass (ilqr.py backward) over steps n-1 .. 0, by the
// 32 lanes of one warp: 4 warp barriers per step, no block barrier.  The
// 72 + 67 dot products of 7 take 3 rounds each; a lane past the last item
// repeats it (the same value to the same place).  step_of(t), called by
// every lane at the top of step t, returns the offset of step t's dense
// block from m.der (the single solve: t * ND; the batch forms the block in
// m.der there and returns 0).
template <class StepOf>
__device__ __forceinline__ void backward_steps(real* sm, const Smem& m, int n,
                                               real mu, StepOf&& step_of) {
  const int lane = threadIdx.x & (WARP - 1);
  const int der = (int)(m.der - sm);
  auto at = [&](const real* p) { return (int)(p - sm); };
  constexpr int N1 = NX * NX + NU * NX + NX + NU;    // A, B, Qx, Qu
  constexpr int N2 = NX * NX + NU * NU + NU * NX;    // Qxx, Quu, Qux
  constexpr int R1 = (N1 + WARP - 1) / WARP, R2 = (N2 + WARP - 1) / WARP;
  Dot s1[R1], s2[R2];
#pragma unroll
  for (int r = 0; r < R1; ++r) {
    int e = lane + r * WARP;
    e = e < N1 ? e : N1 - 1;
    const int b = e - NX * NX, c = e - (NX * NX + NU * NX);
    const int d = c - NX;
    s1[r] = e < NX * NX                    // A = fx^T Vxx
                ? Dot{der + D_FX + e / NX, NX, 1, at(m.Vxx) + e % NX, NX, 0,
                      der, 1, 0, at(m.A) + e}
            : b < NU * NX                  // B = fu^T Vxx
                ? Dot{der + D_FU + b / NX, NU, 1, at(m.Vxx) + b % NX, NX, 0,
                      der, 1, 0, at(m.B) + b}
            : c < NX                       // Qx = lx + fx^T Vx
                ? Dot{der + D_FX + c, NX, 1, at(m.Vx), 1, 0, der + D_LX + c,
                      1, 1, at(m.Qx) + c}
                                           // Qu = lu + fu^T Vx
                : Dot{der + D_FU + d, NU, 1, at(m.Vx), 1, 0, der + D_LU + d,
                      1, 1, at(m.Qu) + d};
  }
#pragma unroll
  for (int r = 0; r < R2; ++r) {
    int e = lane + r * WARP;
    e = e < N2 ? e : N2 - 1;
    const int b = e - NX * NX, c = b - NU * NU;
    s2[r] = e < NX * NX                    // Qxx = lxx + A fx
                ? Dot{at(m.A) + (e / NX) * NX, 1, 0, der + D_FX + e % NX, NX,
                      1, der + D_LXX + e, 1, 1, at(m.Qxx) + e}
            : b < NU * NU                  // Quu = luu + B fu
                ? Dot{at(m.B) + (b / NU) * NX, 1, 0, der + D_FU + b % NU, NU,
                      1, der + D_LUU + b, 1, 1, at(m.Quu) + b}
                                           // Qux = lux + B fx
                : Dot{at(m.B) + (c / NX) * NX, 1, 0, der + D_FX + c % NX, NX,
                      1, der + D_LUX + c, 1, 1, at(m.Qux) + c};
  }
  // this lane's gain entry (a lane past the last repeats it) and its
  // entries of the value update
  const int ke = lane < NU * NX ? lane : NU * NX - 1;
  const int ki = ke / NX, kj = ke % NX;
  const int v1 = lane + WARP < NX * NX ? lane + WARP : NX * NX - 1;

  for (int i = lane; i < NX * NX; i += WARP) m.Vxx[i] = R(0.0);
  if (lane < NX) m.Vx[lane] = R(0.0);
  __syncwarp();
  for (int t = n - 1; t >= 0; --t) {
    const int step = step_of(t);
    real* K = m.KK + (size_t)t * NU * NX;
    // A = fx^T Vxx, B = fu^T Vxx, Qx = lx + fx^T Vx, Qu = lu + fu^T Vx
    {
      real res[R1];
#pragma unroll
      for (int r = 0; r < R1; ++r) res[r] = dot7(sm, s1[r], step);
#pragma unroll
      for (int r = 0; r < R1; ++r) sm[s1[r].out] = res[r];
    }
    __syncwarp();
    // Qxx = lxx + A fx, Quu = luu + B fu, Qux = lux + B fx
    {
      real res[R2];
#pragma unroll
      for (int r = 0; r < R2; ++r) res[r] = dot7(sm, s2[r], step);
#pragma unroll
      for (int r = 0; r < R2; ++r) sm[s2[r].out] = res[r];
    }
    __syncwarp();
    // the action solve (nu == 2 closed form) and the control-limit clamp:
    // every lane forms the inverse and both feedforward terms, then its
    // gain entry; lanes 14 and 15 store the feedforward terms
    {
      const real a = m.Quu[0] + mu, b = m.Quu[1], dd = m.Quu[3] + mu;
      const real det = a * dd - b * b;
      const real inv_det = -R(1.0) / det;
      const real inv[4] = {dd * inv_det, -b * inv_det, -b * inv_det,
                             a * inv_det};
      const real* ut = m.us + t * NU;
      const real* lim = m.ulim + t * NU * 2;
      real kv[NU];
      bool hit[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        real s = R(0.0);
#pragma unroll
        for (int r = 0; r < NU; ++r) s += inv[i * NU + r] * m.Qu[r];
        kv[i] = s;
        const real c = ut[i] + kv[i];
        const real lo = lim[2 * i], hi = lim[2 * i + 1];
        const bool over = c > hi, under = c < lo;
        if (over) kv[i] = hi - ut[i];
        if (under) kv[i] = lo - ut[i];
        hit[i] = over || under;
      }
      const real inv_i[NU] = {ki ? inv[2] : inv[0], ki ? inv[3] : inv[1]};
      real sk = R(0.0);
#pragma unroll
      for (int r = 0; r < NU; ++r) sk += inv_i[r] * m.Qux[r * NX + kj];
      K[ke] = (ki ? hit[1] : hit[0]) ? R(0.0) : sk;
      if (lane >= NU * NX && lane < NU * NX + NU)
        m.kk[t * NU + (lane - NU * NX)] = lane == NU * NX ? kv[0] : kv[1];
    }
    __syncwarp();
    // Vxx = Qxx + KQux + KQux^T + KtQuu K with KQux = K^T Qux and
    // KtQuu = K^T Quu formed by the lane that needs them (2 rounds), then
    // Vx = KtQuu k + K^T Qu + Qux^T k + Qx on lanes 0-6
    real vxx[2], vx = R(0.0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = r == 0 ? lane : v1;
      const int i = e / NX, j = e % NX;
      real ktq[NU];                 // row i of K^T Quu
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        real s = R(0.0);
#pragma unroll
        for (int q = 0; q < NU; ++q) s += K[q * NX + i] * m.Quu[q * NU + c];
        ktq[c] = s;
      }
      real kq_ij = R(0.0), kq_ji = R(0.0), s = R(0.0);
#pragma unroll
      for (int q = 0; q < NU; ++q) kq_ij += K[q * NX + i] * m.Qux[q * NX + j];
#pragma unroll
      for (int q = 0; q < NU; ++q) kq_ji += K[q * NX + j] * m.Qux[q * NX + i];
#pragma unroll
      for (int q = 0; q < NU; ++q) s += ktq[q] * K[q * NX + j];
      vxx[r] = ((m.Qxx[e] + kq_ij) + kq_ji) + s;
    }
    if (lane < NX) {
      const int i = lane;
      const real* k = m.kk + t * NU;
      real ktq[NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        real s = R(0.0);
#pragma unroll
        for (int q = 0; q < NU; ++q) s += K[q * NX + i] * m.Quu[q * NU + c];
        ktq[c] = s;
      }
      real s1v = R(0.0), s2v = R(0.0), s3v = R(0.0);
#pragma unroll
      for (int q = 0; q < NU; ++q) s1v += ktq[q] * k[q];
#pragma unroll
      for (int q = 0; q < NU; ++q) s2v += K[q * NX + i] * m.Qu[q];
#pragma unroll
      for (int q = 0; q < NU; ++q) s3v += m.Qux[q * NX + i] * k[q];
      vx = ((s1v + s2v) + s3v) + m.Qx[i];
    }
    m.Vxx[lane] = vxx[0];
    m.Vxx[v1] = vxx[1];
    if (lane < NX) m.Vx[lane] = vx;
    __syncwarp();
  }
}

// the single solve's backward pass: the dense blocks of every step lie one
// after the other from m.der
__device__ void backward_warp(real* sm, const Smem& m, int n, real mu) {
  backward_steps(sm, m, n, mu, [](int t) { return t * ND; });
}

// the open-loop rollout with the current controls (no clamp), frozen
// beyond T, by every lane of the calling warp in lock step
__device__ void open_rollout(const Prm& P, const Smem& m, int H, int T,
                             int integrator) {
  const bool lane0 = (threadIdx.x & (WARP - 1)) == 0;
  real x[NX], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = m.xs[i];
  for (int t = 0; t < H; ++t) {
    if (t < T) {
      real u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = m.us[t * NU + i];
      integrate<WarpTrig>(P, x, u, m.cfg[0], integrator, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    if (lane0)
#pragma unroll
      for (int i = 0; i < NX; ++i) m.xs[(t + 1) * NX + i] = x[i];
  }
}

// the closed-loop rollout at step size alpha (ilqr.py fb_rollouts) into
// cx, cu, by every lane of the calling group (Trig: the warp or a group of
// lanes) in lock step; the group's lane 0 stores
template <class Trig>
__device__ __forceinline__ void rollout_group(const Prm& P, const Smem& m,
                                              int H, int T, real alpha,
                                              real* cx, real* cu,
                                              int integrator) {
  const bool lane0 = (threadIdx.x & (Trig::WIDTH - 1)) == 0;
  const real dt = m.cfg[0];
  real x[NX], u[NU], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = m.xs[i];
  if (lane0)
#pragma unroll
    for (int i = 0; i < NX; ++i) cx[i] = x[i];
  for (int t = 0; t < H; ++t) {
    const real* ur = m.us + t * NU;
    if (t < T) {
      const real* xr = m.xs + t * NX;
      const real* k = m.kk + t * NU;
      const real* K = m.KK + (size_t)t * NU * NX;
      const real* lim = m.ulim + t * NU * 2;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        real s = R(0.0);
#pragma unroll
        for (int j = 0; j < NX; ++j) s += (x[j] - xr[j]) * K[i * NX + j];
        u[i] = clampd((ur[i] + alpha * k[i]) + s, lim[2 * i], lim[2 * i + 1]);
      }
      integrate<Trig>(P, x, u, dt, integrator, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    } else {
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = ur[i];
    }
    if (lane0) {
#pragma unroll
      for (int i = 0; i < NU; ++i) cu[t * NU + i] = u[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) cx[(t + 1) * NX + i] = x[i];
    }
  }
}

// the single solve's candidate c: its closed-loop rollout at alpha_c
// (ilqr.py fb_rollouts), by every lane of the calling warp in lock step;
// lane 0 stores.  rollout_group<WarpTrig> is the same rollout; the single
// kernel keeps this function of its own because built from the template
// it ran 0.3 % slower on the card (the same bits).
__device__ void fb_rollout(const Prm& P, const Smem& m, int H, int T, int c,
                           int integrator) {
  const bool lane0 = (threadIdx.x & (WARP - 1)) == 0;
  const real dt = m.cfg[0];
  const real alpha = m.alphas[c];
  real* cx = m.cx + (size_t)c * (H + 1) * NX;
  real* cu = m.cu + (size_t)c * H * NU;
  real x[NX], u[NU], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = m.xs[i];
  if (lane0)
#pragma unroll
    for (int i = 0; i < NX; ++i) cx[i] = x[i];
  for (int t = 0; t < H; ++t) {
    const real* ur = m.us + t * NU;
    if (t < T) {
      const real* xr = m.xs + t * NX;
      const real* k = m.kk + t * NU;
      const real* K = m.KK + (size_t)t * NU * NX;
      const real* lim = m.ulim + t * NU * 2;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        real s = R(0.0);
#pragma unroll
        for (int j = 0; j < NX; ++j) s += (x[j] - xr[j]) * K[i * NX + j];
        u[i] = clampd((ur[i] + alpha * k[i]) + s, lim[2 * i], lim[2 * i + 1]);
      }
      integrate<WarpTrig>(P, x, u, dt, integrator, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    } else {
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = ur[i];
    }
    if (lane0) {
#pragma unroll
      for (int i = 0; i < NU; ++i) cu[t * NU + i] = u[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) cx[(t + 1) * NX + i] = x[i];
    }
  }
}

// One solve, one block of THREADS threads: the packed input `in`, the
// packed result `out`, the starting mu_step.
template <bool PROF>
__global__ void __launch_bounds__(THREADS)
ilqr_tracking_mpc_kernel(const real* __restrict__ in,
                         real* __restrict__ out, long long* prof, int H,
                         int n_ref, int T, int max_it, int max_lg,
                         int mu_step, int integrator) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  PhaseClock<PROF> pc;
  pc.start();
  Smem m;
  carve(sm, H, n_ref, &m);
  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), warp = tid / WARP;
  const Prm P{m.scal, m.tab, m.sad, n_ref};
  const int Te = T < H ? T : H;   // steps that move (T may exceed H)

  for (size_t i = tid; i < m.in_len; i += blockDim.x) sm[i] = in[i];
  __syncthreads();
  tabulate_angle_dist(m.tab, m.sad, n_ref);
  __syncthreads();
  pc.stamp(PH_LOAD);

  // initial rollout, and its cost with the OLD multipliers; every thread
  // keeps the trajectory cost, mu_step and the iteration count for itself
  if (warp == 0) open_rollout(P, m, H, T, integrator);
  __syncthreads();
  for (int t = tid; t < H; t += blockDim.x)
    m.cstep[t] = t < T ? step_cost(P, m.xs + t * NX, m.us + t * NU,
                                   m.lam + t * NC, m.bw)
                       : R(0.0);
  __syncthreads();
  real cur = R(0.0);
  for (int t = 0; t < Te; ++t) cur += m.cstep[t];
  int ms = mu_step < 0 ? 0 : (mu_step > 7 ? 7 : mu_step), iterations = 0;
  pc.stamp(PH_INIT);

  for (int lg = 0; lg < max_lg; ++lg) {
    // clipped multiplier update on the active steps
    for (int k = tid; k < Te * NC; k += blockDim.x) {
      const int t = k / NC, i = k % NC;
      const real* x = m.xs + t * NX;
      const real g = i == 0 ? x[3] - P.s[MAX_DELTA]
                     : i == 1 ? (-P.s[MAX_DELTA]) - x[3]
                     : i == 2 ? x[6] - P.s[MAX_ACC]
                              : P.s[MIN_ACC] - x[6];
      real y = m.lam[k] + m.bw[2 * i] * g;
      y = y < R(0.0) ? R(0.0) : y;
      m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
    }
    __syncthreads();
    pc.stamp(PH_LAM);

    for (int it = 0; it < max_it; ++it) {
      // derivatives of the active steps: warps 0-1 the cost's, warps 2-3
      // the dynamics'
      if (warp < 2) {
        for (int t = tid; t < Te; t += 2 * WARP)
          deriv_cost(P, m.xs + t * NX, m.us + t * NU, m.lam + t * NC, m.bw,
                     HessAcc{m.der + (size_t)t * ND});
      } else if (warp < 4) {
        for (int t = tid - 2 * WARP; t < Te; t += 2 * WARP)
          deriv_dyn(P, m.xs + t * NX, m.us + t * NU, m.cfg[0],
                    DenseJac{m.der + (size_t)t * ND});
      }
      __syncthreads();
      pc.stamp(PH_DERIV);

      // the backward pass on warp 0; the others zero the gains of the
      // frozen steps
      if (warp == 0) {
        backward_warp(sm, m, Te, MU_OF_STEP[ms]);
      } else {
        for (int i = Te * NU + (tid - WARP); i < H * NU; i += THREADS - WARP)
          m.kk[i] = R(0.0);
        for (int i = Te * NU * NX + (tid - WARP); i < H * NU * NX;
             i += THREADS - WARP)
          m.KK[i] = R(0.0);
      }
      __syncthreads();
      pc.stamp(PH_RICCATI);

      // line search: warp c rolls candidate c out, takes its step costs
      // and sums them in step order
      if (warp < NA) {
        fb_rollout(P, m, H, T, warp, integrator);
        __syncwarp();
        pc.stamp(PH_ROLLOUT);
        const real* cx = m.cx + (size_t)warp * (H + 1) * NX;
        const real* cu = m.cu + (size_t)warp * H * NU;
        real* cs = m.cstep + (size_t)warp * H;
        for (int t = lane; t < Te; t += WARP)
          cs[t] = step_cost(P, cx + t * NX, cu + t * NU, m.lam + t * NC,
                            m.bw);
        __syncwarp();
        pc.stamp(PH_STEP_COST);
        if (lane == 0) {
          real s = R(0.0);
          for (int t = 0; t < Te; ++t) s += cs[t];
          m.ccost[warp] = s;
        }
      }
      __syncthreads();
      pc.stamp(PH_COST_SUM);

      // the first improving alpha, the mu schedule and the termination
      // test, by every thread; then the accepted candidate's copy
      int pick = -1;
      for (int c = NA - 1; c >= 0; --c) {
        const real cc = m.ccost[c];
        if (cc < cur && isfinite(cc) && cc >= R(0.0)) pick = c;
      }
      real nc = cur;
      if (pick >= 0) {
        nc = m.ccost[pick];
        ms = ms - 1 > 0 ? ms - 1 : 0;
      } else {
        ms = ms + 1 < 7 ? ms + 1 : 7;
      }
      const real denom = nc == R(0.0) ? R(1.0) : nc;
      const real rel = fabs(nc - cur) / denom;
      cur = nc;
      iterations += 1;
      if (pick >= 0) {
        const real* cx = m.cx + (size_t)pick * (H + 1) * NX;
        const real* cu = m.cu + (size_t)pick * H * NU;
        for (int i = tid; i < (H + 1) * NX; i += blockDim.x) m.xs[i] = cx[i];
        for (int i = tid; i < H * NU; i += blockDim.x) m.us[i] = cu[i];
      }
      __syncthreads();
      pc.stamp(PH_PICK);
      if (rel < m.cfg[1]) break;
    }
  }

  // outputs: x, u, lam, mu_step, traj_costs, iterations
  const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NC;
  for (int i = tid; i < nxo; i += blockDim.x) out[i] = m.xs[i];
  for (int i = tid; i < nuo; i += blockDim.x) out[nxo + i] = m.us[i];
  for (int i = tid; i < nlo; i += blockDim.x) out[nxo + nuo + i] = m.lam[i];
  if (tid == 0) {
    out[nxo + nuo + nlo] = ms;
    out[nxo + nuo + nlo + 1] = cur;
    out[nxo + nuo + nlo + 2] = iterations;
  }
  pc.stamp(PH_STORE);
  pc.store(prof);
}

// ---------------------------------------------------------------------
// the batched kernel: a warp per scenario, persistent
//
// A block keeps what every scenario of the batch shares once (the control
// limits, barrier weights, step and tolerance, step sizes, reference tables
// and their angle distances) and one region per warp ("slot").  A warp
// takes its next scenario from the atomic counter `work` until the batch is
// done, so a scenario that stops early frees its warp at once; the order
// in which scenarios are taken changes no result.  Inside a scenario only
// __syncwarp(): warps leave their loops at different iterations, and the
// block's two barriers come before the loop.
//
// The solve is the single solve's, operation for operation, by the per-warp
// functions above (open_rollout, backward_steps, rollout_group, step_cost,
// deriv_cost, deriv_dyn), so a float64 scenario returns the bits of a
// single launch.  What differs is where the work sits:
// - derivatives: CHUNK steps at a time, inside the backward pass: at the top
//   of each chunk the lanes take the cost's and the dynamics' derivatives
//   of its steps (float64, 16 steps: lanes 0-15 the cost's, 16-31 the
//   dynamics'; float32, 32 steps: every lane both of one step) into
//   compact blocks (NCMP reals a step); each step's dense block is then
//   expanded into the warp's scratch before its dot products, which read
//   the same values in the same order;
// - line search: the candidates in order, NG at a time (float64 two, on
//   the half-warps; float32 four, on quarters), each group of lanes in lock
//   step as a warp is in the single solve, with exchanges of the group's
//   width; each is rolled, its step costs summed in step order, and the
//   first improving one is taken (the plain version's argmax over
//   `improving`), so NG candidate buffers serve and a search stops with
//   the round that holds its pick (on the bench's course alpha = 1 mostly
//   fails and 0.1 succeeds: one round);
// - the backward pass's region (compact blocks, dense block, Riccati
//   scratch) and the line search's (the candidates, their step costs)
//   overlap: an accepted candidate is copied into the state.

// The steps whose compact blocks are held at a time, and the candidates
// rolled side by side: each as large as fits without lowering the
// scenarios an SM holds (8, which the registers cap).  In float64, chunks
// of 32 steps would take it to 7 scenarios and four candidates to 6.
constexpr int CHUNK = sizeof(real) == sizeof(double) ? 16 : 32;
constexpr int NG = sizeof(real) == sizeof(double) ? 2 : 4;
constexpr int GW = WARP / NG;      // lanes of a candidate's group
// scenarios (warps) of a block at most: 8 warps of 255 registers fill an
// SM's register file
constexpr int MAX_SLOTS = 8;
constexpr int XR = (ND + WARP - 1) / WARP;   // dense entries a lane expands

// the packed batch (tpl_tpu_torch/optim/ilqr_tracking_mpc.py
// batched_layout): the shared part, u_lims (H, 2, 2), bw_lim (4, 2), cfg_f
// (2), alphas (8), tables (5, n_ref); and a row per scenario, x0 (7), u
// (H, 2), lam (H, 4), scalars (18)
__host__ __device__ inline size_t batch_shared_len(int H, int n_ref) {
  return (size_t)H * NU * 2 + NC * 2 + 2 + NA + (size_t)NTAB * n_ref;
}
__host__ __device__ inline size_t batch_row_len(int H) {
  return NX + (size_t)H * (NU + NC) + NSCAL;
}

// a scenario's region: its state, scalars and gains, then one part the
// backward pass (`dense` dense derivative blocks at m->der, compact blocks
// for `steps` steps into *cmp) and the line search (`cands` candidate
// buffers) take in turn.  Returns its reals.
__host__ __device__ inline size_t carve_region(real* base, int H, int dense,
                                               int steps, int cands, Smem* m,
                                               real** cmp) {
  size_t o = 0;
  auto take = [&](size_t n) {
    real* p = base ? base + o : nullptr;
    o += n;
    return p;
  };
  Smem s{};
  s.xs = take((size_t)(H + 1) * NX);
  s.us = take((size_t)H * NU);
  s.lam = take((size_t)H * NC);
  s.scal = take(NSCAL);
  s.kk = take((size_t)H * NU);
  s.KK = take((size_t)H * NU * NX);
  const size_t common = o;
  s.der = take((size_t)dense * ND);
  real* c = take((size_t)steps * NCMP);
  s.Vx = take(NX);
  s.Vxx = take(NX * NX);
  s.A = take(NX * NX);
  s.B = take(NU * NX);
  s.Qx = take(NX);
  s.Qu = take(NU);
  s.Qxx = take(NX * NX);
  s.Quu = take(NU * NU);
  s.Qux = take(NU * NX);
  const size_t backward = o;
  o = common;
  s.cx = take((size_t)cands * (H + 1) * NX);   // a candidate a lane group
  s.cu = take((size_t)cands * H * NU);
  s.cstep = take((size_t)cands * H);
  o = o > backward ? o : backward;
  if (m) *m = s;
  if (cmp) *cmp = c;
  return o;
}
// a warp's slot: CHUNK steps' compact blocks, NG candidates
__host__ __device__ inline size_t carve_slot(real* base, int H, Smem* m,
                                             real** cmp) {
  return carve_region(base, H, 1, CHUNK, NG, m, cmp);
}

// reals of a block's shared part (with the angle distances and the
// expansion's constants) and of a slot
__host__ __device__ inline size_t batch_shared_reals(int H, int n_ref) {
  return batch_shared_len(H, n_ref) + (size_t)2 * n_ref + NKONST;
}
__host__ __device__ inline size_t batch_slot_reals(int H) {
  return carve_slot(nullptr, H, nullptr, nullptr);
}
// dynamic shared memory of a block of `slots` scenarios
__host__ __device__ inline size_t batch_smem_bytes(int H, int n_ref,
                                                   int slots) {
  return (batch_shared_reals(H, n_ref) + (size_t)slots * batch_slot_reals(H))
         * sizeof(real);
}

// The block's copy of the part every scenario shares, its angle distances
// and the expansion's constants, at sm (batch_shared_reals); every thread
// of the block calls it, before any scenario's loop.  Points m's shared
// fields there and returns the constants (konst[-1 - X_*]).
__device__ real* load_shared(real* sm, const real* __restrict__ shared,
                             int H, int n_ref, Smem& m) {
  const size_t n_shared = batch_shared_len(H, n_ref);
  for (size_t i = threadIdx.x; i < n_shared; i += blockDim.x)
    sm[i] = shared[i];
  m.ulim = sm;
  m.bw = m.ulim + (size_t)H * NU * 2;
  m.cfg = m.bw + NC * 2;
  m.alphas = m.cfg + 2;
  m.tab = m.alphas + NA;
  m.sad = sm + n_shared;
  real* const konst = m.sad + 2 * n_ref;
  __syncthreads();
  tabulate_angle_dist(m.tab, m.sad, n_ref);
  if (threadIdx.x == 0) {         // the dense block's fixed entries
    const real dt = m.cfg[0];
    konst[-1 - X_ONE] = R(1.0) + dt * R(0.0);
    konst[-1 - X_FX_ZERO] = R(0.0) + dt * R(0.0);
    konst[-1 - X_FU_ZERO] = dt * R(0.0);
    konst[-1 - X_ZERO] = R(0.0);
  }
  __syncthreads();
  return konst;
}

// the phases of one warp's scenario in the profiling instantiation (lane 0
// of the warp that takes scenario 0): BP_CAND + r is candidates NG r ..
// NG r + NG - 1's rollouts, step costs and sums.  prof[N_BPHASE + k] then
// counts the line searches of the whole batch whose pick was candidate k
// (k = NA - 1 also those that found none): the sequential search rolls
// k + 1.
enum BatchPhase {
  BP_LOAD, BP_INIT, BP_LAM, BP_DERIV, BP_EXPAND, BP_RICCATI, BP_CAND,
  BP_PICK = BP_CAND + NA / NG, BP_STORE, N_BPHASE
};

template <bool PROF>
struct WarpClock {
  bool on = false;
  long long last = 0;
  long long acc[PROF ? N_BPHASE : 1];

  __device__ __forceinline__ void start(bool rec) {
    if constexpr (PROF) {
      on = rec && (threadIdx.x & (WARP - 1)) == 0;
      for (int i = 0; i < N_BPHASE; ++i) acc[i] = 0;
      last = clock64();
    }
  }
  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (PROF) {
      if (on) {
        const long long now = clock64();
        acc[phase] += now - last;
        last = now;
      }
    }
  }
  __device__ __forceinline__ void store(long long* out) const {
    if constexpr (PROF) {
      if (on)
        for (int i = 0; i < N_BPHASE; ++i) out[i] = acc[i];
    }
  }
};

// B scenarios: `shared` the shared part, `rows` B rows, `out` B packed
// results (the single solve's layout), mu_steps[b] scenario b's starting
// mu_step, *work zero at the launch (the next scenario to take).  A block
// has blockDim.x / 32 slots and batch_smem_bytes() of dynamic shared memory.
// (__launch_bounds__ with one block an SM lets a thread have 255 registers:
// without it the float32 instantiation kept to 128 and spilled, and two
// such blocks an SM ran slower than one block that does not spill.)
template <bool PROF>
__global__ void __launch_bounds__(MAX_SLOTS * WARP, 1)
ilqr_tracking_mpc_batched_kernel(const real* __restrict__ shared,
                                 const real* __restrict__ rows,
                                 real* __restrict__ out,
                                 const int* __restrict__ mu_steps, int* work,
                                 long long* prof, int B, int H, int n_ref,
                                 int T, int max_it, int max_lg,
                                 int integrator) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  const int lane = threadIdx.x & (WARP - 1), slot = threadIdx.x / WARP;
  Smem m;
  real* cmp;
  carve_slot(sm + batch_shared_reals(H, n_ref)
                 + (size_t)slot * batch_slot_reals(H),
             H, &m, &cmp);
  const real* const konst = load_shared(sm, shared, H, n_ref, m);
  const Prm P{m.scal, m.tab, m.sad, n_ref};
  const int Te = T < H ? T : H;   // steps that move (T may exceed H)
  const size_t row_len = batch_row_len(H);
  const size_t out_len = (size_t)(H + 1) * NX + (size_t)H * (NU + NC) + 3;
  int xcode[XR];                  // how this lane forms its dense entries
#pragma unroll
  for (int r = 0; r < XR; ++r)
    xcode[r] = lane + r * WARP < ND ? expand_code(lane + r * WARP) : X_ZERO;

  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(work, 1);
    b = lane_get(b, 0);
    if (b >= B) break;
    WarpClock<PROF> pc;
    pc.start(b == 0);

    // x0, u, lam and the scalars; the gains of the frozen steps stay zero
    const real* in = rows + (size_t)b * row_len;
    for (int i = lane; i < NX; i += WARP) m.xs[i] = in[i];
    for (int i = lane; i < H * NU; i += WARP) m.us[i] = in[NX + i];
    for (int i = lane; i < H * NC; i += WARP) m.lam[i] = in[NX + H * NU + i];
    for (int i = lane; i < NSCAL; i += WARP)
      m.scal[i] = in[NX + H * (NU + NC) + i];
    for (int i = Te * NU + lane; i < H * NU; i += WARP) m.kk[i] = R(0.0);
    for (int i = Te * NU * NX + lane; i < H * NU * NX; i += WARP)
      m.KK[i] = R(0.0);
    __syncwarp();
    pc.stamp(BP_LOAD);

    // initial rollout, and its cost with the OLD multipliers
    open_rollout(P, m, H, T, integrator);
    __syncwarp();
    for (int t = lane; t < H; t += WARP)
      m.cstep[t] = t < T ? step_cost(P, m.xs + t * NX, m.us + t * NU,
                                     m.lam + t * NC, m.bw)
                         : R(0.0);
    __syncwarp();
    real cur = R(0.0);
    for (int t = 0; t < Te; ++t) cur += m.cstep[t];
    int ms = mu_steps[b], iterations = 0;
    ms = ms < 0 ? 0 : (ms > 7 ? 7 : ms);
    pc.stamp(BP_INIT);

    for (int lg = 0; lg < max_lg; ++lg) {
      // clipped multiplier update on the active steps
      for (int k = lane; k < Te * NC; k += WARP) {
        const int t = k / NC, i = k % NC;
        const real* x = m.xs + t * NX;
        const real g = i == 0 ? x[3] - P.s[MAX_DELTA]
                       : i == 1 ? (-P.s[MAX_DELTA]) - x[3]
                       : i == 2 ? x[6] - P.s[MAX_ACC]
                                : P.s[MIN_ACC] - x[6];
        real y = m.lam[k] + m.bw[2 * i] * g;
        y = y < R(0.0) ? R(0.0) : y;
        m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
      }
      __syncwarp();
      pc.stamp(BP_LAM);

      for (int it = 0; it < max_it; ++it) {
        // the backward pass; at the top of each chunk of CHUNK steps the
        // chunk's derivatives, at each step its dense block
        int lo = 0;                   // the chunk's first step
        backward_steps(sm, m, Te, MU_OF_STEP[ms], [&](int t) {
          pc.stamp(BP_RICCATI);
          if (t == Te - 1 || t == lo - 1) {
            lo = t - CHUNK + 1 > 0 ? t - CHUNK + 1 : 0;
            for (int k = lane; k < 2 * CHUNK; k += WARP) {
              const int s = lo + k % CHUNK;
              real* c = cmp + (size_t)(k % CHUNK) * NCMP;
              if (s > t) continue;
              if (k < CHUNK)
                deriv_cost(P, m.xs + s * NX, m.us + s * NU, m.lam + s * NC,
                           m.bw, CompactHessAcc{c});
              else
                deriv_dyn(P, m.xs + s * NX, m.us + s * NU, m.cfg[0],
                          CompactJac{c});
            }
            __syncwarp();
            pc.stamp(BP_DERIV);
          }
          const real* c = cmp + (size_t)(t - lo) * NCMP;
#pragma unroll
          for (int r = 0; r < XR; ++r) {
            const int e = lane + r * WARP, x = xcode[r];
            if (e < ND) m.der[e] = x >= 0 ? c[x] : konst[-1 - x];
          }
          __syncwarp();
          pc.stamp(BP_EXPAND);
          return 0;
        });
        pc.stamp(BP_RICCATI);

        // line search: the first improving candidate, in order, NG at a
        // time: lane group g rolls candidate NG r + g into its buffer
        int pick = -1;
        real nc = cur;
        const int grp = lane / GW;
        for (int r = 0; r < NA / NG && pick < 0; ++r) {
          rollout_group<GroupTrig<GW>>(P, m, H, T, m.alphas[NG * r + grp],
                                       m.cx + (size_t)grp * (H + 1) * NX,
                                       m.cu + (size_t)grp * H * NU,
                                       integrator);
          __syncwarp();
          for (int k = lane; k < NG * Te; k += WARP) {
            const int g = k / Te, t = k % Te;
            m.cstep[g * H + t] =
                step_cost(P, m.cx + ((size_t)g * (H + 1) + t) * NX,
                          m.cu + ((size_t)g * H + t) * NU, m.lam + t * NC,
                          m.bw);
          }
          __syncwarp();
          real own = R(0.0);            // this group's candidate, in order
          for (int t = 0; t < Te; ++t) own += m.cstep[grp * H + t];
          pc.stamp(BP_CAND + r);
          for (int g = 0; g < NG; ++g) {
            const real sg = lane_get(own, g * GW);
            if (pick < 0 && sg < cur && isfinite(sg) && sg >= R(0.0)) {
              pick = NG * r + g;
              nc = sg;
            }
          }
        }
        if constexpr (PROF) {
          if (lane == 0)
            atomicAdd(reinterpret_cast<unsigned long long*>(prof)
                          + N_BPHASE + (pick >= 0 ? pick : NA - 1),
                      1ull);
        }

        // the mu schedule and the termination test, by every lane; then
        // the accepted candidate's copy
        if (pick >= 0)
          ms = ms - 1 > 0 ? ms - 1 : 0;
        else
          ms = ms + 1 < 7 ? ms + 1 : 7;
        const real denom = nc == R(0.0) ? R(1.0) : nc;
        const real rel = fabs(nc - cur) / denom;
        cur = nc;
        iterations += 1;
        if (pick >= 0) {
          const real* cx = m.cx + (size_t)(pick % NG) * (H + 1) * NX;
          const real* cu = m.cu + (size_t)(pick % NG) * H * NU;
          for (int i = lane; i < (H + 1) * NX; i += WARP) m.xs[i] = cx[i];
          for (int i = lane; i < H * NU; i += WARP) m.us[i] = cu[i];
        }
        __syncwarp();
        pc.stamp(BP_PICK);
        if (rel < m.cfg[1]) break;
      }
    }

    // outputs: x, u, lam, mu_step, traj_costs, iterations
    real* o = out + (size_t)b * out_len;
    const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NC;
    for (int i = lane; i < nxo; i += WARP) o[i] = m.xs[i];
    for (int i = lane; i < nuo; i += WARP) o[nxo + i] = m.us[i];
    for (int i = lane; i < nlo; i += WARP) o[nxo + nuo + i] = m.lam[i];
    if (lane == 0) {
      o[nxo + nuo + nlo] = ms;
      o[nxo + nuo + nlo + 1] = cur;
      o[nxo + nuo + nlo + 2] = iterations;
    }
    __syncwarp();
    pc.stamp(BP_STORE);
    pc.store(prof);
  }
}

// ---------------------------------------------------------------------
// The team geometry, for a batch that leaves warps idle (the launcher takes
// it when every scenario can have a block of its own at once): a block of
// TEAM warps solves one scenario, blockIdx.x.  With room to spare it keeps
// the single solve's dense derivative blocks, every step's: the first half
// of the threads take the cost's derivatives, the second half the
// dynamics', a step a thread, and warp 0 runs the single solve's backward
// pass on them (no expansion); then all NA candidates are rolled at once,
// warp w's lane group g taking candidate NG w + g, so a line search is one
// round.  The same functions on the same inputs as the single solve and
// the warp-per-scenario kernel, the candidates' sums read in order: the
// same pick and the same bits.  A block is one scenario, so its barriers
// are __syncthreads().
constexpr int TEAM = NA / NG;

// a team's region (dense blocks for H steps, NA candidates) and the
// candidates' sums after it
__host__ __device__ inline size_t team_region_reals(int H) {
  return carve_region(nullptr, H, H, 0, NA, nullptr, nullptr);
}
__host__ __device__ inline size_t team_smem_bytes(int H, int n_ref) {
  return (batch_shared_reals(H, n_ref) + team_region_reals(H) + NA)
         * sizeof(real);
}

// B scenarios, a block each, as ilqr_tracking_mpc_batched_kernel takes
// them (prof: thread 0 of the block on scenario 0, the histogram likewise);
// TEAM warps a block, team_smem_bytes() of dynamic shared memory.
template <bool PROF>
__global__ void __launch_bounds__(TEAM * WARP)
ilqr_tracking_mpc_team_kernel(const real* __restrict__ shared,
                              const real* __restrict__ rows,
                              real* __restrict__ out,
                              const int* __restrict__ mu_steps,
                              long long* prof, int B, int H, int n_ref, int T,
                              int max_it, int max_lg, int integrator) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  const int b = blockIdx.x;
  if (b >= B) return;
  Smem m;
  real* const region = sm + batch_shared_reals(H, n_ref);
  carve_region(region, H, H, 0, NA, &m, nullptr);
  real* const sums = region + team_region_reals(H);
  load_shared(sm, shared, H, n_ref, m);
  const Prm P{m.scal, m.tab, m.sad, n_ref};
  const int Te = T < H ? T : H;
  const size_t row_len = batch_row_len(H);
  const size_t out_len = (size_t)(H + 1) * NX + (size_t)H * (NU + NC) + 3;
  const int nt = blockDim.x, half = nt / 2;
  WarpClock<PROF> pc;
  pc.start(b == 0 && w == 0);

  const real* in = rows + (size_t)b * row_len;
  for (int i = threadIdx.x; i < NX; i += nt) m.xs[i] = in[i];
  for (int i = threadIdx.x; i < H * NU; i += nt) m.us[i] = in[NX + i];
  for (int i = threadIdx.x; i < H * NC; i += nt)
    m.lam[i] = in[NX + H * NU + i];
  for (int i = threadIdx.x; i < NSCAL; i += nt)
    m.scal[i] = in[NX + H * (NU + NC) + i];
  for (int i = Te * NU + threadIdx.x; i < H * NU; i += nt) m.kk[i] = R(0.0);
  for (int i = Te * NU * NX + threadIdx.x; i < H * NU * NX; i += nt)
    m.KK[i] = R(0.0);
  __syncthreads();
  pc.stamp(BP_LOAD);

  if (w == 0) {
    open_rollout(P, m, H, T, integrator);
    __syncwarp();
    for (int t = lane; t < H; t += WARP)
      m.cstep[t] = t < T ? step_cost(P, m.xs + t * NX, m.us + t * NU,
                                     m.lam + t * NC, m.bw)
                         : R(0.0);
  }
  __syncthreads();
  real cur = R(0.0);
  for (int t = 0; t < Te; ++t) cur += m.cstep[t];
  int ms = mu_steps[b], iterations = 0;
  ms = ms < 0 ? 0 : (ms > 7 ? 7 : ms);
  __syncthreads();                // cstep is the derivatives' room next
  pc.stamp(BP_INIT);

  for (int lg = 0; lg < max_lg; ++lg) {
    for (int k = threadIdx.x; k < Te * NC; k += nt) {
      const int t = k / NC, i = k % NC;
      const real* x = m.xs + t * NX;
      const real g = i == 0 ? x[3] - P.s[MAX_DELTA]
                     : i == 1 ? (-P.s[MAX_DELTA]) - x[3]
                     : i == 2 ? x[6] - P.s[MAX_ACC]
                              : P.s[MIN_ACC] - x[6];
      real y = m.lam[k] + m.bw[2 * i] * g;
      y = y < R(0.0) ? R(0.0) : y;
      m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
    }
    __syncthreads();
    pc.stamp(BP_LAM);

    for (int it = 0; it < max_it; ++it) {
      // every step's dense block: the cost's on the first half of the
      // threads, the dynamics' on the second
      if ((int)threadIdx.x < half) {
        for (int t = threadIdx.x; t < Te; t += half)
          deriv_cost(P, m.xs + t * NX, m.us + t * NU, m.lam + t * NC, m.bw,
                     HessAcc{m.der + (size_t)t * ND});
      } else {
        for (int t = threadIdx.x - half; t < Te; t += half)
          deriv_dyn(P, m.xs + t * NX, m.us + t * NU, m.cfg[0],
                    DenseJac{m.der + (size_t)t * ND});
      }
      __syncthreads();
      pc.stamp(BP_DERIV);

      if (w == 0) backward_warp(sm, m, Te, MU_OF_STEP[ms]);
      __syncthreads();
      pc.stamp(BP_RICCATI);

      // every candidate at once; the sums in order pick the first
      // improving one
      const int cand = NG * w + lane / GW;
      rollout_group<GroupTrig<GW>>(P, m, H, T, m.alphas[cand],
                                   m.cx + (size_t)cand * (H + 1) * NX,
                                   m.cu + (size_t)cand * H * NU, integrator);
      __syncwarp();
      for (int k = lane; k < NG * Te; k += WARP) {
        const int g = NG * w + k / Te, t = k % Te;
        m.cstep[g * H + t] =
            step_cost(P, m.cx + ((size_t)g * (H + 1) + t) * NX,
                      m.cu + ((size_t)g * H + t) * NU, m.lam + t * NC, m.bw);
      }
      __syncwarp();
      real own = R(0.0);
      for (int t = 0; t < Te; ++t) own += m.cstep[cand * H + t];
      if ((lane & (GW - 1)) == 0) sums[cand] = own;
      __syncthreads();
      pc.stamp(BP_CAND);
      int pick = -1;
      real nc = cur;
      for (int g = 0; g < NA; ++g) {
        const real sg = sums[g];
        if (pick < 0 && sg < cur && isfinite(sg) && sg >= R(0.0)) {
          pick = g;
          nc = sg;
        }
      }
      if constexpr (PROF) {
        if (threadIdx.x == 0)
          atomicAdd(reinterpret_cast<unsigned long long*>(prof) + N_BPHASE
                        + (pick >= 0 ? pick : NA - 1),
                    1ull);
      }

      if (pick >= 0)
        ms = ms - 1 > 0 ? ms - 1 : 0;
      else
        ms = ms + 1 < 7 ? ms + 1 : 7;
      const real denom = nc == R(0.0) ? R(1.0) : nc;
      const real rel = fabs(nc - cur) / denom;
      cur = nc;
      iterations += 1;
      if (pick >= 0) {
        const real* cx = m.cx + (size_t)pick * (H + 1) * NX;
        const real* cu = m.cu + (size_t)pick * H * NU;
        for (int i = threadIdx.x; i < (H + 1) * NX; i += nt) m.xs[i] = cx[i];
        for (int i = threadIdx.x; i < H * NU; i += nt) m.us[i] = cu[i];
      }
      __syncthreads();
      pc.stamp(BP_PICK);
      if (rel < m.cfg[1]) break;
    }
  }

  real* o = out + (size_t)b * out_len;
  const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NC;
  for (int i = threadIdx.x; i < nxo; i += nt) o[i] = m.xs[i];
  for (int i = threadIdx.x; i < nuo; i += nt) o[nxo + i] = m.us[i];
  for (int i = threadIdx.x; i < nlo; i += nt) o[nxo + nuo + i] = m.lam[i];
  if (threadIdx.x == 0) {
    o[nxo + nuo + nlo] = ms;
    o[nxo + nuo + nlo + 1] = cur;
    o[nxo + nuo + nlo + 2] = iterations;
  }
  pc.stamp(BP_STORE);
  pc.store(prof);
}

#undef R
#undef SD_IJ
#undef SD_I

}  // namespace ILQR_MPC_NS

// One full augmented-Lagrangian iLQR update of the time-indexed tracking
// MPC (trajectory_tracking_mpc_time: nx=6, nu=2, nc=4) in float64, in one
// launch of one thread block of 8 warps: the solve of the time-indexed
// tracking controller (control/model_predictive_controller_time.py) every
// tick.
//
// Replaces: the XLA program the JAX package compiles from
// tpl_tpu/optim/ilqr.py:126 (make_update_fn) for this problem and pins to
// the host CPU (tpl_tpu/control/tracking_mpc.py:120); there is no Pallas
// kernel for it.  Plain version: tpl_tpu_torch/optim/ilqr.py make_update_fn,
// through tpl_tpu_torch/optim/ilqr_tracking_mpc_time.py update_reference.
//
// The algorithm and its operation order are the plain version's: the
// initial rollout and its cost with the old multipliers, then max_lg
// multiplier updates, each followed by up to max_it iterations of the
// derivatives, the Riccati backward pass, 8 line-search rollouts at alpha =
// 10^-c, the pick of the first improving candidate, the mu schedule and the
// stopping test.
//
// The design is the single solve of ilqr_tracking_mpc.cu (the comment at
// its top), kept simple:
// - the per-step references: the problem looks its reference up by time,
//   rt = ref_t_offset + dt * t, so the four lookups of step t depend on t
//   alone.  They are tabulated once per launch (lerp_multi for x, y, v and
//   lerp_angle for the heading, clamped at the table's ends as the plain
//   lookups are), and no derivative flows through them: the dynamics do not
//   read them and the cost takes them as constants, as autograd does;
// - derivatives: forward-mode numbers whose set of active variables is a
//   compile-time mask (structural zeros cost nothing).  Warps 0-1 take the
//   augmented cost's gradient and Hessian of a step (second order, each
//   term added into the step's block in the plain order), warps 2-3 the
//   dynamics' Euler Jacobians (first order), a step a thread;
// - Riccati backward pass: warp 0 alone, the dot products of 6 described
//   per lane as offsets and strides, 4 __syncwarp() a step;
// - line search: warp c rolls candidate alpha = 10^-c on its lane 0, then
//   its lanes take the candidate's step costs and lane 0 sums them in step
//   order; the pick, the mu schedule and the stopping test are computed by
//   every thread from the 8 sums.
//
// Every sum runs in a fixed order, so the result is deterministic.  The
// dynamics take atan, tan, sin and cos in float64: the card's libm may part
// from the CPU's in the last bit, so the kernel is held to the plain version
// at a tolerance on the card and near to the bit on the CPU (a rehearsal of
// this body under g++).  Built without fast math and with --fmad=false.
// Input and output layouts: tpl_tpu_torch/optim/ilqr_tracking_mpc_time.py
// (input_layout, output_layout).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ilqr_common.cuh"
#include "smem_limit.cuh"

namespace ilqr_mpc_time {

using namespace ilqr_common;

constexpr int NX = 6;
constexpr int NU = 2;
constexpr int NC = 4;
constexpr int NV = NX + NU;              // differentiation variables (x, u)
constexpr int NSCAL = 19;
constexpr int NTAB = 4;
constexpr int NREF = 4;                  // references a step
constexpr double AL_ZERO = 1e-4;
constexpr double PI = 3.141592653589793;

// scalar params and reference tables, in the order of
// ilqr_tracking_mpc_time.py SCALARS / TABLES
enum Scalar {
  PD, PV, PDELTA, MIN_PDELTA_DOT, PDELTA_DOT, MIN_P_PHI_DOT, P_PHI_DOT,
  P_PHI, PA, PJ, L, V_CH, COG_POS, REF_DT, REF_T_OFFSET, MAX_DELTA, MAX_ACC,
  MIN_ACC, A_OFFSET
};
enum Table { T_X, T_Y, T_PHI, T_V };
// the step's tabulated references
enum Ref { R_X, R_Y, R_PHI, R_V };
// the differentiation variables: the state [x, y, phi, delta, v, a] (CoG
// position), then the actions [jerk, delta_dot]
enum Var { V_PX, V_PY, V_PHI, V_DELTA, V_V, V_A, V_J, V_DDOT };

// per-step derivative block: fx (6,6), fu (6,2), lx (6), lu (2),
// lxx (6,6), luu (2,2), lux (2,6)
constexpr int D_FX = 0;
constexpr int D_FU = D_FX + NX * NX;
constexpr int D_LX = D_FU + NX * NU;
constexpr int D_LU = D_LX + NX;
constexpr int D_LXX = D_LU + NU;
constexpr int D_LUU = D_LXX + NX * NX;
constexpr int D_LUX = D_LUU + NU * NU;
constexpr int ND = D_LUX + NU * NX;

// ---------------------------------------------------------------------
// forward-mode numbers over (x, u) with a compile-time set of active
// variables (as in ilqr_tracking_mpc_body.cuh)
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

__device__ __forceinline__ Zero operator*(Zero, double) { return {}; }
__device__ __forceinline__ Zero operator*(double, Zero) { return {}; }
__device__ __forceinline__ Zero operator*(Zero, Zero) { return {}; }
__device__ __forceinline__ Zero operator/(Zero, double) { return {}; }
__device__ __forceinline__ Zero operator+(Zero, Zero) { return {}; }
__device__ __forceinline__ double operator+(Zero, double b) { return b; }
__device__ __forceinline__ double operator+(double a, Zero) { return a; }
__device__ __forceinline__ Zero operator-(Zero, Zero) { return {}; }
__device__ __forceinline__ double operator-(double a, Zero) { return a; }
__device__ __forceinline__ double operator-(Zero, double b) { return 0.0 - b; }
__device__ __forceinline__ Zero operator-(Zero) { return {}; }
__device__ __forceinline__ double dbl(Zero) { return 0.0; }
__device__ __forceinline__ double dbl(double a) { return a; }

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
  double v;
  double g[N > 0 ? N : 1];
  double h[(ORD == 2 && N > 0) ? tri(N) : 1];

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

#define TIME_SD_IJ                           \
  constexpr int I = decltype(ic)::value;     \
  constexpr int J = decltype(jc)::value
#define TIME_SD_I constexpr int I = decltype(ic)::value

// r.g[I] = fg(I) for I in r's mask; r.h[I, J] = fh(I, J) for I <= J in it
template <class R, class FG, class FH>
__device__ __forceinline__ void fill(R& r, FG&& fg, FH&& fh) {
  sfor<0, NV>([&](auto ic) {
    TIME_SD_I;
    if constexpr (R::template has<I>()) r.template setG<I>(fg(ic));
  });
  if constexpr (R::ORDER == 2) {
    sfor<0, NV>([&](auto ic) {
      TIME_SD_I;
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

// the variable I at value c
template <int I, int ORD>
__device__ __forceinline__ SD<(1u << I), ORD> var(double c) {
  SD<(1u << I), ORD> r;
  r.v = c;
  r.g[0] = 1.0;
  r.h[0] = 0.0;
  return r;
}

// all-zero number with the mask and order of its argument
__device__ __forceinline__ double zero_like(double) { return 0.0; }
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> zero_like(const SD<A, O>&) {
  SD<A, O> r;
  r.v = 0.0;
  fill(r, [](auto) { return 0.0; }, [](auto, auto) { return 0.0; });
  return r;
}

template <unsigned A, unsigned B, int O>
__device__ __forceinline__ SD<(A | B), O> operator+(const SD<A, O>& a,
                                                    const SD<B, O>& b) {
  SD<(A | B), O> r;
  r.v = a.v + b.v;
  fill(r,
       [&](auto ic) { TIME_SD_I; return a.template G<I>() + b.template G<I>(); },
       [&](auto ic, auto jc) {
         TIME_SD_IJ;
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
       [&](auto ic) { TIME_SD_I; return a.template G<I>() - b.template G<I>(); },
       [&](auto ic, auto jc) {
         TIME_SD_IJ;
         return a.template Hs<I, J>() - b.template Hs<I, J>();
       });
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator+(const SD<A, O>& a, double b) {
  SD<A, O> r = a;
  r.v = a.v + b;
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator+(double b, const SD<A, O>& a) {
  SD<A, O> r = a;
  r.v = b + a.v;
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator-(const SD<A, O>& a, double b) {
  SD<A, O> r = a;
  r.v = a.v - b;
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator-(double b, const SD<A, O>& a) {
  SD<A, O> r;
  r.v = b - a.v;
  fill(r, [&](auto ic) { TIME_SD_I; return -a.template G<I>(); },
       [&](auto ic, auto jc) { TIME_SD_IJ; return -a.template Hs<I, J>(); });
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator*(const SD<A, O>& a, double b) {
  SD<A, O> r;
  r.v = a.v * b;
  fill(r, [&](auto ic) { TIME_SD_I; return a.template G<I>() * b; },
       [&](auto ic, auto jc) { TIME_SD_IJ; return a.template Hs<I, J>() * b; });
  return r;
}

template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> operator*(double b, const SD<A, O>& a) {
  SD<A, O> r;
  r.v = b * a.v;
  fill(r, [&](auto ic) { TIME_SD_I; return b * a.template G<I>(); },
       [&](auto ic, auto jc) { TIME_SD_IJ; return b * a.template Hs<I, J>(); });
  return r;
}

template <unsigned A, unsigned B, int O>
__device__ __forceinline__ SD<(A | B), O> operator*(const SD<A, O>& a,
                                                    const SD<B, O>& b) {
  SD<(A | B), O> r;
  r.v = a.v * b.v;
  fill(r,
       [&](auto ic) {
         TIME_SD_I;
         return a.v * b.template G<I>() + b.v * a.template G<I>();
       },
       [&](auto ic, auto jc) {
         TIME_SD_IJ;
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
    TIME_SD_I;
    if constexpr (SD<(A | B), O>::template has<I>())
      r.template setG<I>(
          dbl(a.template G<I>() - r.v * b.template G<I>()) / b.v);
  });
  if constexpr (O == 2) {
    sfor<0, NV>([&](auto ic) {
      TIME_SD_I;
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
__device__ __forceinline__ SD<A, O> operator/(const SD<A, O>& a, double b) {
  SD<A, O> r;
  r.v = a.v / b;
  fill(r, [&](auto ic) { TIME_SD_I; return a.template G<I>() / b; },
       [&](auto ic, auto jc) { TIME_SD_IJ; return a.template Hs<I, J>() / b; });
  return r;
}

// f(a) with f(a.v) = f0, f'(a.v) = f1, f''(a.v) = f2
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> chain(const SD<A, O>& a, double f0,
                                          double f1, double f2) {
  SD<A, O> r;
  r.v = f0;
  fill(r, [&](auto ic) { TIME_SD_I; return f1 * a.template G<I>(); },
       [&](auto ic, auto jc) {
         TIME_SD_IJ;
         return f1 * a.template Hs<I, J>()
                + f2 * a.template G<I>() * a.template G<J>();
       });
  return r;
}

// the same math on doubles and on SD (distinct names: an SD overload named
// sin would hide ::sin inside this namespace)
__device__ __forceinline__ double val(double a) { return a; }
template <unsigned A, int O>
__device__ __forceinline__ double val(const SD<A, O>& a) { return a.v; }
__device__ __forceinline__ double fcos(double a) { return cos(a); }
__device__ __forceinline__ double ftan(double a) { return tan(a); }
__device__ __forceinline__ double fatan(double a) { return atan(a); }
__device__ __forceinline__ double sq(double a) { return a * a; }
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> fsin(const SD<A, O>& a) {
  const double s = sin(a.v), c = cos(a.v);
  return chain(a, s, c, -s);
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> fcos(const SD<A, O>& a) {
  const double s = sin(a.v), c = cos(a.v);
  return chain(a, c, -s, -c);
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> ftan(const SD<A, O>& a) {
  const double t = tan(a.v), d1 = 1.0 + t * t;
  return chain(a, t, d1, 2.0 * t * d1);
}
// atan' = 1 / (1 + a^2), atan'' = -2 a / (1 + a^2)^2
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> fatan(const SD<A, O>& a) {
  const double d1 = 1.0 / (1.0 + a.v * a.v);
  return chain(a, atan(a.v), d1, -2.0 * a.v * d1 * d1);
}
template <unsigned A, int O>
__device__ __forceinline__ SD<A, O> sq(const SD<A, O>& a) { return a * a; }

// ---------------------------------------------------------------------
// scalar helpers with torch's semantics

// torch.clamp: NaN passes through
__device__ __forceinline__ double clampd(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.remainder(x, m) for m > 0 (floored, as jnp.mod)
__device__ __forceinline__ double pymod(double x, double m) {
  double r = fmod(x, m);
  if (r != 0.0 && r < 0.0) r += m;
  return r;
}

__device__ __forceinline__ double angle_dist(double a0, double a1) {
  return pymod((a1 - a0) + PI, 2.0 * PI) - PI;
}

struct Lookup {
  int i0, i1;
  double a;
};

// clamped floor / ceil indices and alpha at fractional index q (a NaN
// query reads row 0; its alpha stays NaN)
__device__ __forceinline__ Lookup lookup(double q, int n) {
  const double qs = isnan(q) ? 0.0 : q;
  const double f0 = clampd(floor(qs), 0.0, n - 1.0);
  const double f1 = clampd(ceil(qs), 0.0, n - 1.0);
  Lookup r;
  r.i0 = (int)f0;
  r.i1 = (int)f1;
  r.a = clampd(q - f0, 0.0, 1.0);
  return r;
}

// ---------------------------------------------------------------------
// the problem (tpl_tpu_torch/optim/problems.py trajectory_tracking_mpc_time)

// The references of steps 0 .. H-1 into ref (NREF a step): at rt =
// ref_t_offset + dt * t, lerp_multi of (ref_x, ref_y, ref_v) and lerp_angle
// of ref_phi at the query clamped to the table (problems.py refs)
__device__ void tabulate_refs(const double* s, const double* tab, int n,
                              double dt, int H, double* ref) {
  const double* tx = tab + T_X * n;
  const double* ty = tab + T_Y * n;
  const double* tp = tab + T_PHI * n;
  const double* tv = tab + T_V * n;
  for (int t = threadIdx.x; t < H; t += blockDim.x) {
    const double rt = s[REF_T_OFFSET] + dt * (double)t;
    const double q = (rt - 0.0) / s[REF_DT];
    const Lookup lk = lookup(q, n);
    double* r = ref + t * NREF;
    r[R_X] = tx[lk.i0] + lk.a * (tx[lk.i1] - tx[lk.i0]);
    r[R_Y] = ty[lk.i0] + lk.a * (ty[lk.i1] - ty[lk.i0]);
    r[R_V] = tv[lk.i0] + lk.a * (tv[lk.i1] - tv[lk.i0]);
    const Lookup la = lookup(clampd(q, 0.0, n - 1.0), n);
    r[R_PHI] = tp[la.i0] + angle_dist(tp[la.i0], tp[la.i1]) * la.a;
  }
}

// the CoG slip angle and the yaw rate of the single-track model
template <class TB, class TP>
struct Yaw {
  TB beta;
  TP phi_dot;
};
template <class TB, class TP>
__device__ __forceinline__ Yaw<TB, TP> make_yaw(const TB& beta,
                                                const TP& phi_dot) {
  return {beta, phi_dot};
}

template <class TDEL, class TV>
__device__ __forceinline__ auto yaw(const double* p, const TDEL& delta,
                                    const TV& v) {
  const auto td = ftan(delta);
  const auto beta = fatan(td * p[COG_POS]);
  const auto phi_dot = ((v * td) * fcos(beta))
                       / (p[L] * (1.0 + sq(v / p[V_CH])));
  return make_yaw(beta, phi_dot);
}

// sums the cost's terms in the plain order
struct SumAcc {
  double c = 0.0;
  bool first = true;
  __device__ __forceinline__ void add(double t) {
    c = first ? t : c + t;
    first = false;
  }
};

// adds each term's gradient and Hessian entries into a step's (zeroed)
// derivative block, in the plain order; lxx and luu take the upper triangle
// (mirror() completes them)
struct HessAcc {
  double* d;

  __device__ __forceinline__ void clear() const {
    for (int i = D_LX; i < ND; ++i) d[i] = 0.0;
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
      TIME_SD_I;
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

// cost + sum(g*lam) + sum(inactive ? 0 : w*g*g), term by term into acc; r
// the step's references
template <class Acc, class TPX, class TPY, class TPHI, class TDEL, class TV,
          class TA, class TJ, class TDD>
__device__ __forceinline__ void aug_cost(const double* p, const double* r,
                                         Acc& acc, const TPX& px,
                                         const TPY& py, const TPHI& phi,
                                         const TDEL& delta, const TV& v,
                                         const TA& a, const TJ& j,
                                         const TDD& delta_dot,
                                         const double* lam,
                                         const double* bw) {
  const auto phi_dot = yaw(p, delta, v).phi_dot;
  acc.add((p[MIN_PDELTA_DOT] + p[PDELTA_DOT] * sq(v)) * sq(delta_dot));
  acc.add((p[MIN_P_PHI_DOT] + p[P_PHI_DOT] * sq(v)) * sq(phi_dot));
  acc.add(p[PA] * sq(a));
  acc.add(p[PJ] * sq(j));
  acc.add(p[PV] * sq(v - r[R_V]));
  acc.add(p[PD] * sq(px - r[R_X]));
  acc.add(p[PD] * sq(py - r[R_Y]));
  acc.add(p[P_PHI] * (1.0 - fcos(phi - r[R_PHI])));

  // the constraints: steering within +-max_delta, acceleration within
  // [min_acc, max_acc] (on the states, not the actions)
  const auto g0 = delta - p[MAX_DELTA];
  const auto g1 = (-p[MAX_DELTA]) - delta;
  const auto g2 = a - p[MAX_ACC];
  const auto g3 = p[MIN_ACC] - a;
  const auto s = ((g0 * lam[0] + g1 * lam[1]) + g2 * lam[2]) + g3 * lam[3];
  acc.add(s);
  auto pen = zero_like(s);
  if (!(val(g0) < 0.0 && fabs(lam[0]) < AL_ZERO))
    pen = pen + (bw[0] * g0) * g0;
  if (!(val(g1) < 0.0 && fabs(lam[1]) < AL_ZERO))
    pen = pen + (bw[2] * g1) * g1;
  if (!(val(g2) < 0.0 && fabs(lam[2]) < AL_ZERO))
    pen = pen + (bw[4] * g2) * g2;
  if (!(val(g3) < 0.0 && fabs(lam[3]) < AL_ZERO))
    pen = pen + (bw[6] * g3) * g3;
  acc.add(pen);
}

__device__ double step_cost(const double* p, const double* r, const double* x,
                            const double* u, const double* lam,
                            const double* bw) {
  SumAcc acc;
  aug_cost(p, r, acc, x[0], x[1], x[2], x[3], x[4], x[5], u[0], u[1], lam,
           bw);
  return acc.c;
}

// the augmented cost's gradient and Hessian at step (x, u) into the step's
// dense block
__device__ void deriv_cost(const double* p, const double* r, const double* x,
                           const double* u, const double* lam,
                           const double* bw, HessAcc acc) {
  const auto px = var<V_PX, 2>(x[0]);
  const auto py = var<V_PY, 2>(x[1]);
  const auto phi = var<V_PHI, 2>(x[2]);
  const auto delta = var<V_DELTA, 2>(x[3]);
  const auto v = var<V_V, 2>(x[4]);
  const auto a = var<V_A, 2>(x[5]);
  const auto j = var<V_J, 2>(u[0]);
  const auto delta_dot = var<V_DDOT, 2>(u[1]);
  acc.clear();
  aug_cost(p, r, acc, px, py, phi, delta, v, a, j, delta_dot, lam, bw);
  acc.mirror();
}

// row I of fx = I + dt*df/dx and fu = dt*df/du from dynamics entry f
template <int I, class T>
__device__ __forceinline__ void jac_row(double* d, double dt, const T& f) {
  sfor<0, NV>([&](auto jc) {
    constexpr int J = decltype(jc)::value;
    double gj;
    if constexpr (T::template has<J>()) gj = f.template G<J>();
    else gj = 0.0;
    if constexpr (J < NX)
      d[D_FX + I * NX + J] = (I == J ? 1.0 : 0.0) + dt * gj;
    else
      d[D_FU + I * NU + (J - NX)] = dt * gj;
  });
}

// the dynamics' Euler Jacobians at step (x, u) into the step's dense block
__device__ void deriv_dyn(const double* p, const double* x, const double* u,
                          double dt, double* d) {
  const auto phi = var<V_PHI, 1>(x[2]);
  const auto delta = var<V_DELTA, 1>(x[3]);
  const auto v = var<V_V, 1>(x[4]);
  const auto a = var<V_A, 1>(x[5]);
  const auto j = var<V_J, 1>(u[0]);
  const auto delta_dot = var<V_DDOT, 1>(u[1]);
  const auto y = yaw(p, delta, v);
  const auto ang = phi + y.beta;
  jac_row<0>(d, dt, v * fcos(ang));
  jac_row<1>(d, dt, v * fsin(ang));
  jac_row<2>(d, dt, y.phi_dot);
  jac_row<3>(d, dt, delta_dot);
  jac_row<4>(d, dt, a + p[A_OFFSET]);
  jac_row<5>(d, dt, j);
}

// dx/dt at (x, u) (problems.py dynamics)
__device__ __forceinline__ void eval_dyn(const double* p, const double* x,
                                         const double* u, double* f) {
  const auto y = yaw(p, x[3], x[4]);
  double s, c;
  sincos(x[2] + y.beta, &s, &c);
  f[0] = x[4] * c;
  f[1] = x[4] * s;
  f[2] = y.phi_dot;
  f[3] = u[1];
  f[4] = x[5] + p[A_OFFSET];
  f[5] = u[0];
}

// one discrete step (ilqr._integrate)
__device__ void integrate(const double* p, const double* x, const double* u,
                          double dt, int integrator, double* xn) {
  double k1[NX], k2[NX], xt[NX];
  eval_dyn(p, x, u, k1);
  if (integrator == 0) {            // EULER
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt * k1[i];
    return;
  }
  if (integrator == 1) {            // HEUN
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k1[i];
    eval_dyn(p, xt, u, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt / 2.0 * (k1[i] + k2[i]);
    return;
  }
  double k3[NX], k4[NX];            // RK4
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt / 2.0 * k1[i];
  eval_dyn(p, xt, u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt / 2.0 * k2[i];
  eval_dyn(p, xt, u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k3[i];
  eval_dyn(p, xt, u, k4);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    xn[i] = x[i] + dt / 6.0 * (((k1[i] + 2.0 * k2[i]) + 2.0 * k3[i]) + k4[i]);
}

// ---------------------------------------------------------------------
// shared-memory layout (doubles)

// mu = 0 if mu_step == 0 else 10^(mu_step - 1), mu_step in [0, 7]
__device__ const double MU_OF_STEP[8] = {0.0, 1.0, 10.0, 100.0,
                                         1e3, 1e4, 1e5, 1e6};

struct Smem {
  double *xs, *us, *lam, *ulim, *bw, *cfg, *alphas, *scal, *tab;
  double *ref, *der, *kk, *KK, *cx, *cu, *cstep, *ccost;
  double *Vx, *Vxx, *A, *B, *Qx, *Qu, *Qxx, *Quu, *Qux;
  size_t in_len;                   // doubles copied from the input
};

__host__ __device__ inline size_t carve(double* base, int H, int n_ref,
                                        Smem* m) {
  size_t o = 0;
  auto take = [&](size_t n) {
    double* p = base ? base + o : nullptr;
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
  s.ref = take((size_t)H * NREF);
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
  if (m) *m = s;
  return o * sizeof(double);
}

// ---------------------------------------------------------------------
// the phases

// One dot product of 6 of the backward pass, as offsets (in doubles) into
// the block's shared memory: out = [add +] sum_k a[k * sa] * b[k * sb].
// An operand that lives in the step's derivative block is marked relative
// and moves with the step.
struct Dot {
  int a, sa, a_rel, b, sb, b_rel, add, add_rel, has_add, out;
};

__device__ __forceinline__ double dot6(const double* sm, const Dot& q,
                                       int step) {
  const double* a = sm + q.a + q.a_rel * step;
  const double* b = sm + q.b + q.b_rel * step;
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < NX; ++k) s += a[k * q.sa] * b[k * q.sb];
  const double add = sm[q.add + q.add_rel * step];
  return q.has_add ? add + s : s;
}

// the Riccati backward pass (ilqr.py backward) over steps n-1 .. 0, by the
// 32 lanes of warp 0: 4 warp barriers a step.  The 56 + 52 dot products of
// 6 take 2 rounds each; a lane past the last item repeats it (the same
// value to the same place).  Step t's dense block lies at m.der + t * ND.
__device__ void backward_warp(double* sm, const Smem& m, int n, double mu) {
  const int lane = threadIdx.x & (WARP - 1);
  const int der = (int)(m.der - sm);
  auto at = [&](const double* p) { return (int)(p - sm); };
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
                ? Dot{der + D_FX + e / NX, NX, ND, at(m.Vxx) + e % NX, NX, 0,
                      der, ND, 0, at(m.A) + e}
            : b < NU * NX                  // B = fu^T Vxx
                ? Dot{der + D_FU + b / NX, NU, ND, at(m.Vxx) + b % NX, NX, 0,
                      der, ND, 0, at(m.B) + b}
            : c < NX                       // Qx = lx + fx^T Vx
                ? Dot{der + D_FX + c, NX, ND, at(m.Vx), 1, 0, der + D_LX + c,
                      ND, 1, at(m.Qx) + c}
                                           // Qu = lu + fu^T Vx
                : Dot{der + D_FU + d, NU, ND, at(m.Vx), 1, 0, der + D_LU + d,
                      ND, 1, at(m.Qu) + d};
  }
#pragma unroll
  for (int r = 0; r < R2; ++r) {
    int e = lane + r * WARP;
    e = e < N2 ? e : N2 - 1;
    const int b = e - NX * NX, c = b - NU * NU;
    s2[r] = e < NX * NX                    // Qxx = lxx + A fx
                ? Dot{at(m.A) + (e / NX) * NX, 1, 0, der + D_FX + e % NX, NX,
                      ND, der + D_LXX + e, ND, 1, at(m.Qxx) + e}
            : b < NU * NU                  // Quu = luu + B fu
                ? Dot{at(m.B) + (b / NU) * NX, 1, 0, der + D_FU + b % NU, NU,
                      ND, der + D_LUU + b, ND, 1, at(m.Quu) + b}
                                           // Qux = lux + B fx
                : Dot{at(m.B) + (c / NX) * NX, 1, 0, der + D_FX + c % NX, NX,
                      ND, der + D_LUX + c, ND, 1, at(m.Qux) + c};
  }
  // this lane's gain entry (a lane past the last repeats it) and its
  // two entries of the value update, lane and lane + 32
  static_assert(NX * NX >= WARP && NX * NX <= 2 * WARP && NU * NX + NU <= WARP,
                "the value update's entries on a warp's lanes");
  const int ke = lane < NU * NX ? lane : NU * NX - 1;
  const int ki = ke / NX, kj = ke % NX;
  const int v1 = lane + WARP < NX * NX ? lane + WARP : NX * NX - 1;

  for (int i = lane; i < NX * NX; i += WARP) m.Vxx[i] = 0.0;
  if (lane < NX) m.Vx[lane] = 0.0;
  __syncwarp();
  for (int t = n - 1; t >= 0; --t) {
    double* K = m.KK + (size_t)t * NU * NX;
    // A = fx^T Vxx, B = fu^T Vxx, Qx = lx + fx^T Vx, Qu = lu + fu^T Vx
    {
      double res[R1];
#pragma unroll
      for (int r = 0; r < R1; ++r) res[r] = dot6(sm, s1[r], t);
#pragma unroll
      for (int r = 0; r < R1; ++r) sm[s1[r].out] = res[r];
    }
    __syncwarp();
    // Qxx = lxx + A fx, Quu = luu + B fu, Qux = lux + B fx
    {
      double res[R2];
#pragma unroll
      for (int r = 0; r < R2; ++r) res[r] = dot6(sm, s2[r], t);
#pragma unroll
      for (int r = 0; r < R2; ++r) sm[s2[r].out] = res[r];
    }
    __syncwarp();
    // the action solve (nu == 2 closed form) and the control-limit clamp:
    // every lane forms the inverse and both feedforward terms, then its
    // gain entry; lanes 12 and 13 store the feedforward terms
    {
      const double a = m.Quu[0] + mu, b = m.Quu[1], dd = m.Quu[3] + mu;
      const double det = a * dd - b * b;
      const double inv_det = -1.0 / det;
      const double inv[4] = {dd * inv_det, -b * inv_det, -b * inv_det,
                             a * inv_det};
      const double* ut = m.us + t * NU;
      const double* lim = m.ulim + t * NU * 2;
      double kv[NU];
      bool hit[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        double s = 0.0;
#pragma unroll
        for (int r = 0; r < NU; ++r) s += inv[i * NU + r] * m.Qu[r];
        kv[i] = s;
        const double c = ut[i] + kv[i];
        const double lo = lim[2 * i], hi = lim[2 * i + 1];
        const bool over = c > hi, under = c < lo;
        if (over) kv[i] = hi - ut[i];
        if (under) kv[i] = lo - ut[i];
        hit[i] = over || under;
      }
      const double inv_i[NU] = {ki ? inv[2] : inv[0], ki ? inv[3] : inv[1]};
      double sk = 0.0;
#pragma unroll
      for (int r = 0; r < NU; ++r) sk += inv_i[r] * m.Qux[r * NX + kj];
      K[ke] = (ki ? hit[1] : hit[0]) ? 0.0 : sk;
      if (lane >= NU * NX && lane < NU * NX + NU)
        m.kk[t * NU + (lane - NU * NX)] = lane == NU * NX ? kv[0] : kv[1];
    }
    __syncwarp();
    // Vxx = Qxx + KQux + KQux^T + KtQuu K with KQux = K^T Qux and
    // KtQuu = K^T Quu formed by the lane that needs them (2 rounds), then
    // Vx = KtQuu k + K^T Qu + Qux^T k + Qx on lanes 0-5
    double vxx[2], vx = 0.0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = r == 0 ? lane : v1;
      const int i = e / NX, j = e % NX;
      double ktq[NU];               // row i of K^T Quu
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < NU; ++q) s += K[q * NX + i] * m.Quu[q * NU + c];
        ktq[c] = s;
      }
      double kq_ij = 0.0, kq_ji = 0.0, s = 0.0;
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
      const double* k = m.kk + t * NU;
      double ktq[NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < NU; ++q) s += K[q * NX + i] * m.Quu[q * NU + c];
        ktq[c] = s;
      }
      double s1v = 0.0, s2v = 0.0, s3v = 0.0;
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

// the open-loop rollout with the current controls (no clamp), frozen
// beyond T, on the calling thread
__device__ void open_rollout(const Smem& m, int H, int T, int integrator) {
  double x[NX], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = m.xs[i];
  for (int t = 0; t < H; ++t) {
    if (t < T) {
      integrate(m.scal, x, m.us + t * NU, m.cfg[0], integrator, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) m.xs[(t + 1) * NX + i] = x[i];
  }
}

// candidate c: the closed-loop rollout at alpha_c (ilqr.py fb_rollouts) on
// the calling thread
__device__ void fb_rollout(const Smem& m, int H, int T, int c,
                           int integrator) {
  const double dt = m.cfg[0];
  const double alpha = m.alphas[c];
  double* cx = m.cx + (size_t)c * (H + 1) * NX;
  double* cu = m.cu + (size_t)c * H * NU;
  double x[NX], u[NU], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) cx[i] = x[i] = m.xs[i];
  for (int t = 0; t < H; ++t) {
    const double* ur = m.us + t * NU;
    if (t < T) {
      const double* xr = m.xs + t * NX;
      const double* k = m.kk + t * NU;
      const double* K = m.KK + (size_t)t * NU * NX;
      const double* lim = m.ulim + t * NU * 2;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < NX; ++j) s += (x[j] - xr[j]) * K[i * NX + j];
        u[i] = clampd((ur[i] + alpha * k[i]) + s, lim[2 * i], lim[2 * i + 1]);
      }
      integrate(m.scal, x, u, dt, integrator, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    } else {
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = ur[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) cu[t * NU + i] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) cx[(t + 1) * NX + i] = x[i];
  }
}

// One solve, one block of THREADS threads: the packed input `in`, the
// packed result `out`, the starting mu_step.
__global__ void __launch_bounds__(THREADS)
ilqr_tracking_mpc_time_kernel(const double* __restrict__ in,
                              double* __restrict__ out, int H, int n_ref,
                              int T, int max_it, int max_lg, int mu_step,
                              int integrator) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  Smem m;
  carve(sm, H, n_ref, &m);
  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), warp = tid / WARP;
  const double* p = m.scal;
  const int Te = T < H ? T : H;   // steps that move (T may exceed H)

  for (size_t i = tid; i < m.in_len; i += blockDim.x) sm[i] = in[i];
  __syncthreads();
  tabulate_refs(m.scal, m.tab, n_ref, m.cfg[0], H, m.ref);
  if (tid == 0) open_rollout(m, H, T, integrator);
  __syncthreads();

  // the initial cost with the OLD multipliers; every thread keeps the
  // trajectory cost, mu_step and the iteration count for itself
  for (int t = tid; t < H; t += blockDim.x)
    m.cstep[t] = t < T ? step_cost(p, m.ref + t * NREF, m.xs + t * NX,
                                   m.us + t * NU, m.lam + t * NC, m.bw)
                       : 0.0;
  __syncthreads();
  double cur = 0.0;
  for (int t = 0; t < Te; ++t) cur += m.cstep[t];
  int ms = mu_step < 0 ? 0 : (mu_step > 7 ? 7 : mu_step), iterations = 0;

  for (int lg = 0; lg < max_lg; ++lg) {
    // clipped multiplier update on the active steps
    for (int k = tid; k < Te * NC; k += blockDim.x) {
      const int t = k / NC, i = k % NC;
      const double* x = m.xs + t * NX;
      const double g = i == 0 ? x[3] - p[MAX_DELTA]
                       : i == 1 ? (-p[MAX_DELTA]) - x[3]
                       : i == 2 ? x[5] - p[MAX_ACC]
                                : p[MIN_ACC] - x[5];
      double y = m.lam[k] + m.bw[2 * i] * g;
      y = y < 0.0 ? 0.0 : y;
      m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
    }
    __syncthreads();

    for (int it = 0; it < max_it; ++it) {
      // derivatives of the active steps: warps 0-1 the cost's, warps 2-3
      // the dynamics'
      if (warp < 2) {
        for (int t = tid; t < Te; t += 2 * WARP)
          deriv_cost(p, m.ref + t * NREF, m.xs + t * NX, m.us + t * NU,
                     m.lam + t * NC, m.bw, HessAcc{m.der + (size_t)t * ND});
      } else if (warp < 4) {
        for (int t = tid - 2 * WARP; t < Te; t += 2 * WARP)
          deriv_dyn(p, m.xs + t * NX, m.us + t * NU, m.cfg[0],
                    m.der + (size_t)t * ND);
      }
      __syncthreads();

      // the backward pass on warp 0; the others zero the gains of the
      // frozen steps
      if (warp == 0) {
        backward_warp(sm, m, Te, MU_OF_STEP[ms]);
      } else {
        for (int i = Te * NU + (tid - WARP); i < H * NU; i += THREADS - WARP)
          m.kk[i] = 0.0;
        for (int i = Te * NU * NX + (tid - WARP); i < H * NU * NX;
             i += THREADS - WARP)
          m.KK[i] = 0.0;
      }
      __syncthreads();

      // line search: warp c rolls candidate c out on its lane 0, takes its
      // step costs over its lanes and sums them in step order
      if (warp < NA) {
        if (lane == 0) fb_rollout(m, H, T, warp, integrator);
        __syncwarp();
        const double* cx = m.cx + (size_t)warp * (H + 1) * NX;
        const double* cu = m.cu + (size_t)warp * H * NU;
        double* cs = m.cstep + (size_t)warp * H;
        for (int t = lane; t < Te; t += WARP)
          cs[t] = step_cost(p, m.ref + t * NREF, cx + t * NX, cu + t * NU,
                            m.lam + t * NC, m.bw);
        __syncwarp();
        if (lane == 0) {
          double s = 0.0;
          for (int t = 0; t < Te; ++t) s += cs[t];
          m.ccost[warp] = s;
        }
      }
      __syncthreads();

      // the first improving alpha, the mu schedule and the termination
      // test, by every thread; then the accepted candidate's copy
      int pick = -1;
      for (int c = NA - 1; c >= 0; --c) {
        const double cc = m.ccost[c];
        if (cc < cur && isfinite(cc) && cc >= 0.0) pick = c;
      }
      double nc = cur;
      if (pick >= 0) {
        nc = m.ccost[pick];
        ms = ms - 1 > 0 ? ms - 1 : 0;
      } else {
        ms = ms + 1 < 7 ? ms + 1 : 7;
      }
      const double denom = nc == 0.0 ? 1.0 : nc;
      const double rel = fabs(nc - cur) / denom;
      cur = nc;
      iterations += 1;
      if (pick >= 0) {
        const double* cx = m.cx + (size_t)pick * (H + 1) * NX;
        const double* cu = m.cu + (size_t)pick * H * NU;
        for (int i = tid; i < (H + 1) * NX; i += blockDim.x) m.xs[i] = cx[i];
        for (int i = tid; i < H * NU; i += blockDim.x) m.us[i] = cu[i];
      }
      __syncthreads();
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
}

#undef TIME_SD_IJ
#undef TIME_SD_I

}  // namespace ilqr_mpc_time

// dynamic shared memory of the block
extern "C" size_t ilqr_tracking_mpc_time_smem_bytes(int H, int n_ref) {
  return ilqr_mpc_time::carve(nullptr, H, n_ref, nullptr);
}

#ifdef __CUDACC__
// One update: `in` the packed input, `out` the packed result (float64, on
// the current device), one block of ilqr_common::THREADS threads.  The
// dynamic shared-memory limit is raised once per device and size
// (smem_limit.cuh).  Returns the CUDA error code.
extern "C" int ilqr_tracking_mpc_time(const double* in, double* out, int H,
                                      int n_ref, int T, int max_it,
                                      int max_lg, int mu_step, int integrator,
                                      void* stream) {
  static smem_limit::Marks marks;
  auto kernel = ilqr_mpc_time::ilqr_tracking_mpc_time_kernel;
  const size_t smem = ilqr_tracking_mpc_time_smem_bytes(H, n_ref);
  cudaError_t err = smem_limit::ensure(kernel, smem, marks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, ilqr_common::THREADS, smem, (cudaStream_t)stream>>>(
      in, out, H, n_ref, T, max_it, max_lg, mu_step, integrator);
  return (int)cudaGetLastError();
}
#endif

// One full augmented-Lagrangian iLQR update of the spatial-progress
// tracking MPC (trajectory_tracking_mpc: nx=7, nu=2, nc=4), float64, in one
// launch of one thread block.
//
// Replaces: the XLA program the JAX package compiles for the host CPU from
// tpl_tpu/optim/ilqr.py:126 (make_update_fn); there is no Pallas kernel for
// it.  Plain version: tpl_tpu_torch/optim/ilqr.py make_update_fn, through
// tpl_tpu_torch/optim/ilqr_tracking_mpc.py update_reference.
//
// What bounds it on an H100: latency.  The solve is a chain of dependent
// scans of tiny float64 math (up to 20 iterations, each a 60-step Riccati
// recursion and 60-step rollouts), a few hundred microseconds of work that
// plain torch issues as ~10,000 small launches per iteration.  The design
// keeps the whole solve in one block with every array in shared memory, so
// nothing but the packed inputs and outputs touches device memory:
//
// - derivatives: thread t < T evaluates step t's dynamics and augmented cost
//   on a second-order forward-mode number (value, gradient and packed
//   Hessian over the 9 variables (x, u)) and writes fx = I + dt*df/dx,
//   fu = dt*df/du, lx, lu, lxx, luu, lux;
// - Riccati backward pass: sequential in t, each step's small matrix
//   products spread over the block's threads;
// - line search: thread 32*w (one per warp) rolls out alpha = 10^-w, then
//   all threads evaluate the per-step costs, thread 32*w sums its
//   candidate's in step order and thread 0 picks the first improving alpha
//   and applies the mu schedule and the termination test.
//
// Every sum runs in a fixed order, so the result is deterministic.  Table
// lookups keep the genopt-parity derivative rule: slope v1 - v0 between the
// clamped floor / ceil indices, no curvature in the query.  Built without
// fast math and with --fmad=false.  Input and output layouts: see
// tpl_tpu_torch/optim/ilqr_tracking_mpc.py (input_layout, unpack_outputs).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace ilqr_mpc {

constexpr int NX = 7;
constexpr int NU = 2;
constexpr int NC = 4;
constexpr int NV = NX + NU;              // differentiation variables (x, u)
constexpr int NHS = NV * (NV + 1) / 2;   // packed upper-triangle Hessian
constexpr int NA = 8;                    // line-search candidates
constexpr int NSCAL = 18;
constexpr int NTAB = 5;
constexpr int THREADS = 256;
constexpr double AL_ZERO = 1e-4;
constexpr double PI = 3.141592653589793;

// scalar params and reference tables, in the order of ilqr_tracking_mpc.py
enum Scalar {
  PD, PV, PDELTA, MIN_PDELTA_DOT, PDELTA_DOT, MIN_P_PHI_DOT, P_PHI_DOT,
  P_PHI, P_PHI_REF_DOT_DIFF, PA, PJ, L, V_CH, REF_STEP, MAX_DELTA, MAX_ACC,
  MIN_ACC, A_OFFSET
};
enum Table { T_X, T_Y, T_PHI, T_K, T_V };

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
// second-order forward-mode number over (x, u)

struct D2 {
  double v;
  double g[NV];
  double h[NHS];

  D2() = default;
  __device__ explicit D2(double c) : v(c) {
    for (int i = 0; i < NV; ++i) g[i] = 0.0;
    for (int i = 0; i < NHS; ++i) h[i] = 0.0;
  }
};

__device__ __forceinline__ int hidx(int i, int j) {  // i <= j
  return i * NV - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ D2 dvar(double c, int k) {
  D2 r(c);
  r.g[k] = 1.0;
  return r;
}

__device__ __forceinline__ D2 operator+(const D2& a, const D2& b) {
  D2 r;
  r.v = a.v + b.v;
  for (int i = 0; i < NV; ++i) r.g[i] = a.g[i] + b.g[i];
  for (int i = 0; i < NHS; ++i) r.h[i] = a.h[i] + b.h[i];
  return r;
}

__device__ __forceinline__ D2 operator-(const D2& a, const D2& b) {
  D2 r;
  r.v = a.v - b.v;
  for (int i = 0; i < NV; ++i) r.g[i] = a.g[i] - b.g[i];
  for (int i = 0; i < NHS; ++i) r.h[i] = a.h[i] - b.h[i];
  return r;
}

__device__ __forceinline__ D2 operator+(const D2& a, double b) {
  D2 r = a;
  r.v = a.v + b;
  return r;
}

__device__ __forceinline__ D2 operator+(double b, const D2& a) {
  D2 r = a;
  r.v = b + a.v;
  return r;
}

__device__ __forceinline__ D2 operator-(const D2& a, double b) {
  D2 r = a;
  r.v = a.v - b;
  return r;
}

__device__ __forceinline__ D2 operator-(double b, const D2& a) {
  D2 r;
  r.v = b - a.v;
  for (int i = 0; i < NV; ++i) r.g[i] = -a.g[i];
  for (int i = 0; i < NHS; ++i) r.h[i] = -a.h[i];
  return r;
}

__device__ __forceinline__ D2 operator*(const D2& a, double b) {
  D2 r;
  r.v = a.v * b;
  for (int i = 0; i < NV; ++i) r.g[i] = a.g[i] * b;
  for (int i = 0; i < NHS; ++i) r.h[i] = a.h[i] * b;
  return r;
}

__device__ __forceinline__ D2 operator*(double b, const D2& a) {
  D2 r;
  r.v = b * a.v;
  for (int i = 0; i < NV; ++i) r.g[i] = b * a.g[i];
  for (int i = 0; i < NHS; ++i) r.h[i] = b * a.h[i];
  return r;
}

__device__ __forceinline__ D2 operator*(const D2& a, const D2& b) {
  D2 r;
  r.v = a.v * b.v;
  for (int i = 0; i < NV; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
  for (int i = 0; i < NV; ++i)
    for (int j = i; j < NV; ++j) {
      const int k = hidx(i, j);
      r.h[k] = a.v * b.h[k] + b.v * a.h[k] + a.g[i] * b.g[j]
               + a.g[j] * b.g[i];
    }
  return r;
}

// q = a / b: a = q b, so q' = (a' - q b') / b and
// q'' = (a'' - q' b'^T - b' q'^T - q b'') / b
__device__ __forceinline__ D2 operator/(const D2& a, const D2& b) {
  D2 r;
  r.v = a.v / b.v;
  for (int i = 0; i < NV; ++i) r.g[i] = (a.g[i] - r.v * b.g[i]) / b.v;
  for (int i = 0; i < NV; ++i)
    for (int j = i; j < NV; ++j) {
      const int k = hidx(i, j);
      r.h[k] = (a.h[k] - r.g[i] * b.g[j] - r.g[j] * b.g[i] - r.v * b.h[k])
               / b.v;
    }
  return r;
}

__device__ __forceinline__ D2 operator/(const D2& a, double b) {
  D2 r;
  r.v = a.v / b;
  for (int i = 0; i < NV; ++i) r.g[i] = a.g[i] / b;
  for (int i = 0; i < NHS; ++i) r.h[i] = a.h[i] / b;
  return r;
}

// f(a) with f(a.v) = f0, f'(a.v) = f1, f''(a.v) = f2
__device__ __forceinline__ D2 chain(const D2& a, double f0, double f1,
                                    double f2) {
  D2 r;
  r.v = f0;
  for (int i = 0; i < NV; ++i) r.g[i] = f1 * a.g[i];
  for (int i = 0; i < NV; ++i)
    for (int j = i; j < NV; ++j) {
      const int k = hidx(i, j);
      r.h[k] = f1 * a.h[k] + f2 * a.g[i] * a.g[j];
    }
  return r;
}

// the same math on doubles and on D2 (distinct names: a D2 overload named
// sin would hide ::sin inside this namespace)
__device__ __forceinline__ double val(double a) { return a; }
__device__ __forceinline__ double val(const D2& a) { return a.v; }
__device__ __forceinline__ double fsin(double a) { return sin(a); }
__device__ __forceinline__ double fcos(double a) { return cos(a); }
__device__ __forceinline__ double ftan(double a) { return tan(a); }
__device__ __forceinline__ double sq(double a) { return a * a; }
__device__ __forceinline__ D2 fsin(const D2& a) {
  const double s = sin(a.v), c = cos(a.v);
  return chain(a, s, c, -s);
}
__device__ __forceinline__ D2 fcos(const D2& a) {
  const double s = sin(a.v), c = cos(a.v);
  return chain(a, c, -s, -c);
}
__device__ __forceinline__ D2 ftan(const D2& a) {
  const double t = tan(a.v), d1 = 1.0 + t * t;
  return chain(a, t, d1, 2.0 * t * d1);
}
__device__ __forceinline__ D2 sq(const D2& a) { return a * a; }

// a table lookup whose slope in the query is `slope` and whose curvature
// in the query is zero
__device__ __forceinline__ double lin(double, double value, double) {
  return value;
}
__device__ __forceinline__ D2 lin(const D2& q, double value, double slope) {
  D2 r;
  r.v = value;
  for (int i = 0; i < NV; ++i) r.g[i] = slope * q.g[i];
  for (int i = 0; i < NHS; ++i) r.h[i] = slope * q.h[i];
  return r;
}

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
// the problem (tpl_tpu_torch/optim/problems.py trajectory_tracking_mpc)

struct Prm {
  const double* s;    // scalars
  const double* tab;  // NTAB rows of n_ref
  int n_ref;
};

template <class S>
struct Core {
  S phi_dot, d_r, s_dot, r_phi, r_k;
  double v_trg;
};

template <class S>
__device__ void core(const Prm& P, const S* x, Core<S>& e) {
  const int n = P.n_ref;
  const S& px = x[0];
  const S& py = x[1];
  const S& phi = x[2];
  const S& delta = x[3];
  const S& v = x[4];
  const S& s_r = x[5];

  // lerp_multi over (ref_x, ref_y, ref_k, ref_v)
  const S q = (s_r - 0.0) / P.s[REF_STEP];
  const Lookup lk = lookup(val(q), n);
  const double* tx = P.tab + T_X * n;
  const double* ty = P.tab + T_Y * n;
  const double* tk = P.tab + T_K * n;
  const double* tv = P.tab + T_V * n;
  const double dx = tx[lk.i1] - tx[lk.i0];
  const double dy = ty[lk.i1] - ty[lk.i0];
  const double dk = tk[lk.i1] - tk[lk.i0];
  const double dv = tv[lk.i1] - tv[lk.i0];
  const S r_x = lin(q, tx[lk.i0] + lk.a * dx, dx);
  const S r_y = lin(q, ty[lk.i0] + lk.a * dy, dy);
  e.r_k = lin(q, tk[lk.i0] + lk.a * dk, dk);
  // the velocity target carries no derivative (genopt's fixed())
  e.v_trg = tv[lk.i0] + lk.a * dv;

  // lerp_angle over ref_phi at the clamped query
  const double qc = clampd(val(q), 0.0, n - 1.0);
  const Lookup la = lookup(qc, n);
  const double* tp = P.tab + T_PHI * n;
  const double sad = angle_dist(tp[la.i0], tp[la.i1]);
  e.r_phi = lin(q, tp[la.i0] + sad * la.a, sad);

  e.phi_dot = v / (P.s[L] * (1.0 + sq(v / P.s[V_CH]))) * ftan(delta);
  e.d_r = fcos(e.r_phi) * (py - r_y) - fsin(e.r_phi) * (px - r_x);
  e.s_dot = v * fcos(phi - e.r_phi) / (1.0 - e.d_r * e.r_k);
}

template <class S>
__device__ void dynamics(const Prm& P, const S* x, const S* u,
                         const Core<S>& e, S* f) {
  f[0] = x[4] * fcos(x[2]);
  f[1] = x[4] * fsin(x[2]);
  f[2] = e.phi_dot;
  f[3] = u[1];
  f[4] = x[6] + P.s[A_OFFSET];
  f[5] = e.s_dot;
  f[6] = u[0];
}

template <class S>
__device__ S cost(const Prm& P, const S* x, const S* u, const Core<S>& e) {
  const S& phi = x[2];
  const S& v = x[4];
  const S& a = x[6];
  const S& j = u[0];
  const S& delta_dot = u[1];
  const double* p = P.s;
  S c = (p[MIN_PDELTA_DOT] + p[PDELTA_DOT] * sq(v)) * sq(delta_dot);
  c = c + (p[MIN_P_PHI_DOT] + p[P_PHI_DOT] * sq(v)) * sq(e.phi_dot);
  c = c + p[PA] * sq(a);
  c = c + p[PJ] * sq(j);
  c = c + p[PV] * sq(v - e.v_trg);
  c = c + p[PD] * sq(e.d_r);
  c = c + p[P_PHI] * (1.0 - fcos(phi - e.r_phi));
  c = c + p[P_PHI_REF_DOT_DIFF] * sq(e.phi_dot - e.s_dot * e.r_k) * sq(v);
  return c;
}

template <class S>
__device__ void constraints(const Prm& P, const S* x, S* g) {
  g[0] = x[3] - P.s[MAX_DELTA];
  g[1] = (-P.s[MAX_DELTA]) - x[3];
  g[2] = x[6] - P.s[MAX_ACC];
  g[3] = P.s[MIN_ACC] - x[6];
}

// cost + sum(g*lam) + sum(inactive ? 0 : w*g*g)
template <class S>
__device__ S aug_cost(const Prm& P, const S* x, const S* u,
                      const Core<S>& e, const double* lam, const double* bw) {
  S c = cost(P, x, u, e);
  S g[NC];
  constraints(P, x, g);
  S s = g[0] * lam[0];
  for (int i = 1; i < NC; ++i) s = s + g[i] * lam[i];
  c = c + s;
  S pen(0.0);
  for (int i = 0; i < NC; ++i) {
    const bool inactive = val(g[i]) < 0.0 && fabs(lam[i]) < AL_ZERO;
    if (!inactive) pen = pen + (bw[2 * i] * g[i]) * g[i];
  }
  return c + pen;
}

__device__ double step_cost(const Prm& P, const double* x, const double* u,
                            const double* lam, const double* bw) {
  Core<double> e;
  core(P, x, e);
  return aug_cost(P, x, u, e, lam, bw);
}

__device__ void deriv(const Prm& P, const double* x, const double* u, double dt,
                      const double* lam, const double* bw, double* d) {
  D2 X[NX], U[NU];
  for (int i = 0; i < NX; ++i) X[i] = dvar(x[i], i);
  for (int i = 0; i < NU; ++i) U[i] = dvar(u[i], NX + i);
  Core<D2> e;
  core(P, X, e);
  D2 f[NX];
  dynamics(P, X, U, e, f);
  for (int i = 0; i < NX; ++i) {
    for (int j = 0; j < NX; ++j)
      d[D_FX + i * NX + j] = (i == j ? 1.0 : 0.0) + dt * f[i].g[j];
    for (int j = 0; j < NU; ++j) d[D_FU + i * NU + j] = dt * f[i].g[NX + j];
  }
  const D2 c = aug_cost(P, X, U, e, lam, bw);
  for (int i = 0; i < NX; ++i) d[D_LX + i] = c.g[i];
  for (int i = 0; i < NU; ++i) d[D_LU + i] = c.g[NX + i];
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NX; ++j)
      d[D_LXX + i * NX + j] = c.h[i <= j ? hidx(i, j) : hidx(j, i)];
  for (int i = 0; i < NU; ++i)
    for (int j = 0; j < NU; ++j)
      d[D_LUU + i * NU + j] =
          c.h[i <= j ? hidx(NX + i, NX + j) : hidx(NX + j, NX + i)];
  for (int i = 0; i < NU; ++i)
    for (int j = 0; j < NX; ++j) d[D_LUX + i * NX + j] = c.h[hidx(j, NX + i)];
}

__device__ void eval_dyn(const Prm& P, const double* x, const double* u,
                         double* f) {
  Core<double> e;
  core(P, x, e);
  dynamics(P, x, u, e, f);
}

// one discrete step (ilqr._integrate)
__device__ void integrate(const Prm& P, const double* x, const double* u,
                          double dt, int integrator, double* xn) {
  double k1[NX], k2[NX], xt[NX];
  eval_dyn(P, x, u, k1);
  if (integrator == 0) {            // EULER
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt * k1[i];
    return;
  }
  if (integrator == 1) {            // HEUN
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k1[i];
    eval_dyn(P, xt, u, k2);
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt / 2.0 * (k1[i] + k2[i]);
    return;
  }
  double k3[NX], k4[NX];            // RK4
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt / 2.0 * k1[i];
  eval_dyn(P, xt, u, k2);
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt / 2.0 * k2[i];
  eval_dyn(P, xt, u, k3);
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k3[i];
  eval_dyn(P, xt, u, k4);
  for (int i = 0; i < NX; ++i)
    xn[i] = x[i] + dt / 6.0 * (((k1[i] + 2.0 * k2[i]) + 2.0 * k3[i]) + k4[i]);
}

// ---------------------------------------------------------------------
// shared-memory layout (doubles, then ints)

enum { SI_MU, SI_DONE, SI_ITERS, SI_PICK, SI_N };

// mu = 0 if mu_step == 0 else 10^(mu_step - 1), mu_step in [0, 7]
__device__ const double MU_OF_STEP[8] = {0.0, 1.0, 10.0, 100.0, 1e3, 1e4,
                                         1e5, 1e6};

struct Smem {
  double *xs, *us, *lam, *ulim, *bw, *cfg, *alphas, *scal, *tab;
  double *der, *kk, *KK, *cx, *cu, *cstep, *ccost;
  double *Vx, *Vxx, *A, *B, *Qx, *Qu, *Qxx, *Quu, *Qux, *KQux, *KtQuu;
  double* cur;                     // current trajectory cost
  int* si;                         // mu_step, done, iterations, pick
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
  s.KQux = take(NX * NX);
  s.KtQuu = take(NX * NU);
  s.cur = take(1);
  s.si = base ? (int*)(base + o) : nullptr;
  if (m) *m = s;
  return o * sizeof(double) + SI_N * sizeof(int);
}

// ---------------------------------------------------------------------
// block-wide phases (every thread calls them)

// per-step augmented costs of candidate c's rollout (or, c < 0, of the
// current trajectory into cstep[0..H)) ; steps >= T cost 0
__device__ void step_costs(const Prm& P, const Smem& m, int H, int T,
                           int n_cand) {
  for (int k = threadIdx.x; k < n_cand * H; k += blockDim.x) {
    const int c = k / H, t = k % H;
    const double* x = n_cand == 1 ? m.xs : m.cx + (size_t)c * (H + 1) * NX;
    const double* u = n_cand == 1 ? m.us : m.cu + (size_t)c * H * NU;
    m.cstep[k] = t < T ? step_cost(P, x + t * NX, u + t * NU,
                                   m.lam + t * NC, m.bw)
                       : 0.0;
  }
}

// the Riccati backward pass (ilqr.py backward) over steps T-1 .. 0
__device__ void backward(const Smem& m, int H, int T, double mu) {
  const int tid = threadIdx.x;
  for (int i = tid; i < NX * NX; i += blockDim.x) m.Vxx[i] = 0.0;
  for (int i = tid; i < NX; i += blockDim.x) m.Vx[i] = 0.0;
  for (int i = tid; i < H * NU; i += blockDim.x) m.kk[i] = 0.0;
  for (int i = tid; i < H * NU * NX; i += blockDim.x) m.KK[i] = 0.0;
  __syncthreads();
  const int n = T < H ? T : H;
  for (int t = n - 1; t >= 0; --t) {
    const double* d = m.der + (size_t)t * ND;
    const double* fx = d + D_FX;
    const double* fu = d + D_FU;
    // A = fx^T Vxx, B = fu^T Vxx, Qx = lx + fx^T Vx, Qu = lu + fu^T Vx
    if (tid < NX * NX) {
      const int i = tid / NX, j = tid % NX;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += fx[k * NX + i] * m.Vxx[k * NX + j];
      m.A[tid] = s;
    } else if (tid >= 64 && tid < 64 + NU * NX) {
      const int e = tid - 64, i = e / NX, j = e % NX;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += fu[k * NU + i] * m.Vxx[k * NX + j];
      m.B[e] = s;
    } else if (tid >= 96 && tid < 96 + NX) {
      const int i = tid - 96;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += fx[k * NX + i] * m.Vx[k];
      m.Qx[i] = d[D_LX + i] + s;
    } else if (tid >= 128 && tid < 128 + NU) {
      const int i = tid - 128;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += fu[k * NU + i] * m.Vx[k];
      m.Qu[i] = d[D_LU + i] + s;
    }
    __syncthreads();
    // Qxx = lxx + A fx, Quu = luu + B fu, Qux = lux + B fx
    if (tid < NX * NX) {
      const int i = tid / NX, j = tid % NX;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += m.A[i * NX + k] * fx[k * NX + j];
      m.Qxx[tid] = d[D_LXX + tid] + s;
    } else if (tid >= 64 && tid < 64 + NU * NU) {
      const int e = tid - 64, i = e / NU, j = e % NU;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += m.B[i * NX + k] * fu[k * NU + j];
      m.Quu[e] = d[D_LUU + e] + s;
    } else if (tid >= 96 && tid < 96 + NU * NX) {
      const int e = tid - 96, i = e / NX, j = e % NX;
      double s = 0.0;
      for (int k = 0; k < NX; ++k) s += m.B[i * NX + k] * fx[k * NX + j];
      m.Qux[e] = d[D_LUX + e] + s;
    }
    __syncthreads();
    // the action solve (nu == 2 closed form) and the control-limit clamp
    if (tid == 0) {
      const double a = m.Quu[0] + mu, b = m.Quu[1], dd = m.Quu[3] + mu;
      const double det = a * dd - b * b;
      const double inv_det = -1.0 / det;
      const double inv[4] = {dd * inv_det, -b * inv_det, -b * inv_det,
                             a * inv_det};
      double* k = m.kk + t * NU;
      double* K = m.KK + (size_t)t * NU * NX;
      const double* ut = m.us + t * NU;
      const double* lim = m.ulim + t * NU * 2;
      for (int i = 0; i < NU; ++i) {
        double s = 0.0;
        for (int r = 0; r < NU; ++r) s += inv[i * NU + r] * m.Qu[r];
        k[i] = s;
        for (int j = 0; j < NX; ++j) {
          double sk = 0.0;
          for (int r = 0; r < NU; ++r) sk += inv[i * NU + r] * m.Qux[r * NX + j];
          K[i * NX + j] = sk;
        }
        const double c = ut[i] + k[i];
        const double lo = lim[2 * i], hi = lim[2 * i + 1];
        const bool over = c > hi, under = c < lo;
        if (over) k[i] = hi - ut[i];
        if (under) k[i] = lo - ut[i];
        if (over || under)
          for (int j = 0; j < NX; ++j) K[i * NX + j] = 0.0;
      }
    }
    __syncthreads();
    // KQux = K^T Qux, KtQuu = K^T Quu
    {
      const double* K = m.KK + (size_t)t * NU * NX;
      if (tid < NX * NX) {
        const int i = tid / NX, j = tid % NX;
        double s = 0.0;
        for (int r = 0; r < NU; ++r) s += K[r * NX + i] * m.Qux[r * NX + j];
        m.KQux[tid] = s;
      } else if (tid >= 64 && tid < 64 + NX * NU) {
        const int e = tid - 64, i = e / NU, j = e % NU;
        double s = 0.0;
        for (int r = 0; r < NU; ++r) s += K[r * NX + i] * m.Quu[r * NU + j];
        m.KtQuu[e] = s;
      }
    }
    __syncthreads();
    // Vxx = Qxx + KQux + KQux^T + KtQuu K
    // Vx = KtQuu k + K^T Qu + Qux^T k + Qx
    {
      const double* K = m.KK + (size_t)t * NU * NX;
      const double* k = m.kk + t * NU;
      if (tid < NX * NX) {
        const int i = tid / NX, j = tid % NX;
        double s = 0.0;
        for (int r = 0; r < NU; ++r) s += m.KtQuu[i * NU + r] * K[r * NX + j];
        m.Vxx[tid] = ((m.Qxx[tid] + m.KQux[tid]) + m.KQux[j * NX + i]) + s;
      } else if (tid >= 64 && tid < 64 + NX) {
        const int i = tid - 64;
        double s1 = 0.0, s2 = 0.0, s3 = 0.0;
        for (int r = 0; r < NU; ++r) s1 += m.KtQuu[i * NU + r] * k[r];
        for (int r = 0; r < NU; ++r) s2 += K[r * NX + i] * m.Qu[r];
        for (int r = 0; r < NU; ++r) s3 += m.Qux[r * NX + i] * k[r];
        m.Vx[i] = ((s1 + s2) + s3) + m.Qx[i];
      }
    }
    __syncthreads();
  }
}

// candidate c's closed-loop rollout at alpha_c (ilqr.py fb_rollouts)
__device__ void fb_rollout(const Prm& P, const Smem& m, int H, int T, int c,
                           int integrator) {
  const double dt = m.cfg[0];
  const double alpha = m.alphas[c];
  double* cx = m.cx + (size_t)c * (H + 1) * NX;
  double* cu = m.cu + (size_t)c * H * NU;
  double x[NX], u[NU], xn[NX];
  for (int i = 0; i < NX; ++i) x[i] = cx[i] = m.xs[i];
  for (int t = 0; t < H; ++t) {
    const double* ur = m.us + t * NU;
    if (t < T) {
      const double* xr = m.xs + t * NX;
      const double* k = m.kk + t * NU;
      const double* K = m.KK + (size_t)t * NU * NX;
      const double* lim = m.ulim + t * NU * 2;
      for (int i = 0; i < NU; ++i) {
        double s = 0.0;
        for (int j = 0; j < NX; ++j) s += (x[j] - xr[j]) * K[i * NX + j];
        u[i] = clampd((ur[i] + alpha * k[i]) + s, lim[2 * i], lim[2 * i + 1]);
      }
      integrate(P, x, u, dt, integrator, xn);
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    } else {
      for (int i = 0; i < NU; ++i) u[i] = ur[i];
    }
    for (int i = 0; i < NU; ++i) cu[t * NU + i] = u[i];
    for (int i = 0; i < NX; ++i) cx[(t + 1) * NX + i] = x[i];
  }
}

__global__ void __launch_bounds__(THREADS)
ilqr_tracking_mpc_kernel(const double* __restrict__ in,
                         double* __restrict__ out, int H, int n_ref, int T,
                         int max_it, int max_lg, int mu_step, int integrator) {
  extern __shared__ double sm[];
  Smem m;
  carve(sm, H, n_ref, &m);
  const int tid = threadIdx.x;
  const Prm P{m.scal, m.tab, n_ref};
  const int Te = T < H ? T : H;   // steps that move (T may exceed H)

  for (size_t i = tid; i < m.in_len; i += blockDim.x) sm[i] = in[i];
  if (tid == 0) {
    m.si[SI_MU] = mu_step;
    m.si[SI_DONE] = 0;
    m.si[SI_ITERS] = 0;
  }
  __syncthreads();

  // initial rollout with the current controls (no clamp), frozen beyond T
  if (tid == 0) {
    double xn[NX];
    for (int t = 0; t < H; ++t) {
      const double* x = m.xs + t * NX;
      if (t < T) {
        integrate(P, x, m.us + t * NU, m.cfg[0], integrator, xn);
      } else {
        for (int i = 0; i < NX; ++i) xn[i] = x[i];
      }
      for (int i = 0; i < NX; ++i) m.xs[(t + 1) * NX + i] = xn[i];
    }
  }
  __syncthreads();
  // its cost, with the OLD multipliers
  step_costs(P, m, H, T, 1);
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int t = 0; t < Te; ++t) s += m.cstep[t];
    m.cur[0] = s;
  }
  __syncthreads();

  for (int lg = 0; lg < max_lg; ++lg) {
    // clipped multiplier update on the active steps
    for (int k = tid; k < Te * NC; k += blockDim.x) {
      const int t = k / NC, i = k % NC;
      double g[NC];
      constraints(P, m.xs + t * NX, g);
      double y = m.lam[k] + m.bw[2 * i] * g[i];
      y = y < 0.0 ? 0.0 : y;
      m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
    }
    __syncthreads();

    for (int it = 0; it < max_it; ++it) {
      const int ms = m.si[SI_MU];
      const double mu = MU_OF_STEP[ms];
      // derivatives of the active steps
      for (int t = tid; t < Te; t += blockDim.x)
        deriv(P, m.xs + t * NX, m.us + t * NU, m.cfg[0], m.lam + t * NC,
              m.bw, m.der + (size_t)t * ND);
      __syncthreads();
      backward(m, H, T, mu);
      // the 8 line-search rollouts, one per warp
      if ((tid & 31) == 0 && tid / 32 < NA)
        fb_rollout(P, m, H, T, tid / 32, integrator);
      __syncthreads();
      step_costs(P, m, H, T, NA);
      __syncthreads();
      if ((tid & 31) == 0 && tid / 32 < NA) {
        const int c = tid / 32;
        double s = 0.0;
        for (int t = 0; t < Te; ++t) s += m.cstep[c * H + t];
        m.ccost[c] = s;
      }
      __syncthreads();
      if (tid == 0) {
        const double cur = m.cur[0];
        int pick = -1;
        for (int c = 0; c < NA; ++c) {
          const double cc = m.ccost[c];
          if (cc < cur && isfinite(cc) && cc >= 0.0) {
            pick = c;
            break;
          }
        }
        double nc = cur;
        if (pick >= 0) {
          nc = m.ccost[pick];
          m.si[SI_MU] = ms - 1 > 0 ? ms - 1 : 0;
        } else {
          m.si[SI_MU] = ms + 1 < 7 ? ms + 1 : 7;
        }
        const double denom = nc == 0.0 ? 1.0 : nc;
        const double rel = fabs(nc - cur) / denom;
        m.cur[0] = nc;
        m.si[SI_DONE] = rel < m.cfg[1] ? 1 : 0;
        m.si[SI_ITERS] += 1;
        m.si[SI_PICK] = pick;
      }
      __syncthreads();
      const int pick = m.si[SI_PICK];
      if (pick >= 0) {
        const double* cx = m.cx + (size_t)pick * (H + 1) * NX;
        const double* cu = m.cu + (size_t)pick * H * NU;
        for (int i = tid; i < (H + 1) * NX; i += blockDim.x) m.xs[i] = cx[i];
        for (int i = tid; i < H * NU; i += blockDim.x) m.us[i] = cu[i];
      }
      __syncthreads();
      if (m.si[SI_DONE]) break;
    }
  }

  // outputs: x, u, lam, mu_step, traj_costs, iterations
  const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NC;
  for (int i = tid; i < nxo; i += blockDim.x) out[i] = m.xs[i];
  for (int i = tid; i < nuo; i += blockDim.x) out[nxo + i] = m.us[i];
  for (int i = tid; i < nlo; i += blockDim.x) out[nxo + nuo + i] = m.lam[i];
  if (tid == 0) {
    out[nxo + nuo + nlo] = m.si[SI_MU];
    out[nxo + nuo + nlo + 1] = m.cur[0];
    out[nxo + nuo + nlo + 2] = m.si[SI_ITERS];
  }
}

}  // namespace ilqr_mpc

extern "C" size_t ilqr_tracking_mpc_smem_bytes(int H, int n_ref) {
  return ilqr_mpc::carve(nullptr, H, n_ref, nullptr);
}

#ifdef __CUDACC__
extern "C" int ilqr_tracking_mpc(const double* in, double* out, int H,
                                 int n_ref, int T, int max_it, int max_lg,
                                 int mu_step, int integrator, void* stream) {
  const size_t smem = ilqr_tracking_mpc_smem_bytes(H, n_ref);
  cudaError_t err = cudaFuncSetAttribute(
      ilqr_mpc::ilqr_tracking_mpc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ilqr_mpc::ilqr_tracking_mpc_kernel<<<1, ilqr_mpc::THREADS, smem,
                                       (cudaStream_t)stream>>>(
      in, out, H, n_ref, T, max_it, max_lg, mu_step, integrator);
  return (int)cudaGetLastError();
}
#endif

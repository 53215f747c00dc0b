// One full augmented-Lagrangian iLQR update of any problem, generic in the
// problem struct, the scalar type and the integrator: one block solves one
// instance, and a batch is a grid of B blocks, block b solving row b.
//
// Replaces: the XLA programs the JAX package builds from
// tpl_tpu/optim/ilqr.py:126 (make_update_fn) for every problem it solves,
// single and batched (tpl_tpu/optim/batched.py:30); there is no Pallas
// kernel for them.  Plain version: tpl_tpu_torch/optim/ilqr.py
// make_update_fn and tpl_tpu_torch/optim/batched.py reference.  The
// wrapper is tpl_tpu_torch/optim/ilqr_generic.py.
//
// A problem is a struct P over the real type R:
//
//   static constexpr int NX, NU, NC;     // states, actions, constraints
//   static constexpr int NS, NT;         // scalar params, tables of n_ref
//   static constexpr bool END_COST;
//   template <class S> static void dynamics(const Prm<R>&, int t,
//                                           const S* x, const S* u, S* f);
//   template <class S> static S cost(const Prm<R>&, int t, const S* x,
//                                    const S* u);
//   template <class S> static void constraints(const Prm<R>&, int t,
//                                              const S* x, const S* u,
//                                              S* g);     // NC > 0 only
//   template <class S> static S end_cost(const Prm<R>&, int t,
//                                        const S* x);   // END_COST only
//
// S is R in the rollouts and the costs and a Jet (csrc/ilqr_jet.cuh) in the
// derivatives, so a struct states only the problem's values: the native
// problems of csrc/ilqr_generic.cu are written by hand, and the sympy front
// end (tpl_tpu_torch/optim/genopt.py) prints one for each config.  t is the
// step index (the end cost's is T), as the plain version passes it.
//
// The semantics are make_update_fn's: the initial rollout and its cost with
// the old multipliers, then max_lg rounds of the clipped multiplier update,
// each followed by up to max_it iterations of derivatives (fx = I + dt
// df/dx whatever the integrator), the Riccati pass (mu on Quu's diagonal;
// nu = 1: zero gain where Quu <= 0; nu = 2: the closed-form inverse; larger
// nu: elimination with partial pivoting; the control-limit clamp), the 8
// line-search rollouts at alpha = 10^-c, the first improving candidate,
// the mu schedule and the relative-change stop.  Steps beyond T are frozen.
//
// The design is the simple one of csrc/ilqr_rstp.cu, not yet tuned for the
// card: threads stride over the steps for the derivatives, step costs and
// multipliers; thread 0 runs the Riccati pass; lane 0 of warp c rolls out
// candidate c and the warp takes its step costs, lane 0 summing them in
// step order.  Per-step arrays sit in shared memory up to a limit the host
// gives (carve: the arrays in a fixed order, each placed in shared memory
// while it fits and otherwise in the launch's global workspace, B slices of
// workspace_words), so any horizon runs at any (nx, nu, nc).
//
// Layouts (tpl_tpu_torch/optim/ilqr_generic.py): the batch's shared part
// is u_lims (H, NU, 2), bw_lim (NCL, 2), cfg_f (dt, min_rel_cost_change),
// alphas (8), tables (NT, n_ref); a row is x0 (NX), u (H, NU), lam (H,
// NCL), scalars (NS), mu_step (1); a result row is x (H+1, NX), u (H, NU),
// lam (H, NCL), (mu_step, traj_costs, iterations); NCL = max(NC, 1).  A
// single solve is a batch of one.  Every sum runs in a fixed order, so the
// result is deterministic and row b's bits do not depend on the batch.
// The PROF = true instantiation also returns block 0's thread 0 clock64()
// cycles per phase (ilqr_common::Phase); its results are bit-equal.

#ifndef TPL_TPU_TORCH_ILQR_GENERIC_BODY_CUH_
#define TPL_TPU_TORCH_ILQR_GENERIC_BODY_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ilqr_common.cuh"
#include "ilqr_jet.cuh"
#include "smem_limit.cuh"

namespace ilqr_generic {

using namespace ilqr_common;
using namespace ilqr_jet;

enum Integrator { EULER = 0, HEUN = 1, RK4 = 2 };

template <typename R>
struct Prm {
  const R* s;     // scalar params
  const R* tab;   // the tables, n_ref each
  int n_ref;
  R dt;

  __device__ Tab<R> table(int k) const {
    return Tab<R>{tab + (size_t)k * n_ref, n_ref};
  }
};

template <class P, typename R>
struct Solve {
  static constexpr int NX = P::NX, NU = P::NU, NC = P::NC;
  static constexpr int NCL = NC > 0 ? NC : 1;   // multiplier columns
  static constexpr int NV = NX + NU;
  typedef Jet<R, NV> J;
  typedef Jet<R, NX> JX;

  // per-step derivative block: fx (NX,NX), fu (NX,NU), lx, lu, lxx,
  // luu (NU,NU), lux (NU,NX)
  static constexpr int D_FX = 0;
  static constexpr int D_FU = D_FX + NX * NX;
  static constexpr int D_LX = D_FU + NX * NU;
  static constexpr int D_LU = D_LX + NX;
  static constexpr int D_LXX = D_LU + NU;
  static constexpr int D_LUU = D_LXX + NX * NX;
  static constexpr int D_LUX = D_LUU + NU * NU;
  static constexpr int ND = D_LUX + NU * NX;

  __host__ __device__ static size_t row_len(int H) {
    return NX + (size_t)H * NU + (size_t)H * NCL + P::NS + 1;
  }
  __host__ __device__ static size_t out_len(int H) {
    return (size_t)(H + 1) * NX + (size_t)H * NU + (size_t)H * NCL + 3;
  }

  struct Mem {
    R *mu, *cfg, *alphas, *bw, *ccost, *VxT, *VxxT, *scal;
    R *xs, *us, *kk, *KK, *ulim, *lam, *der, *tab, *cstep, *cx, *cu;
  };

  // The arrays in a fixed order, each in shared memory (base sm) while it
  // fits in cap words and otherwise in the workspace (base ws); the words
  // taken from each into *n_sm / *n_ws.  With null bases it only counts.
  __host__ __device__ static void carve(R* sm, R* ws, int H, int n_ref,
                                        size_t cap, Mem* m, size_t* n_sm,
                                        size_t* n_ws) {
    size_t o_sm = 0, o_ws = 0;
    auto take = [&](size_t n) {
      R* p;
      if (o_sm + n <= cap) {
        p = sm ? sm + o_sm : nullptr;
        o_sm += n;
      } else {
        p = ws ? ws + o_ws : nullptr;
        o_ws += n;
      }
      return p;
    };
    Mem s;
    s.mu = take(1);
    s.cfg = take(2);
    s.alphas = take(NA);
    s.bw = take(NCL * 2);
    s.ccost = take(NA);
    s.VxT = take(NX);
    s.VxxT = take(NX * NX);
    s.scal = take(P::NS > 0 ? P::NS : 1);
    s.xs = take((size_t)(H + 1) * NX);
    s.us = take((size_t)H * NU);
    s.kk = take((size_t)H * NU);
    s.KK = take((size_t)H * NU * NX);
    s.ulim = take((size_t)H * NU * 2);
    s.lam = take((size_t)H * NCL);
    s.der = take((size_t)H * ND);
    s.tab = take((size_t)P::NT * n_ref > 0 ? (size_t)P::NT * n_ref : 1);
    s.cstep = take((size_t)NA * H);
    s.cx = take((size_t)NA * (H + 1) * NX);
    s.cu = take((size_t)NA * H * NU);
    if (m) *m = s;
    if (n_sm) *n_sm = o_sm;
    if (n_ws) *n_ws = o_ws;
  }

  // cost + sum(g*lam) + sum(inactive ? 0 : w*g*g)
  template <class S>
  __device__ static S aug_cost(const Prm<R>& Pr, int t, const S* x,
                               const S* u, const R* lam, const R* bw) {
    S c = P::cost(Pr, t, x, u);
    if constexpr (NC > 0) {
      S g[NC];
      P::constraints(Pr, t, x, u, g);
      S s = g[0] * lam[0];
#pragma unroll
      for (int i = 1; i < NC; ++i) s = s + g[i] * lam[i];
      c = c + s;
      S pen(R(0));
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const bool inactive = val(g[i]) < R(0) && fabs(lam[i]) < R(1e-4);
        if (!inactive) pen = pen + (bw[2 * i] * g[i]) * g[i];
      }
      c = c + pen;
    }
    return c;
  }

  // the derivative block of one step (compiled once for every integrator
  // and profiling instantiation)
  __device__ __noinline__ static void deriv(const Prm<R>& Pr, int t,
                                            const R* x, const R* u,
                                            const R* lam, const R* bw,
                                            R* d) {
    J X[NX], U[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) X[i] = jvar<R, NV>(x[i], i);
#pragma unroll
    for (int i = 0; i < NU; ++i) U[i] = jvar<R, NV>(u[i], NX + i);
    J f[NX];
    P::dynamics(Pr, t, X, U, f);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j)
        d[D_FX + i * NX + j] = (i == j ? R(1) : R(0)) + Pr.dt * f[i].g[j];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        d[D_FU + i * NU + j] = Pr.dt * f[i].g[NX + j];
    }
    const J c = aug_cost(Pr, t, X, U, lam, bw);
#pragma unroll
    for (int i = 0; i < NX; ++i) d[D_LX + i] = c.g[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) d[D_LU + i] = c.g[NX + i];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        d[D_LXX + i * NX + j] =
            c.h[i <= j ? hidx<NV>(i, j) : hidx<NV>(j, i)];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        d[D_LUU + i * NU + j] = c.h[i <= j ? hidx<NV>(NX + i, NX + j)
                                           : hidx<NV>(NX + j, NX + i)];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        d[D_LUX + i * NX + j] = c.h[hidx<NV>(j, NX + i)];
  }

  // the end cost's gradient and Hessian at x[T] (zero beyond H or without
  // an end cost): the backward pass starts from them
  __device__ __noinline__ static void end_derivs(const Prm<R>& Pr,
                                                 const Mem& m, int H, int T) {
#pragma unroll
    for (int i = 0; i < NX; ++i) m.VxT[i] = R(0);
#pragma unroll
    for (int i = 0; i < NX * NX; ++i) m.VxxT[i] = R(0);
    if constexpr (P::END_COST) {
      if (T > H) return;
      JX X[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) X[i] = jvar<R, NX>(m.xs[T * NX + i], i);
      const JX e = P::end_cost(Pr, T, X);
#pragma unroll
      for (int i = 0; i < NX; ++i) m.VxT[i] = e.g[i];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          m.VxxT[i * NX + j] = e.h[i <= j ? hidx<NX>(i, j) : hidx<NX>(j, i)];
    }
  }

  // the end cost at x[min(max(T, 0), H)]
  __device__ static R end_cost(const Prm<R>& Pr, const R* xs, int H, int T) {
    if constexpr (P::END_COST) {
      const int iT = T < 0 ? 0 : (T > H ? H : T);
      return P::end_cost(Pr, T, xs + iT * NX);
    } else {
      return R(0);
    }
  }

  // one step of the integrator (ilqr._integrate)
  template <int INTEG>
  __device__ __forceinline__ static void integrate(const Prm<R>& Pr, int t,
                                                   const R* x, const R* u,
                                                   R* xn) {
    const R dt = Pr.dt;
    R k1[NX];
    P::dynamics(Pr, t, x, u, k1);
    if constexpr (INTEG == EULER) {
#pragma unroll
      for (int i = 0; i < NX; ++i) xn[i] = x[i] + dt * k1[i];
    } else if constexpr (INTEG == HEUN) {
      R xt[NX], k2[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k1[i];
      P::dynamics(Pr, t, xt, u, k2);
      const R h = dt / R(2);
#pragma unroll
      for (int i = 0; i < NX; ++i) xn[i] = x[i] + h * (k1[i] + k2[i]);
    } else {
      R xt[NX], k2[NX], k3[NX], k4[NX];
      const R h = dt / R(2);
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = x[i] + h * k1[i];
      P::dynamics(Pr, t, xt, u, k2);
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = x[i] + h * k2[i];
      P::dynamics(Pr, t, xt, u, k3);
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = x[i] + dt * k3[i];
      P::dynamics(Pr, t, xt, u, k4);
      const R s = dt / R(6);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        xn[i] = x[i] + s * (((k1[i] + R(2) * k2[i]) + R(2) * k3[i]) + k4[i]);
    }
  }

  // k, K of the action solve (optim.c:243-291): nu = 1 zero gain where
  // Quu <= 0, nu = 2 the closed-form inverse, else elimination with partial
  // pivoting of (Quu + mu I) [k K] = -[Qu Qux]
  __device__ static void solve_action(const R* Quu, const R* Qu,
                                      const R* Qux, R mu, R* k, R* K) {
    if constexpr (NU == 1) {
      const R inv = Quu[0] > R(0) ? R(-1) / (Quu[0] + mu) : R(0);
      k[0] = inv * Qu[0];
#pragma unroll
      for (int j = 0; j < NX; ++j) K[j] = inv * Qux[j];
    } else if constexpr (NU == 2) {
      const R a = Quu[0] + mu, b = Quu[1], d = Quu[3] + mu;
      const R inv_det = R(-1) / (a * d - b * b);
      const R i00 = d * inv_det, i01 = -b * inv_det, i10 = -b * inv_det,
              i11 = a * inv_det;
      k[0] = i00 * Qu[0] + i01 * Qu[1];
      k[1] = i10 * Qu[0] + i11 * Qu[1];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        K[j] = i00 * Qux[j] + i01 * Qux[NX + j];
        K[NX + j] = i10 * Qux[j] + i11 * Qux[NX + j];
      }
    } else {
      constexpr int W = 1 + NX;
      R A[NU * NU], X[NU * W];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j)
          A[i * NU + j] = Quu[i * NU + j] + (i == j ? mu : R(0));
        X[i * W] = Qu[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) X[i * W + 1 + j] = Qux[i * NX + j];
      }
      for (int c = 0; c < NU; ++c) {
        int p = c;
        for (int i = c + 1; i < NU; ++i)
          if (fabs(A[i * NU + c]) > fabs(A[p * NU + c])) p = i;
        if (p != c) {
          for (int j = 0; j < NU; ++j) {
            const R s = A[c * NU + j];
            A[c * NU + j] = A[p * NU + j];
            A[p * NU + j] = s;
          }
          for (int j = 0; j < W; ++j) {
            const R s = X[c * W + j];
            X[c * W + j] = X[p * W + j];
            X[p * W + j] = s;
          }
        }
        for (int i = c + 1; i < NU; ++i) {
          const R f = A[i * NU + c] / A[c * NU + c];
          for (int j = c; j < NU; ++j) A[i * NU + j] -= f * A[c * NU + j];
          for (int j = 0; j < W; ++j) X[i * W + j] -= f * X[c * W + j];
        }
      }
      for (int i = NU - 1; i >= 0; --i)
        for (int j = 0; j < W; ++j) {
          R s = X[i * W + j];
          for (int c = i + 1; c < NU; ++c) s -= A[i * NU + c] * X[c * W + j];
          X[i * W + j] = s / A[i * NU + i];
        }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        k[i] = -X[i * W];
#pragma unroll
        for (int j = 0; j < NX; ++j) K[i * NX + j] = -X[i * W + 1 + j];
      }
    }
  }

  // the Riccati backward pass (ilqr.py backward) over steps n-1 .. 0, on
  // the calling thread, the value function in registers
  __device__ static void backward(const Mem& m, int n, R mu) {
    R Vx[NX], Vxx[NX * NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) Vx[i] = m.VxT[i];
#pragma unroll
    for (int i = 0; i < NX * NX; ++i) Vxx[i] = m.VxxT[i];
    for (int t = n - 1; t >= 0; --t) {
      const R* d = m.der + (size_t)t * ND;
      const R* fx = d + D_FX;
      const R* fu = d + D_FU;
      R Qx[NX], Qu[NU], A[NX * NX], B[NU * NX], Qxx[NX * NX], Quu[NU * NU],
          Qux[NU * NX];
      // Qx = lx + fx^T Vx, Qu = lu + fu^T Vx
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += fx[k * NX + i] * Vx[k];
        Qx[i] = d[D_LX + i] + s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += fu[k * NU + a] * Vx[k];
        Qu[a] = d[D_LU + a] + s;
      }
      // A = fx^T Vxx, B = fu^T Vxx
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R s = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s += fx[k * NX + i] * Vxx[k * NX + j];
          A[i * NX + j] = s;
        }
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R s = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s += fu[k * NU + a] * Vxx[k * NX + j];
          B[a * NX + j] = s;
        }
      // Qxx = lxx + A fx, Quu = luu + B fu, Qux = lux + B fx
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R s = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s += A[i * NX + k] * fx[k * NX + j];
          Qxx[i * NX + j] = d[D_LXX + i * NX + j] + s;
        }
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          R s = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s += B[a * NX + k] * fu[k * NU + c];
          Quu[a * NU + c] = d[D_LUU + a * NU + c] + s;
        }
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R s = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s += B[a * NX + k] * fx[k * NX + j];
          Qux[a * NX + j] = d[D_LUX + a * NX + j] + s;
        }
      R k[NU], K[NU * NX];
      solve_action(Quu, Qu, Qux, mu, k, K);
      // the control-limit clamp: the clamped feedforward, no feedback
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const R ut = m.us[t * NU + a];
        const R lo = m.ulim[(t * NU + a) * 2], hi = m.ulim[(t * NU + a) * 2 + 1];
        const R c = ut + k[a];
        const bool over = c > hi, under = c < lo;
        if (over) k[a] = hi - ut;
        if (under) k[a] = lo - ut;
        if (over || under)
#pragma unroll
          for (int j = 0; j < NX; ++j) K[a * NX + j] = R(0);
        m.kk[t * NU + a] = k[a];
#pragma unroll
        for (int j = 0; j < NX; ++j) m.KK[(t * NU + a) * NX + j] = K[a * NX + j];
      }
      // Vxx = Qxx + KQux + KQux^T + (K^T Quu) K,
      // Vx = (K^T Quu) k + K^T Qu + Qux^T k + Qx
      R KQ[NX * NU];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          R s = R(0);
#pragma unroll
          for (int a = 0; a < NU; ++a) s += K[a * NX + i] * Quu[a * NU + c];
          KQ[i * NU + c] = s;
        }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R kq_ij = R(0), kq_ji = R(0), kqk = R(0);
#pragma unroll
          for (int a = 0; a < NU; ++a) {
            kq_ij += K[a * NX + i] * Qux[a * NX + j];
            kq_ji += K[a * NX + j] * Qux[a * NX + i];
          }
#pragma unroll
          for (int c = 0; c < NU; ++c) kqk += KQ[i * NU + c] * K[c * NX + j];
          Vxx[i * NX + j] = ((Qxx[i * NX + j] + kq_ij) + kq_ji) + kqk;
        }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        R s1 = R(0), s2 = R(0), s3 = R(0);
#pragma unroll
        for (int c = 0; c < NU; ++c) s1 += KQ[i * NU + c] * k[c];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          s2 += K[a * NX + i] * Qu[a];
          s3 += Qux[a * NX + i] * k[a];
        }
        Vx[i] = ((s1 + s2) + s3) + Qx[i];
      }
    }
  }

  // the open-loop rollout with the current controls (no clamp), frozen
  // beyond T, on the calling thread
  template <int INTEG>
  __device__ static void open_rollout(const Prm<R>& Pr, const Mem& m, int H,
                                      int T) {
    R x[NX], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = m.xs[i];
    for (int t = 0; t < H; ++t) {
      if (t < T) {
        integrate<INTEG>(Pr, t, x, m.us + t * NU, xn);
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) m.xs[(t + 1) * NX + i] = x[i];
    }
  }

  // candidate c's closed-loop rollout at alpha_c (ilqr.py fb_rollouts), on
  // the calling thread
  template <int INTEG>
  __device__ static void fb_rollout(const Prm<R>& Pr, const Mem& m, int H,
                                    int T, int c) {
    const R alpha = m.alphas[c];
    R* cx = m.cx + (size_t)c * (H + 1) * NX;
    R* cu = m.cu + (size_t)c * H * NU;
    R x[NX], xn[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = cx[i] = m.xs[i];
    for (int t = 0; t < H; ++t) {
#pragma unroll
      for (int a = 0; a < NU; ++a) u[a] = m.us[t * NU + a];
      if (t < T) {
        const R* xr = m.xs + t * NX;
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          const R* K = m.KK + (size_t)(t * NU + a) * NX;
          R s = R(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) s += (x[j] - xr[j]) * K[j];
          const R v = (u[a] + alpha * m.kk[t * NU + a]) + s;
          const R lo = m.ulim[(t * NU + a) * 2];
          const R hi = m.ulim[(t * NU + a) * 2 + 1];
          u[a] = clampr(v, lo, hi);
        }
        integrate<INTEG>(Pr, t, x, u, xn);
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) cu[t * NU + a] = u[a];
#pragma unroll
      for (int i = 0; i < NX; ++i) cx[(t + 1) * NX + i] = x[i];
    }
  }

  template <int INTEG, bool PROF>
  __device__ static void run(R* sm, R* ws_all, size_t cap,
                             const R* __restrict__ shared,
                             const R* __restrict__ rows,
                             R* __restrict__ out_all, long long* prof, int H,
                             int n_ref, int T, int max_it, int max_lg) {
    PhaseClock<PROF> pc;
    pc.start();
    const int b = blockIdx.x;
    size_t n_ws = 0;
    carve(nullptr, nullptr, H, n_ref, cap, nullptr, nullptr, &n_ws);
    Mem m;
    carve(sm, ws_all + (size_t)b * n_ws, H, n_ref, cap, &m, nullptr,
          nullptr);
    const R* row = rows + (size_t)b * row_len(H);
    R* out = out_all + (size_t)b * out_len(H);
    const int tid = threadIdx.x;
    const int lane = tid & (WARP - 1), warp = tid / WARP;
    const int Te = T < H ? T : H;   // steps that move (T may exceed H)

    // the shared part, then the row
    {
      const R* p = shared;
      auto copy = [&](R* dst, size_t n) {
        for (size_t i = tid; i < n; i += blockDim.x) dst[i] = p[i];
        p += n;
      };
      copy(m.ulim, (size_t)H * NU * 2);
      copy(m.bw, NCL * 2);
      copy(m.cfg, 2);
      copy(m.alphas, NA);
      copy(m.tab, (size_t)P::NT * n_ref);
      p = row;
      copy(m.xs, NX);
      copy(m.us, (size_t)H * NU);
      copy(m.lam, (size_t)H * NCL);
      copy(m.scal, P::NS);
      copy(m.mu, 1);
    }
    __syncthreads();
    const Prm<R> Pr{m.scal, m.tab, n_ref, m.cfg[0]};
    pc.stamp(PH_LOAD);

    // initial rollout, and its cost with the OLD multipliers; every thread
    // keeps the trajectory cost, mu_step and the iteration count for itself
    if (tid == 0) open_rollout<INTEG>(Pr, m, H, T);
    __syncthreads();
    for (int t = tid; t < H; t += blockDim.x)
      m.cstep[t] = t < T ? aug_cost(Pr, t, m.xs + t * NX, m.us + t * NU,
                                    m.lam + t * NCL, m.bw)
                         : R(0);
    __syncthreads();
    R cur = R(0);
    for (int t = 0; t < Te; ++t) cur += m.cstep[t];
    cur = cur + end_cost(Pr, m.xs, H, T);
    const R mu0 = m.mu[0];
    int ms = mu0 != mu0 ? 0 : (int)mu0;
    ms = ms < 0 ? 0 : (ms > 7 ? 7 : ms);
    int iterations = 0;
    pc.stamp(PH_INIT);

    // mu = 0 if mu_step == 0 else 10^(mu_step - 1), mu_step in [0, 7]
    const R mu_of_step[8] = {R(0), R(1), R(10), R(100), R(1e3), R(1e4),
                             R(1e5), R(1e6)};
    for (int lg = 0; lg < max_lg; ++lg) {
      // clipped multiplier update on the active steps
      for (int k = tid; k < Te * NCL; k += blockDim.x) {
        const int t = k / NCL, i = k % NCL;
        R gi = R(0);
        if constexpr (NC > 0) {
          R g[NC];
          P::constraints(Pr, t, m.xs + t * NX, m.us + t * NU, g);
          gi = g[i];
        }
        R y = m.lam[k] + m.bw[2 * i] * gi;
        y = y < R(0) ? R(0) : y;
        m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
      }
      __syncthreads();
      pc.stamp(PH_LAM);

      for (int it = 0; it < max_it; ++it) {
        // derivatives of the active steps; the end cost's at x[T] on the
        // last thread beside them
        for (int t = tid; t < Te; t += blockDim.x)
          deriv(Pr, t, m.xs + t * NX, m.us + t * NU, m.lam + t * NCL, m.bw,
                m.der + (size_t)t * ND);
        if (tid == THREADS - 1) end_derivs(Pr, m, H, T);
        __syncthreads();
        pc.stamp(PH_DERIV);

        // the backward pass on thread 0; the other warps zero the gains of
        // the frozen steps
        if (tid == 0) {
          backward(m, Te, mu_of_step[ms]);
        } else if (warp > 0) {
          for (int i = Te * NU + (tid - WARP); i < H * NU; i += THREADS - WARP)
            m.kk[i] = R(0);
          for (int i = Te * NU * NX + (tid - WARP); i < H * NU * NX;
               i += THREADS - WARP)
            m.KK[i] = R(0);
        }
        __syncthreads();
        pc.stamp(PH_RICCATI);

        // line search: lane 0 of warp c rolls candidate c out, the warp
        // takes its step costs and lane 0 sums them in step order
        if (warp < NA) {
          if (lane == 0) fb_rollout<INTEG>(Pr, m, H, T, warp);
          __syncwarp();
          pc.stamp(PH_ROLLOUT);
          const R* cx = m.cx + (size_t)warp * (H + 1) * NX;
          const R* cu = m.cu + (size_t)warp * H * NU;
          R* cs = m.cstep + (size_t)warp * H;
          for (int t = lane; t < Te; t += WARP)
            cs[t] = aug_cost(Pr, t, cx + t * NX, cu + t * NU,
                             m.lam + t * NCL, m.bw);
          __syncwarp();
          pc.stamp(PH_STEP_COST);
          if (lane == 0) {
            R s = R(0);
            for (int t = 0; t < Te; ++t) s += cs[t];
            m.ccost[warp] = s + end_cost(Pr, cx, H, T);
          }
        }
        __syncthreads();
        pc.stamp(PH_COST_SUM);

        // the first improving alpha, the mu schedule and the termination
        // test, by every thread; then the accepted candidate's copy
        int pick = -1;
        for (int c = NA - 1; c >= 0; --c) {
          const R cc = m.ccost[c];
          if (cc < cur && isfinite(cc) && cc >= R(0)) pick = c;
        }
        R nc = cur;
        if (pick >= 0) {
          nc = m.ccost[pick];
          ms = ms - 1 > 0 ? ms - 1 : 0;
        } else {
          ms = ms + 1 < 7 ? ms + 1 : 7;
        }
        const R denom = nc == R(0) ? R(1) : nc;
        const R rel = fabs(nc - cur) / denom;
        cur = nc;
        iterations += 1;
        if (pick >= 0) {
          const R* cx = m.cx + (size_t)pick * (H + 1) * NX;
          const R* cu = m.cu + (size_t)pick * H * NU;
          for (int i = tid; i < (H + 1) * NX; i += blockDim.x) m.xs[i] = cx[i];
          for (int i = tid; i < H * NU; i += blockDim.x) m.us[i] = cu[i];
        }
        __syncthreads();
        pc.stamp(PH_PICK);
        if (rel < m.cfg[1]) break;
      }
    }

    // outputs: x, u, lam, mu_step, traj_costs, iterations
    const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NCL;
    for (int i = tid; i < nxo; i += blockDim.x) out[i] = m.xs[i];
    for (int i = tid; i < nuo; i += blockDim.x) out[nxo + i] = m.us[i];
    for (int i = tid; i < nlo; i += blockDim.x) out[nxo + nuo + i] = m.lam[i];
    if (tid == 0) {
      out[nxo + nuo + nlo] = (R)ms;
      out[nxo + nuo + nlo + 1] = cur;
      out[nxo + nuo + nlo + 2] = (R)iterations;
    }
    pc.stamp(PH_STORE);
    if (b == 0) pc.store(prof);
  }
};

template <class P, typename R, int INTEG, bool PROF>
__global__ void __launch_bounds__(THREADS)
ilqr_generic_kernel(const R* __restrict__ shared, const R* __restrict__ rows,
                    R* __restrict__ out, R* ws, long long* prof, size_t cap,
                    int H, int n_ref, int T, int max_it, int max_lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Solve<P, R>::template run<INTEG, PROF>(reinterpret_cast<R*>(smem_raw), ws,
                                         cap, shared, rows, out, prof, H,
                                         n_ref, T, max_it, max_lg);
}

// the words of shared memory (which = 0) and of workspace a block (which =
// 1) of problem P in R at H, n_ref, when a block may use smem_limit bytes
template <class P, typename R>
inline size_t split_words(int H, int n_ref, size_t smem_limit, int which) {
  size_t n_sm = 0, n_ws = 0;
  Solve<P, R>::carve(nullptr, nullptr, H, n_ref, smem_limit / sizeof(R),
                     nullptr, &n_sm, &n_ws);
  return which == 0 ? n_sm : n_ws;
}

#ifdef __CUDACC__
// One launch of B blocks; the dynamic shared-memory limit is raised once
// per instantiation, device and size (smem_limit.cuh).
template <class P, typename R, int INTEG, bool PROF>
inline int launch_instance(const R* shared, const R* rows, R* out, R* ws,
                           long long* prof, int B, int H, int n_ref, int T,
                           int max_it, int max_lg, size_t smem_limit,
                           cudaStream_t stream) {
  static smem_limit::Marks marks;
  const size_t cap = smem_limit / sizeof(R);
  const size_t smem = split_words<P, R>(H, n_ref, smem_limit, 0) * sizeof(R);
  cudaError_t err = smem_limit::ensure(
      ilqr_generic_kernel<P, R, INTEG, PROF>, smem, marks);
  if (err != cudaSuccess) return (int)err;
  ilqr_generic_kernel<P, R, INTEG, PROF><<<B, THREADS, smem, stream>>>(
      shared, rows, out, ws, prof, cap, H, n_ref, T, max_it, max_lg);
  return (int)cudaGetLastError();
}

template <class P, typename R>
inline int launch(int integrator, const void* shared, const void* rows,
                  void* out, void* ws, long long* prof, int B, int H,
                  int n_ref, int T, int max_it, int max_lg,
                  size_t smem_limit, void* stream) {
  const R* sh = (const R*)shared;
  const R* rw = (const R*)rows;
  R* o = (R*)out;
  R* w = (R*)ws;
  cudaStream_t s = (cudaStream_t)stream;
#define ILQR_GENERIC_LAUNCH(I, PR)                                          \
  return launch_instance<P, R, I, PR>(sh, rw, o, w, prof, B, H, n_ref, T,  \
                                      max_it, max_lg, smem_limit, s)
  if (prof) {
    if (integrator == EULER) ILQR_GENERIC_LAUNCH(EULER, true);
    if (integrator == HEUN) ILQR_GENERIC_LAUNCH(HEUN, true);
    if (integrator == RK4) ILQR_GENERIC_LAUNCH(RK4, true);
  } else {
    if (integrator == EULER) ILQR_GENERIC_LAUNCH(EULER, false);
    if (integrator == HEUN) ILQR_GENERIC_LAUNCH(HEUN, false);
    if (integrator == RK4) ILQR_GENERIC_LAUNCH(RK4, false);
  }
#undef ILQR_GENERIC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// loads every instantiation's code onto the current device and raises its
// shared-memory limit
template <class P, typename R>
inline int prepare() {
  static smem_limit::Marks marks[6];
  cudaError_t err = cudaSuccess;
  int i = 0;
  auto one = [&](auto kernel) {
    if (err == cudaSuccess) err = smem_limit::prepare(kernel, marks[i]);
    ++i;
  };
  one(ilqr_generic_kernel<P, R, EULER, false>);
  one(ilqr_generic_kernel<P, R, HEUN, false>);
  one(ilqr_generic_kernel<P, R, RK4, false>);
  one(ilqr_generic_kernel<P, R, EULER, true>);
  one(ilqr_generic_kernel<P, R, HEUN, true>);
  one(ilqr_generic_kernel<P, R, RK4, true>);
  return (int)err;
}
#endif  // __CUDACC__

}  // namespace ilqr_generic

#endif  // TPL_TPU_TORCH_ILQR_GENERIC_BODY_CUH_

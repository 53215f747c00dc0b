// One full augmented-Lagrangian iLQR update of an RSTP profile problem, in
// one launch of one thread block: lateral_profile (nx=2, nu=1, nc=2, with an
// end cost) or velocity_profile_space (nx=2, nu=1, nc=5), float32, Euler.
//
// Replaces: the two XLA programs the JAX package builds from
// tpl_tpu/optim/ilqr.py:126 (make_update_fn) for the RSTP planner's solves
// (tpl_tpu/planning/path_vel_decomp/fused_replan.py:322-327); there is no
// Pallas kernel for them.  Plain version: tpl_tpu_torch/optim/ilqr.py
// make_update_fn, through tpl_tpu_torch/optim/ilqr_rstp.py update_reference.
//
// What bounds it on an H100: the latency of its dependent chain, not bytes
// (24 KB in and out) or operations (~1 MFLOP for 4 iterations).  Per
// iteration the algorithm fixes a chain of 250 Riccati steps (a division
// each), then 250 Euler rollout steps, then an ordered cost sum; chain_ms in
// tpl_tpu_torch/optim/ilqr_rstp.py prices that chain with the card's
// measured float32 latencies (0.09 ms for the 4-iteration velocity solve).
// The serial phases sit on single threads, and a warp starts about one
// instruction every two cycles (csrc/latency_probe.cu), so they cost their
// instruction count: the design takes every instruction it can out of them
// and keeps the whole solve in one block with every array in shared
// memory:
//
// - references: the tables are read at the step's arc length t*dt, which
//   does not depend on (x, u).  The per-step references (and the end
//   cost's, at T*dt) are tabulated once per launch, strided over the block,
//   so no rollout step, step cost, derivative or multiplier update repeats
//   the division, floor, ceil and table reads of a lookup;
// - derivatives: threads stride over the active steps; step t's dynamics and
//   augmented cost are evaluated on a second-order forward-mode number
//   (value, gradient and packed Hessian over (x, u)), which gives
//   fx = I + dt*df/dx, fu = dt*df/du, lx, lu, lxx, luu, lux; the end cost's
//   gradient and Hessian at x[T], which start the backward pass, are formed
//   by the last thread beside them;
// - Riccati backward pass: one thread, sequential in t, the 2x2 state
//   algebra in registers, and step t-1's derivative block, control and
//   limits loaded while step t computes, so that no load sits in the chain
//   (at nx=2, nu=1 an exchange between lanes costs more than it saves); the
//   other warps zero the gains of the frozen steps meanwhile;
// - line search: lane 0 of warp w rolls out alpha = 10^-w, then the warp
//   takes its candidate's step costs over its lanes and lane 0 sums them in
//   step order (plus the end cost), with no block barrier in between; the
//   pick, the mu schedule and the termination test are computed by every
//   thread from the 8 sums, so an iteration has 4 block barriers.
//
// On an NVIDIA H100 80GB HBM3 (700 W, SM 1980 MHz) an iteration at H=250
// takes 65 us (lateral) and 88 us (velocity), of which the Riccati pass 40
// and 41; the design before it (lookups inside every rollout step, block
// barriers between rollout, costs and sums) took 71 and 108 us, with
// identical results.
//
// The kernel is a template over the problem (sizes, dynamics, stage cost,
// end cost, constraints, table lookups) and the scalar type; the launcher
// instantiates it for the two problems in float32.  The lookups depend on
// the step alone, so they carry no derivative.  The velocity dynamics
// branch on v > 1 + 1e-3 and the t_min constraint on t_min > 0: the
// derivative is the taken branch's.
// Every sum runs in a fixed order, so the result is deterministic.  Built
// without fast math and with --fmad=false.  Input and output layouts: see
// tpl_tpu_torch/optim/ilqr_rstp.py (input_layout, output_layout); mu_step
// travels in the last input word and the first word of the output's tail.
// The PROF = true instantiation also returns thread 0's clock64() cycles per
// phase; its results are bit-equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ilqr_common.cuh"
#include "ilqr_jet.cuh"
#include "ilqr_rstp_problems.cuh"
#include "smem_limit.cuh"

namespace ilqr_rstp {

using namespace ilqr_common;
using namespace ilqr_jet;

// ---------------------------------------------------------------------
// the solve, generic in the problem

template <class P, typename R>
struct Solve {
  static constexpr int NX = P::NX, NU = P::NU, NC = P::NC;
  static constexpr int NV = NX + NU;
  typedef Jet<R, NV> J;
  typedef Jet<R, NX> JX;
  typedef typename P::Ref Ref;
  static constexpr int NR = sizeof(Ref) / sizeof(R);   // words per Ref
  static_assert(NU == 1, "the action solve is the nu = 1 closed form");
  static_assert(sizeof(Ref) % sizeof(R) == 0, "a Ref is made of R words");

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

  struct Smem {
    R *xs, *us, *lam, *ulim, *bw, *cfg, *alphas, *scal, *tab, *mu;
    R *refs, *der, *kk, *KK, *cx, *cu, *cstep, *ccost, *VxT, *VxxT;
    size_t in_len;             // words copied from the input
  };

  __host__ __device__ static size_t carve(R* base, int H, int n_ref,
                                          Smem* m) {
    size_t o = 0;
    auto take = [&](size_t n) {
      R* p = base ? base + o : nullptr;
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
    s.scal = take(P::NS);
    s.tab = take((size_t)P::NT * n_ref);
    s.mu = take(1);
    s.in_len = o;
    s.refs = take((size_t)(H + 1) * NR);   // steps 0 .. H-1, then the end's
    s.der = take((size_t)H * ND);
    s.kk = take((size_t)H * NU);
    s.KK = take((size_t)H * NU * NX);
    s.cx = take((size_t)NA * (H + 1) * NX);
    s.cu = take((size_t)NA * H * NU);
    s.cstep = take((size_t)NA * H);
    s.ccost = take(NA);
    s.VxT = take(NX);
    s.VxxT = take(NX * NX);
    if (m) *m = s;
    return o * sizeof(R);
  }

  // the reference of step t (t == H: of the end cost, at T*dt), tabulated
  // once per launch: it depends on the step's arc length alone
  __device__ static Ref ref(const Smem& m, int t) {
    Ref r;
    R* w = reinterpret_cast<R*>(&r);
#pragma unroll
    for (int i = 0; i < NR; ++i) w[i] = m.refs[t * NR + i];
    return r;
  }

  __device__ static void tabulate_refs(const Prm<R>& Pr, const Smem& m,
                                       int H, int T) {
    for (int t = threadIdx.x; t <= H; t += blockDim.x) {
      const Ref r = P::ref_at(Pr, (R)(t < H ? t : T) * Pr.dt);
      const R* w = reinterpret_cast<const R*>(&r);
#pragma unroll
      for (int i = 0; i < NR; ++i) m.refs[t * NR + i] = w[i];
    }
  }

  // cost + sum(g*lam) + sum(inactive ? 0 : w*g*g)
  template <class S>
  __device__ static S aug_cost(const Prm<R>& Pr, const Ref& r, const S* x,
                               const S* u, const R* lam, const R* bw) {
    S c = P::cost(Pr, r, x, u);
    S g[NC];
    P::constraints(Pr, r, x, u, g);
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
    return c + pen;
  }

  __device__ static void deriv(const Prm<R>& Pr, const Ref& r, const R* x,
                               const R* u, const R* lam, const R* bw,
                               R* d) {
    J X[NX], U[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) X[i] = jvar<R, NV>(x[i], i);
#pragma unroll
    for (int i = 0; i < NU; ++i) U[i] = jvar<R, NV>(u[i], NX + i);
    J f[NX];
    P::dynamics(Pr, r, X, U, f);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j)
        d[D_FX + i * NX + j] = (i == j ? R(1) : R(0)) + Pr.dt * f[i].g[j];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        d[D_FU + i * NU + j] = Pr.dt * f[i].g[NX + j];
    }
    const J c = aug_cost(Pr, r, X, U, lam, bw);
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

  // the end cost at x[min(T, H)] (its reference sits in slot H)
  __device__ static R end_cost(const Prm<R>& Pr, const Smem& m, const R* xs,
                               int H, int T) {
    if constexpr (P::END_COST) {
      const int iT = T < 0 ? 0 : (T > H ? H : T);
      return P::end_cost(Pr, ref(m, H), xs + iT * NX);
    } else {
      return R(0);
    }
  }

  // one Euler step (ilqr._integrate)
  __device__ __forceinline__ static void integrate(const Prm<R>& Pr,
                                                   const Ref& r, const R* x,
                                                   const R* u, R* xn) {
    R f[NX];
    P::dynamics(Pr, r, x, u, f);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = x[i] + Pr.dt * f[i];
  }

  // the end cost's gradient and Hessian at x[T] (zero beyond H or without
  // an end cost): the backward pass starts from them
  __device__ static void end_derivs(const Prm<R>& Pr, const Smem& m, int H,
                                    int T) {
#pragma unroll
    for (int i = 0; i < NX; ++i) m.VxT[i] = R(0);
#pragma unroll
    for (int i = 0; i < NX * NX; ++i) m.VxxT[i] = R(0);
    if constexpr (P::END_COST) {
      if (T > H) return;
      JX X[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) X[i] = jvar<R, NX>(m.xs[T * NX + i], i);
      const JX e = P::end_cost(Pr, ref(m, H), X);
#pragma unroll
      for (int i = 0; i < NX; ++i) m.VxT[i] = e.g[i];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          m.VxxT[i * NX + j] = e.h[i <= j ? hidx<NX>(i, j) : hidx<NX>(j, i)];
    }
  }

  // what one Riccati step reads: the step's derivative block, control and
  // control limits
  struct StepIn {
    R d[ND];
    R ut, lo, hi;
  };

  __device__ __forceinline__ static StepIn load_step(const Smem& m, int t) {
    StepIn s;
#pragma unroll
    for (int i = 0; i < ND; ++i) s.d[i] = m.der[(size_t)t * ND + i];
    s.ut = m.us[t];
    s.lo = m.ulim[2 * t];
    s.hi = m.ulim[2 * t + 1];
    return s;
  }

  // the Riccati backward pass (ilqr.py backward) over steps n-1 .. 0, on
  // the calling thread: the value function in registers, and step t-1's
  // inputs loaded while step t computes, so that no load sits in the chain
  __device__ static void backward(const Smem& m, int n, R mu) {
    R Vx[NX], Vxx[NX * NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) Vx[i] = m.VxT[i];
#pragma unroll
    for (int i = 0; i < NX * NX; ++i) Vxx[i] = m.VxxT[i];
    if (n <= 0) return;
    StepIn cur = load_step(m, n - 1);
    for (int t = n - 1; t >= 0; --t) {
      const StepIn nxt = load_step(m, t > 0 ? t - 1 : 0);
      const R* d = cur.d;
      const R* fx = d + D_FX;
      const R* fu = d + D_FU;
      R Qx[NX], A[NX * NX], B[NX], Qxx[NX * NX], Qux[NX];
      // Qx = lx + fx^T Vx, Qu = lu + fu^T Vx
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += fx[k * NX + i] * Vx[k];
        Qx[i] = d[D_LX + i] + s;
      }
      R s = R(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += fu[k] * Vx[k];
      const R Qu = d[D_LU] + s;
      // A = fx^T Vxx, B = fu^T Vxx
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R a = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) a += fx[k * NX + i] * Vxx[k * NX + j];
          A[i * NX + j] = a;
        }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        R b = R(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) b += fu[k] * Vxx[k * NX + j];
        B[j] = b;
      }
      // Qxx = lxx + A fx, Quu = luu + B fu, Qux = lux + B fx
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          R a = R(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) a += A[i * NX + k] * fx[k * NX + j];
          Qxx[i * NX + j] = d[D_LXX + i * NX + j] + a;
        }
      R qb = R(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) qb += B[k] * fu[k];
      const R Quu = d[D_LUU] + qb;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        R a = R(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) a += B[k] * fx[k * NX + j];
        Qux[j] = d[D_LUX + j] + a;
      }
      // the nu = 1 action solve: zero gain when Quu <= 0
      const R inv = Quu > R(0) ? R(-1) / (Quu + mu) : R(0);
      R k = inv * Qu;
      R K[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) K[j] = inv * Qux[j];
      // the control-limit clamp
      const R c = cur.ut + k;
      const bool over = c > cur.hi, under = c < cur.lo;
      if (over) k = cur.hi - cur.ut;
      if (under) k = cur.lo - cur.ut;
      if (over || under)
#pragma unroll
        for (int j = 0; j < NX; ++j) K[j] = R(0);
      m.kk[t] = k;
#pragma unroll
      for (int j = 0; j < NX; ++j) m.KK[t * NX + j] = K[j];
      // Vxx = Qxx + KQux + KQux^T + (K^T Quu) K,
      // Vx = (K^T Quu) k + K^T Qu + Qux^T k + Qx
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Vxx[i * NX + j] = ((Qxx[i * NX + j] + K[i] * Qux[j])
                             + K[j] * Qux[i]) + (K[i] * Quu) * K[j];
#pragma unroll
      for (int i = 0; i < NX; ++i)
        Vx[i] = (((K[i] * Quu) * k + K[i] * Qu) + Qux[i] * k) + Qx[i];
      cur = nxt;
    }
  }

  // the open-loop rollout with the current controls (no clamp), frozen
  // beyond T, on the calling thread
  __device__ static void open_rollout(const Prm<R>& Pr, const Smem& m, int H,
                                      int T) {
    R x[NX], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = m.xs[i];
    for (int t = 0; t < H; ++t) {
      if (t < T) {
        integrate(Pr, ref(m, t), x, m.us + t * NU, xn);
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) m.xs[(t + 1) * NX + i] = x[i];
    }
  }

  // candidate c's closed-loop rollout at alpha_c (ilqr.py fb_rollouts), on
  // the calling thread
  __device__ static void fb_rollout(const Prm<R>& Pr, const Smem& m, int H,
                                    int T, int c) {
    const R alpha = m.alphas[c];
    R* cx = m.cx + (size_t)c * (H + 1) * NX;
    R* cu = m.cu + (size_t)c * H * NU;
    R x[NX], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = cx[i] = m.xs[i];
    for (int t = 0; t < H; ++t) {
      R u = m.us[t];
      if (t < T) {
        const R* xr = m.xs + t * NX;
        const R* K = m.KK + (size_t)t * NX;
        R s = R(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) s += (x[j] - xr[j]) * K[j];
        u = clampr((u + alpha * m.kk[t]) + s, m.ulim[2 * t],
                   m.ulim[2 * t + 1]);
        integrate(Pr, ref(m, t), x, &u, xn);
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
      }
      cu[t] = u;
#pragma unroll
      for (int i = 0; i < NX; ++i) cx[(t + 1) * NX + i] = x[i];
    }
  }

  template <bool PROF>
  __device__ static void run(R* sm, const R* __restrict__ in,
                             R* __restrict__ out, long long* prof, int H,
                             int n_ref, int T, int max_it, int max_lg) {
    PhaseClock<PROF> pc;
    pc.start();
    Smem m;
    carve(sm, H, n_ref, &m);
    const int tid = threadIdx.x;
    const int lane = tid & (WARP - 1), warp = tid / WARP;
    const int Te = T < H ? T : H;   // steps that move (T may exceed H)

    for (size_t i = tid; i < m.in_len; i += blockDim.x) sm[i] = in[i];
    __syncthreads();
    const Prm<R> Pr{m.scal, m.tab, n_ref, m.cfg[0]};
    tabulate_refs(Pr, m, H, T);
    __syncthreads();
    pc.stamp(PH_LOAD);

    // initial rollout, and its cost with the OLD multipliers; every thread
    // keeps the trajectory cost, mu_step and the iteration count for itself
    if (tid == 0) open_rollout(Pr, m, H, T);
    __syncthreads();
    for (int t = tid; t < H; t += blockDim.x)
      m.cstep[t] = t < T ? aug_cost(Pr, ref(m, t), m.xs + t * NX,
                                    m.us + t * NU, m.lam + t * NC, m.bw)
                         : R(0);
    __syncthreads();
    R cur = R(0);
    for (int t = 0; t < Te; ++t) cur += m.cstep[t];
    cur = cur + end_cost(Pr, m, m.xs, H, T);
    int ms = (int)m.mu[0];
    ms = ms < 0 ? 0 : (ms > 7 ? 7 : ms);
    int iterations = 0;
    pc.stamp(PH_INIT);

    // mu = 0 if mu_step == 0 else 10^(mu_step - 1), mu_step in [0, 7]
    const R mu_of_step[8] = {R(0), R(1), R(10), R(100), R(1e3), R(1e4),
                             R(1e5), R(1e6)};
    for (int lg = 0; lg < max_lg; ++lg) {
      // clipped multiplier update on the active steps
      for (int k = tid; k < Te * NC; k += blockDim.x) {
        const int t = k / NC, i = k % NC;
        R g[NC];
        P::constraints(Pr, ref(m, t), m.xs + t * NX, m.us + t * NU, g);
        R y = m.lam[k] + m.bw[2 * i] * g[i];
        y = y < R(0) ? R(0) : y;
        m.lam[k] = y > m.bw[2 * i + 1] ? m.bw[2 * i + 1] : y;
      }
      __syncthreads();
      pc.stamp(PH_LAM);

      for (int it = 0; it < max_it; ++it) {
        // derivatives of the active steps; the end cost's at x[T] on the
        // last thread beside them
        for (int t = tid; t < Te; t += blockDim.x)
          deriv(Pr, ref(m, t), m.xs + t * NX, m.us + t * NU, m.lam + t * NC,
                m.bw, m.der + (size_t)t * ND);
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
          if (lane == 0) fb_rollout(Pr, m, H, T, warp);
          __syncwarp();
          pc.stamp(PH_ROLLOUT);
          const R* cx = m.cx + (size_t)warp * (H + 1) * NX;
          const R* cu = m.cu + (size_t)warp * H * NU;
          R* cs = m.cstep + (size_t)warp * H;
          for (int t = lane; t < Te; t += WARP)
            cs[t] = aug_cost(Pr, ref(m, t), cx + t * NX, cu + t * NU,
                             m.lam + t * NC, m.bw);
          __syncwarp();
          pc.stamp(PH_STEP_COST);
          if (lane == 0) {
            R s = R(0);
            for (int t = 0; t < Te; ++t) s += cs[t];
            m.ccost[warp] = s + end_cost(Pr, m, cx, H, T);
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
    const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NC;
    for (int i = tid; i < nxo; i += blockDim.x) out[i] = m.xs[i];
    for (int i = tid; i < nuo; i += blockDim.x) out[nxo + i] = m.us[i];
    for (int i = tid; i < nlo; i += blockDim.x) out[nxo + nuo + i] = m.lam[i];
    if (tid == 0) {
      out[nxo + nuo + nlo] = (R)ms;
      out[nxo + nuo + nlo + 1] = cur;
      out[nxo + nuo + nlo + 2] = (R)iterations;
    }
    pc.stamp(PH_STORE);
    pc.store(prof);
  }
};

template <class P, typename R, bool PROF>
__global__ void __launch_bounds__(THREADS)
ilqr_rstp_kernel(const R* __restrict__ in, R* __restrict__ out,
                 long long* prof, int H, int n_ref, int T, int max_it,
                 int max_lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Solve<P, R>::template run<PROF>(reinterpret_cast<R*>(smem_raw), in, out,
                                  prof, H, n_ref, T, max_it, max_lg);
}

}  // namespace ilqr_rstp

// problem ids, as in tpl_tpu_torch/optim/ilqr_rstp.py PROBLEMS
extern "C" size_t ilqr_rstp_smem_bytes(int problem, int H, int n_ref) {
  using namespace ilqr_rstp;
  if (problem == 0)
    return Solve<Lateral<float>, float>::carve(nullptr, H, n_ref, nullptr);
  if (problem == 1)
    return Solve<Velocity<float>, float>::carve(nullptr, H, n_ref, nullptr);
  return 0;
}

#ifdef __CUDACC__
// The dynamic shared-memory limit is raised once per instantiation,
// device and size (smem_limit.cuh), not on every launch.
template <class P, bool PROF>
static int launch(const float* in, float* out, long long* prof, int H,
                  int n_ref, int T, int max_it, int max_lg,
                  cudaStream_t stream) {
  using namespace ilqr_rstp;
  static smem_limit::Marks marks;
  const size_t smem = Solve<P, float>::carve(nullptr, H, n_ref, nullptr);
  cudaError_t err = smem_limit::ensure(ilqr_rstp_kernel<P, float, PROF>, smem,
                                      marks);
  if (err != cudaSuccess) return (int)err;
  ilqr_rstp_kernel<P, float, PROF><<<1, THREADS, smem, stream>>>(
      in, out, prof, H, n_ref, T, max_it, max_lg);
  return (int)cudaGetLastError();
}

template <bool PROF>
static int launch_problem(int problem, const float* in, float* out,
                          long long* prof, int H, int n_ref, int T,
                          int max_it, int max_lg, void* stream) {
  using namespace ilqr_rstp;
  cudaStream_t s = (cudaStream_t)stream;
  if (problem == 0)
    return launch<Lateral<float>, PROF>(in, out, prof, H, n_ref, T, max_it,
                                        max_lg, s);
  if (problem == 1)
    return launch<Velocity<float>, PROF>(in, out, prof, H, n_ref, T, max_it,
                                         max_lg, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ilqr_rstp_update(int problem, const float* in, float* out,
                                int H, int n_ref, int T, int max_it,
                                int max_lg, void* stream) {
  return launch_problem<false>(problem, in, out, nullptr, H, n_ref, T,
                               max_it, max_lg, stream);
}

// the profiling instantiation: the same solve, and thread 0's clock64()
// cycles per phase (ilqr_common::Phase) into prof[N_PHASE]
extern "C" int ilqr_rstp_profile(int problem, const float* in, float* out,
                                 long long* prof, int H, int n_ref, int T,
                                 int max_it, int max_lg, void* stream) {
  return launch_problem<true>(problem, in, out, prof, H, n_ref, T, max_it,
                              max_lg, stream);
}
#endif

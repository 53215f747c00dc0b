// One full augmented-Lagrangian iLQR update of any problem, generic in the
// problem struct, the scalar type and the integrator, in two geometries: a
// block of THREADS threads an instance (the single solve, and a batch small
// enough that every instance has a block of its own at once), and resident
// warps an instance (a larger batch: each warp of a block walks instances,
// a block holding the part they share once).
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
//                                        // (Prm::table, Prm::table2)
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
// step index (the end cost's is T), as the plain version passes it.  A
// traced problem's captured tensors are its constant tables (Prm::ctab,
// Prm::ctab2 at offsets the printer fixed): one array in global memory a
// launch reads through the cache, uploaded once by the wrapper.
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
// The design.  A team (the block, or one warp) strides over the steps for
// the derivatives, the step costs and the multipliers.  The Riccati pass
// runs on one warp's lanes (backward_lanes): each dot product of a step is
// an item of a compile-time list (offsets and strides into the step's
// derivative block and a scratch), every lane forms its items in the
// serial recursion's order, four warp barriers a step; the action solve
// and the clamp are formed by every lane.  Where the derivative blocks lie
// in the global workspace, step t-1's block is staged into shared memory
// with cp.async while step t is formed.  A problem with fewer states than
// LANES_MIN_NX runs the recursion on one lane (backward_serial), which is
// the faster there (measured on the card: at two states always, at three
// where the blocks lie in the workspace).  The line search rolls
// candidates in alpha order, GW at a time (the block: all 8, lane 0 of
// warp c rolling candidate c; a warp: 2 in float64, 4 in float32, on
// lanes 0..GW-1), each round's step
// costs on the lanes and the ordered sums on the rolling lanes, and stops
// at the round that holds the first improving candidate: the pick is the
// one every candidate's rollout would give.  Per-instance arrays sit in
// shared memory up to a limit the host gives (the carve: the arrays in a
// fixed order, each placed in shared memory while it fits and otherwise in
// the launch's global workspace), so any horizon runs at any (nx, nu, nc).
// Every value is formed by the same operations in the same order whichever
// thread forms it, so an instance's bits do not depend on the geometry.
//
// Layouts (tpl_tpu_torch/optim/ilqr_generic.py): the batch's shared part
// is u_lims (H, NU, 2), bw_lim (NCL, 2), cfg_f (dt, min_rel_cost_change),
// alphas (8), tables (NT, n_ref); a row is x0 (NX), u (H, NU), lam (H,
// NCL), scalars (NS), mu_step (1); a result row is x (H+1, NX), u (H, NU),
// lam (H, NCL), (mu_step, traj_costs, iterations); NCL = max(NC, 1).  A
// single solve is a batch of one.  Every sum runs in a fixed order, so the
// result is deterministic and row b's bits do not depend on the batch.
// The PROF = true instantiation also returns the cycles per phase
// (ilqr_common::Phase) of thread 0 of the team on instance 0; its results
// are bit-equal.  The integrator is a runtime argument (each rollout is
// compiled for each integrator, the choice made outside its step loop):
// each (problem, real type) compiles to four kernels, the two geometries
// with and without the profiling.

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

// the fewest states at which the Riccati pass runs on a warp's lanes
constexpr int LANES_MIN_NX = 4;
constexpr int MAX_SLOTS = THREADS / WARP;   // warps (instances) a block

template <typename R>
struct Prm {
  const R* s;     // scalar params
  const R* tab;   // the tables, n_ref each
  int n_ref;
  R dt;
  const R* c = nullptr;   // the constant tables (global memory)

  __device__ Tab<R> table(int k) const {
    return Tab<R>{tab + (size_t)k * n_ref, n_ref};
  }
  // table k read as rows x cols, row-major (rows * cols <= n_ref)
  __device__ Tab2<R> table2(int k, int rows, int cols) const {
    return Tab2<R>{tab + (size_t)k * n_ref, rows, cols};
  }
  __device__ Tab<R> ctab(size_t off, int n) const {
    return Tab<R>{c + off, n};
  }
  __device__ Tab2<R> ctab2(size_t off, int rows, int cols) const {
    return Tab2<R>{c + off, rows, cols};
  }
};

// one real from device memory to shared memory, asynchronously
template <typename R>
__device__ __forceinline__ void copy_async(R* dst, const R* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(R) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

// waits for every asynchronous copy of the calling thread
__device__ __forceinline__ void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
#endif
}

// In the profiling instantiation (PROF) the thread that solves instance 0
// adds clock64() differences per phase to the launch's cycle buffer
// (zeroed by the caller), with reductions that do not wait; the other
// instantiation carries no code and no registers for it.
template <bool PROF>
struct Clock {
  long long last;
  long long* out;

  __device__ __forceinline__ void start(long long* buf) {
    if constexpr (PROF) {
      out = buf;
      if (out) last = clock64();
    }
  }

  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (PROF) {
      if (out) {
        const long long now = clock64();
        atomicAdd(reinterpret_cast<unsigned long long*>(out + phase),
                  (unsigned long long)(now - last));
        last = now;
      }
    }
  }
};

// the block solves one instance: all 8 candidates a round, one a warp
struct BlockTeam {
  static constexpr int NTH = THREADS;
  static constexpr int GW = NA;
  __device__ static int tid() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  // the candidate buffer the calling thread rolls out (-1: none)
  __device__ static int roller() {
    return (threadIdx.x & (WARP - 1)) == 0 && (int)(threadIdx.x / WARP) < GW
               ? (int)(threadIdx.x / WARP)
               : -1;
  }
  // the candidate buffers whose step costs the calling warp forms
  __device__ static int first_buf() { return threadIdx.x / WARP; }
  __device__ static int bufs_of_warp() {
    return (int)(threadIdx.x / WARP) < GW ? 1 : 0;
  }
};

// one warp solves one instance: G candidates a round on lanes 0..G-1
template <int G>
struct WarpTeam {
  static constexpr int NTH = WARP;
  static constexpr int GW = G;
  __device__ static int tid() { return threadIdx.x & (WARP - 1); }
  __device__ static void sync() { __syncwarp(); }
  __device__ static int roller() {
    const int lane = threadIdx.x & (WARP - 1);
    return lane < G ? lane : -1;
  }
  __device__ static int first_buf() { return 0; }
  __device__ static int bufs_of_warp() { return G; }
};

template <class P, typename R>
struct Solve {
  static constexpr int NX = P::NX, NU = P::NU, NC = P::NC;
  static constexpr int NCL = NC > 0 ? NC : 1;   // multiplier columns
  static constexpr int NV = NX + NU;
  // the Riccati pass on the lanes: always from LANES_MIN_NX states, and one
  // state below where the derivative blocks lie in shared memory
  static constexpr bool LANES = NX >= LANES_MIN_NX - 1;
  // the derivative blocks staged from the workspace (the lanes' pass only)
  static constexpr bool STAGE = NX >= LANES_MIN_NX;
  // candidates a round of a warp's line search
  static constexpr int WARP_GW = sizeof(R) == 8 ? 2 : 4;
  typedef Jet<R, NV> J;
  typedef Jet<R, NX> JX;
  typedef WarpTeam<WARP_GW> Warp;

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

  // the Riccati scratch of backward_lanes: the value function, the
  // products of the step and the clamped gains
  static constexpr int S_VXX = 0;
  static constexpr int S_VX = S_VXX + NX * NX;
  static constexpr int S_A = S_VX + NX;
  static constexpr int S_B = S_A + NX * NX;
  static constexpr int S_QX = S_B + NU * NX;
  static constexpr int S_QU = S_QX + NX;
  static constexpr int S_QXX = S_QU + NU;
  static constexpr int S_QUU = S_QXX + NX * NX;
  static constexpr int S_QUX = S_QUU + NU * NU;
  static constexpr int S_K = S_QUX + NU * NX;
  static constexpr int S_KF = S_K + NU * NX;
  static constexpr int NSCR = S_KF + NU;

  __host__ __device__ static size_t row_len(int H) {
    return NX + (size_t)H * NU + (size_t)H * NCL + P::NS + 1;
  }
  __host__ __device__ static size_t out_len(int H) {
    return (size_t)(H + 1) * NX + (size_t)H * NU + (size_t)H * NCL + 3;
  }

  struct Mem {
    // the part a batch shares
    R *ulim, *bw, *cfg, *alphas, *tab;
    // an instance's
    R *mu, *ccost, *VxT, *VxxT, *scal, *xs, *us, *kk, *KK, *lam, *cstep;
    R *cx, *cu, *scr, *der, *stage, *row;
    bool staged;   // der lies in the workspace, its steps staged in stage
    bool der_sm;   // der lies in shared memory
    bool row_sm;   // row (the next instance's row) lies in shared memory
  };

  // Takes arrays in order, each from shared memory (base sm) while it fits
  // in cap words and otherwise from the workspace (base ws); with null
  // bases it only counts.
  struct Carver {
    R* sm;
    R* ws;
    size_t cap, o_sm, o_ws;

    __host__ __device__ bool fits(size_t n) const { return o_sm + n <= cap; }
    __host__ __device__ R* take(size_t n, bool* in_sm = nullptr) {
      R* p;
      const bool f = fits(n);
      if (f) {
        p = sm ? sm + o_sm : nullptr;
        o_sm += n;
      } else {
        p = ws ? ws + o_ws : nullptr;
        o_ws += n;
      }
      if (in_sm) *in_sm = f;
      return p;
    }
  };

  // the part every instance of a batch shares, in the resident geometry
  // held once a block at the front of its shared memory
  __host__ __device__ static void carve_shared(Carver& c, int H, int n_ref,
                                               Mem* s) {
    s->ulim = c.take((size_t)H * NU * 2);
    s->bw = c.take(NCL * 2);
    s->cfg = c.take(2);
    s->alphas = c.take(NA);
    s->tab = c.take((size_t)P::NT * n_ref > 0 ? (size_t)P::NT * n_ref : 1);
  }

  // the words of the shared part
  __host__ __device__ static size_t shared_len(int H, int n_ref) {
    Carver c{nullptr, nullptr, ~(size_t)0, 0, 0};
    Mem s{};
    carve_shared(c, H, n_ref, &s);
    return c.o_sm;
  }

  // the derivative blocks, last: where they do not fit in shared memory
  // and the stage (two steps' blocks, taken before them) does, the
  // backward pass stages them
  __host__ __device__ static void carve_der(Carver& c, int H, Mem* s) {
    s->der_sm = false;
    s->der = c.take((size_t)H * ND, &s->der_sm);
    s->staged = s->staged && !s->der_sm;
  }

  // A block of the block geometry at cap words of shared memory: the
  // arrays in the order of the solve's latency (the rollouts' first, the
  // candidates last), the shared part among them; the words taken from
  // shared memory and from the workspace into *n_sm / *n_ws.
  __host__ __device__ static void carve(R* sm, R* ws, int H, int n_ref,
                                        size_t cap, Mem* m, size_t* n_sm,
                                        size_t* n_ws) {
    Carver c{sm, ws, cap, 0, 0};
    Mem s{};
    s.mu = c.take(1);
    s.cfg = c.take(2);
    s.alphas = c.take(NA);
    s.bw = c.take(NCL * 2);
    s.ccost = c.take(NA);
    s.VxT = c.take(NX);
    s.VxxT = c.take(NX * NX);
    s.scal = c.take(P::NS > 0 ? P::NS : 1);
    s.scr = c.take(NSCR);
    s.xs = c.take((size_t)(H + 1) * NX);
    s.us = c.take((size_t)H * NU);
    s.kk = c.take((size_t)H * NU);
    s.KK = c.take((size_t)H * NU * NX);
    s.ulim = c.take((size_t)H * NU * 2);
    s.lam = c.take((size_t)H * NCL);
    if (STAGE && !c.fits((size_t)H * ND)) s.stage = c.take(2 * ND, &s.staged);
    carve_der(c, H, &s);
    s.tab = c.take((size_t)P::NT * n_ref > 0 ? (size_t)P::NT * n_ref : 1);
    s.cstep = c.take((size_t)NA * H);
    s.cx = c.take((size_t)NA * (H + 1) * NX);
    s.cu = c.take((size_t)NA * H * NU);
    if (m) *m = s;
    if (n_sm) *n_sm = c.o_sm;
    if (n_ws) *n_ws = c.o_ws;
  }

  // One slot of the resident geometry (a warp's instance, WARP_GW
  // candidate buffers, a buffer for the next instance's row).  The
  // candidates share their room with the Riccati scratch (the line search
  // and the backward pass never overlap) where both fit; where the slot
  // does not fit whole, the derivative blocks' stage comes early.  m keeps
  // its shared part.
  __host__ __device__ static void carve_slot(Carver& c, int H, Mem* m) {
    constexpr int NB = WARP_GW;
    const size_t cxn = (size_t)NB * (H + 1) * NX;
    const size_t cand = cxn + (size_t)NB * H * NU;
    const size_t uni = cand > (size_t)NSCR ? cand : (size_t)NSCR;
    Mem s = m ? *m : Mem{};
    s.stage = nullptr;
    s.staged = false;
    s.mu = c.take(1);
    s.ccost = c.take(NA);
    s.VxT = c.take(NX);
    s.VxxT = c.take(NX * NX);
    s.scal = c.take(P::NS > 0 ? P::NS : 1);
    const bool joint = c.fits(uni);
    if (joint) {
      R* p = c.take(uni);
      s.scr = s.cx = p;
      s.cu = p ? p + cxn : nullptr;
    } else {
      s.scr = c.take(NSCR);
    }
    const size_t rest = (size_t)(H + 1) * NX + 2 * (size_t)H * NU
                        + (size_t)H * NU * NX + (size_t)H * NCL
                        + (size_t)NB * H + (joint ? 0 : cand) + row_len(H)
                        + (size_t)H * ND;
    if (STAGE && !c.fits(rest)) s.stage = c.take(2 * ND, &s.staged);
    s.xs = c.take((size_t)(H + 1) * NX);
    s.us = c.take((size_t)H * NU);
    s.kk = c.take((size_t)H * NU);
    s.KK = c.take((size_t)H * NU * NX);
    s.lam = c.take((size_t)H * NCL);
    s.cstep = c.take((size_t)NB * H);
    if (!joint) {
      s.cx = c.take(cxn);
      s.cu = c.take((size_t)NB * H * NU);
    }
    s.row_sm = false;
    s.row = c.take(row_len(H), &s.row_sm);
    carve_der(c, H, &s);
    if (m) *m = s;
  }

  // A slot of the resident geometry at cap words of shared memory: the
  // words taken from each into *n_sm / *n_ws.
  __host__ __device__ static void slot_words(int H, size_t cap, size_t* n_sm,
                                             size_t* n_ws) {
    Carver c{nullptr, nullptr, cap, 0, 0};
    carve_slot(c, H, nullptr);
    *n_sm = c.o_sm;
    *n_ws = c.o_ws;
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

  // the derivative block of one step (compiled once for every integrator,
  // geometry and profiling instantiation; its jets stay out of the callers'
  // register allocation)
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

  // the control-limit clamp of step t: the clamped feedforward, no
  // feedback
  __device__ __forceinline__ static void clamp_gains(const Mem& m, int t,
                                                     R* k, R* K) {
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
    }
  }

  // the Riccati backward pass (ilqr.py backward) over steps n-1 .. 0, on
  // the calling thread, the value function in registers
  __device__ __forceinline__ static void backward_serial(const Mem& m,
                                                         int n, R mu) {
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
      clamp_gains(m, t, k, K);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
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

  // One dot product of length NX of a Riccati step: out = [add +] sum_k
  // a[k * sa] * b[k * sb], each operand an offset into the step's
  // derivative block (rel) or into the scratch.
  struct Dot {
    int a, sa, b, sb, add, out;
    bool a_rel, b_rel, add_rel, has_add;
  };

  // the dots of stage 1 (A = fx^T Vxx, B = fu^T Vxx, Qx = lx + fx^T Vx,
  // Qu = lu + fu^T Vx) and of stage 2 (Qxx = lxx + A fx, Quu = luu + B fu,
  // Qux = lux + B fx), by item; an item past the last repeats it
  static constexpr int N1 = NX * NX + NU * NX + NX + NU;
  static constexpr int N2 = NX * NX + NU * NU + NU * NX;
  static constexpr int R1 = (N1 + WARP - 1) / WARP;
  static constexpr int R2 = (N2 + WARP - 1) / WARP;
  static constexpr int R4 = (NX * NX + WARP - 1) / WARP;
  static constexpr int R5 = (NX + WARP - 1) / WARP;

  __device__ __forceinline__ static Dot dot1(int e) {
    e = e < N1 ? e : N1 - 1;
    const int b = e - NX * NX, c = b - NU * NX, d = c - NX;
    if (e < NX * NX)
      return Dot{D_FX + e / NX, NX, S_VXX + e % NX, NX, 0, S_A + e,
                 true, false, false, false};
    if (b < NU * NX)
      return Dot{D_FU + b / NX, NU, S_VXX + b % NX, NX, 0, S_B + b,
                 true, false, false, false};
    if (c < NX)
      return Dot{D_FX + c, NX, S_VX, 1, D_LX + c, S_QX + c,
                 true, false, true, true};
    return Dot{D_FU + d, NU, S_VX, 1, D_LU + d, S_QU + d,
               true, false, true, true};
  }

  __device__ __forceinline__ static Dot dot2(int e) {
    e = e < N2 ? e : N2 - 1;
    const int b = e - NX * NX, c = b - NU * NU;
    if (e < NX * NX)
      return Dot{S_A + (e / NX) * NX, 1, D_FX + e % NX, NX, D_LXX + e,
                 S_QXX + e, false, true, true, true};
    if (b < NU * NU)
      return Dot{S_B + (b / NU) * NX, 1, D_FU + b % NU, NU, D_LUU + b,
                 S_QUU + b, false, true, true, true};
    return Dot{S_B + (c / NX) * NX, 1, D_FX + c % NX, NX, D_LUX + c,
               S_QUX + c, false, true, true, true};
  }

  __device__ __forceinline__ static R dot(const Dot& q, const R* blk,
                                          const R* scr) {
    const R* a = (q.a_rel ? blk : scr) + q.a;
    const R* b = (q.b_rel ? blk : scr) + q.b;
    R s = R(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) s += a[k * q.sa] * b[k * q.sb];
    const R add = (q.add_rel ? blk : scr)[q.add];
    return q.has_add ? add + s : s;
  }

  // row i of K^T Quu from the scratch
  __device__ __forceinline__ static void ktquu(const R* scr, int i, R* kq) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      R s = R(0);
#pragma unroll
      for (int a = 0; a < NU; ++a)
        s += scr[S_K + a * NX + i] * scr[S_QUU + a * NU + c];
      kq[c] = s;
    }
  }

  // step t's derivative block into stage buffer t & 1, by the warp's lanes
  __device__ __forceinline__ static void stage_step(const Mem& m, int t,
                                                    int lane) {
    R* dst = m.stage + (t & 1) * ND;
    const R* src = m.der + (size_t)t * ND;
    for (int i = lane; i < ND; i += WARP) copy_async(dst + i, src + i);
  }

  // the Riccati backward pass (ilqr.py backward) over steps n-1 .. 0 on
  // the 32 lanes of the calling warp: each product of stages 1 and 2 an
  // item of dot1 / dot2, the action solve and the clamp by every lane, the
  // value update's entries on the lanes; the same operations in the same
  // order as backward_serial
  __device__ __forceinline__ static void backward_lanes(const Mem& m, int n,
                                                        R mu) {
    const int lane = threadIdx.x & (WARP - 1);
    R* scr = m.scr;
    for (int i = lane; i < NX * NX; i += WARP) scr[S_VXX + i] = m.VxxT[i];
    for (int i = lane; i < NX; i += WARP) scr[S_VX + i] = m.VxT[i];
    if (m.staged && n > 0) stage_step(m, n - 1, lane);
    __syncwarp();
    for (int t = n - 1; t >= 0; --t) {
      const R* blk;
      if (m.staged) {
        copies_wait();
        __syncwarp();
        if (t > 0) stage_step(m, t - 1, lane);
        blk = m.stage + (t & 1) * ND;
      } else {
        blk = m.der + (size_t)t * ND;
      }
      {
        R res[R1];
#pragma unroll
        for (int r = 0; r < R1; ++r) res[r] = dot(dot1(lane + r * WARP), blk,
                                                  scr);
#pragma unroll
        for (int r = 0; r < R1; ++r) scr[dot1(lane + r * WARP).out] = res[r];
      }
      __syncwarp();
      {
        R res[R2];
#pragma unroll
        for (int r = 0; r < R2; ++r) res[r] = dot(dot2(lane + r * WARP), blk,
                                                  scr);
#pragma unroll
        for (int r = 0; r < R2; ++r) scr[dot2(lane + r * WARP).out] = res[r];
      }
      __syncwarp();
      {
        R k[NU], K[NU * NX];
        solve_action(scr + S_QUU, scr + S_QU, scr + S_QUX, mu, k, K);
        clamp_gains(m, t, k, K);
#pragma unroll
        for (int e = 0; e < NU * NX; ++e)
          if (e % WARP == lane) {
            scr[S_K + e] = K[e];
            m.KK[(size_t)t * NU * NX + e] = K[e];
          }
#pragma unroll
        for (int a = 0; a < NU; ++a)
          if ((NU * NX + a) % WARP == lane) {
            scr[S_KF + a] = k[a];
            m.kk[t * NU + a] = k[a];
          }
      }
      __syncwarp();
      // Vxx = Qxx + KQux + KQux^T + (K^T Quu) K,
      // Vx = (K^T Quu) k + K^T Qu + Qux^T k + Qx
      R vxx[R4], vx[R5];
#pragma unroll
      for (int r = 0; r < R4; ++r) {
        int e = lane + r * WARP;
        e = e < NX * NX ? e : NX * NX - 1;
        const int i = e / NX, j = e % NX;
        R kq[NU];
        ktquu(scr, i, kq);
        R kq_ij = R(0), kq_ji = R(0), kqk = R(0);
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          kq_ij += scr[S_K + a * NX + i] * scr[S_QUX + a * NX + j];
          kq_ji += scr[S_K + a * NX + j] * scr[S_QUX + a * NX + i];
        }
#pragma unroll
        for (int c = 0; c < NU; ++c) kqk += kq[c] * scr[S_K + c * NX + j];
        vxx[r] = ((scr[S_QXX + e] + kq_ij) + kq_ji) + kqk;
      }
#pragma unroll
      for (int r = 0; r < R5; ++r) {
        int i = lane + r * WARP;
        i = i < NX ? i : NX - 1;
        R kq[NU];
        ktquu(scr, i, kq);
        R s1 = R(0), s2 = R(0), s3 = R(0);
#pragma unroll
        for (int c = 0; c < NU; ++c) s1 += kq[c] * scr[S_KF + c];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          s2 += scr[S_K + a * NX + i] * scr[S_QU + a];
          s3 += scr[S_QUX + a * NX + i] * scr[S_KF + a];
        }
        vx[r] = ((s1 + s2) + s3) + scr[S_QX + i];
      }
#pragma unroll
      for (int r = 0; r < R4; ++r) {
        const int e = lane + r * WARP;
        scr[S_VXX + (e < NX * NX ? e : NX * NX - 1)] = vxx[r];
      }
#pragma unroll
      for (int r = 0; r < R5; ++r) {
        const int i = lane + r * WARP;
        scr[S_VX + (i < NX ? i : NX - 1)] = vx[r];
      }
      __syncwarp();
    }
  }

  // the backward pass of steps n-1 .. 0, called by every lane of one warp
  __device__ __forceinline__ static void backward(const Mem& m, int n, R mu) {
    if constexpr (LANES) {
      if (NX >= LANES_MIN_NX || m.der_sm) {
        backward_lanes(m, n, mu);
        return;
      }
    }
    if ((threadIdx.x & (WARP - 1)) == 0) backward_serial(m, n, mu);
    __syncwarp();
  }

  // the open-loop rollout with the current controls (no clamp), frozen
  // beyond T, on the calling thread
  template <int INTEG>
  __device__ __forceinline__ static void open_rollout(const Prm<R>& Pr,
                                                      const Mem& m, int H,
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

  // candidate c's closed-loop rollout at alpha_c (ilqr.py fb_rollouts)
  // into candidate buffer g, on the calling thread
  template <int INTEG>
  __device__ __forceinline__ static void fb_rollout(const Prm<R>& Pr,
                                                    const Mem& m, int H,
                                                    int T, int c, int g) {
    const R alpha = m.alphas[c];
    R* cx = m.cx + (size_t)g * (H + 1) * NX;
    R* cu = m.cu + (size_t)g * H * NU;
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

  // the rollouts of the integrator `integ`, each compiled for its
  // integrator (the integrator's branch outside the step loop)
  __device__ static void open_rollout(const Prm<R>& Pr, const Mem& m, int H,
                                      int T, int integ) {
    if (integ == EULER)
      open_rollout<EULER>(Pr, m, H, T);
    else if (integ == HEUN)
      open_rollout<HEUN>(Pr, m, H, T);
    else
      open_rollout<RK4>(Pr, m, H, T);
  }

  __device__ static void fb_rollout(const Prm<R>& Pr, const Mem& m, int H,
                                    int T, int c, int g, int integ) {
    if (integ == EULER)
      fb_rollout<EULER>(Pr, m, H, T, c, g);
    else if (integ == HEUN)
      fb_rollout<HEUN>(Pr, m, H, T, c, g);
    else
      fb_rollout<RK4>(Pr, m, H, T, c, g);
  }

  // One update of the instance in m by the team (Team: BlockTeam or
  // WarpTeam), from its loaded row to its result row `out`.
  template <class Team, bool PROF>
  __device__ static void solve(const Prm<R>& Pr, const Mem& m,
                               Clock<PROF>& pc, R* out, int H, int T,
                               int max_it, int max_lg, int integ) {
    constexpr int NTH = Team::NTH, GW = Team::GW;
    const int tid = Team::tid();
    const int lane = threadIdx.x & (WARP - 1), warp = tid / WARP;
    const int Te = T < H ? T : H;   // steps that move (T may exceed H)

    // initial rollout, and its cost with the OLD multipliers; every thread
    // keeps the trajectory cost, mu_step and the iteration count for itself
    if (tid == 0) open_rollout(Pr, m, H, T, integ);
    Team::sync();
    for (int t = tid; t < H; t += NTH)
      m.cstep[t] = t < T ? aug_cost(Pr, t, m.xs + t * NX, m.us + t * NU,
                                    m.lam + t * NCL, m.bw)
                         : R(0);
    Team::sync();
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
      for (int k = tid; k < Te * NCL; k += NTH) {
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
      Team::sync();
      pc.stamp(PH_LAM);

      for (int it = 0; it < max_it; ++it) {
        // derivatives of the active steps; the end cost's at x[T] on the
        // team's last thread beside them
        for (int t = tid; t < Te; t += NTH)
          deriv(Pr, t, m.xs + t * NX, m.us + t * NU, m.lam + t * NCL, m.bw,
                m.der + (size_t)t * ND);
        if (tid == NTH - 1) end_derivs(Pr, m, H, T);
        Team::sync();
        pc.stamp(PH_DERIV);

        // the backward pass on the team's first warp; the block's other
        // warps zero the gains of the frozen steps, a warp team first
        if (NTH == WARP || warp > 0) {
          const int z0 = NTH == WARP ? tid : tid - WARP;
          const int zn = NTH == WARP ? WARP : NTH - WARP;
          for (int i = Te * NU + z0; i < H * NU; i += zn) m.kk[i] = R(0);
          for (int i = Te * NU * NX + z0; i < H * NU * NX; i += zn)
            m.KK[i] = R(0);
        }
        if (warp == 0) backward(m, Te, mu_of_step[ms]);
        Team::sync();
        pc.stamp(PH_RICCATI);

        // the line search, GW candidates a round in alpha order: the
        // rolling threads roll them out, each warp takes its buffers' step
        // costs and the rolling threads sum them in step order; the first
        // round that holds an improving candidate ends it
        int pick = -1;
        for (int c0 = 0; c0 < NA && pick < 0; c0 += GW) {
          const int g = Team::roller();
          if (g >= 0) fb_rollout(Pr, m, H, T, c0 + g, g, integ);
          __syncwarp();
          pc.stamp(PH_ROLLOUT);
          const int b0 = Team::first_buf(), nb = Team::bufs_of_warp();
          for (int gb = b0; gb < b0 + nb; ++gb) {
            const R* cx = m.cx + (size_t)gb * (H + 1) * NX;
            const R* cu = m.cu + (size_t)gb * H * NU;
            for (int t = lane; t < Te; t += WARP)
              m.cstep[(size_t)gb * H + t] =
                  aug_cost(Pr, t, cx + t * NX, cu + t * NU, m.lam + t * NCL,
                           m.bw);
          }
          __syncwarp();
          pc.stamp(PH_STEP_COST);
          if (g >= 0) {
            const R* cs = m.cstep + (size_t)g * H;
            R s = R(0);
            for (int t = 0; t < Te; ++t) s += cs[t];
            m.ccost[c0 + g] =
                s + end_cost(Pr, m.cx + (size_t)g * (H + 1) * NX, H, T);
          }
          Team::sync();
          pc.stamp(PH_COST_SUM);
          for (int c = c0 + GW - 1; c >= c0; --c) {
            const R cc = m.ccost[c];
            if (cc < cur && isfinite(cc) && cc >= R(0)) pick = c;
          }
        }

        // the mu schedule and the termination test, by every thread; then
        // the accepted candidate's copy
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
          const int gb = pick % GW;
          const R* cx = m.cx + (size_t)gb * (H + 1) * NX;
          const R* cu = m.cu + (size_t)gb * H * NU;
          for (int i = tid; i < (H + 1) * NX; i += NTH) m.xs[i] = cx[i];
          for (int i = tid; i < H * NU; i += NTH) m.us[i] = cu[i];
        }
        Team::sync();
        pc.stamp(PH_PICK);
        if (rel < m.cfg[1]) break;
      }
    }

    // outputs: x, u, lam, mu_step, traj_costs, iterations
    const int nxo = (H + 1) * NX, nuo = H * NU, nlo = H * NCL;
    for (int i = tid; i < nxo; i += NTH) out[i] = m.xs[i];
    for (int i = tid; i < nuo; i += NTH) out[nxo + i] = m.us[i];
    for (int i = tid; i < nlo; i += NTH) out[nxo + nuo + i] = m.lam[i];
    if (tid == 0) {
      out[nxo + nuo + nlo] = (R)ms;
      out[nxo + nuo + nlo + 1] = cur;
      out[nxo + nuo + nlo + 2] = (R)iterations;
    }
    pc.stamp(PH_STORE);
  }

  // The block geometry: block b solves row b; its arrays in `sm` up to cap
  // words and the rest in its slice of the workspace.
  template <bool PROF>
  __device__ static void run(R* sm, R* ws_all, size_t cap,
                             const R* __restrict__ shared,
                             const R* __restrict__ rows,
                             R* __restrict__ out_all, long long* prof, int H,
                             int n_ref, int T, int max_it, int max_lg,
                             int integ, const R* consts = nullptr) {
    Clock<PROF> pc;
    pc.start(threadIdx.x == 0 && blockIdx.x == 0 ? prof : nullptr);
    const int b = blockIdx.x;
    size_t n_ws = 0;
    carve(nullptr, nullptr, H, n_ref, cap, nullptr, nullptr, &n_ws);
    Mem m;
    carve(sm, ws_all + (size_t)b * n_ws, H, n_ref, cap, &m, nullptr,
          nullptr);
    const R* row = rows + (size_t)b * row_len(H);
    const int tid = threadIdx.x;

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
    const Prm<R> Pr{m.scal, m.tab, n_ref, m.cfg[0], consts};
    pc.stamp(PH_LOAD);
    solve<BlockTeam, PROF>(Pr, m, pc, out_all + (size_t)b * out_len(H), H,
                           T, max_it, max_lg, integ);
  }

  // The resident geometry: `slots` warps a block, warp w of block k taking
  // instances k * slots + w, then every gridDim.x * slots further.  The
  // shared part lies once at the front of `sm`; slot w's arrays follow it
  // (cap_slot words each, the rest in the slot's slice of the workspace).
  // A slot whose row buffer lies in shared memory stages the next
  // instance's row with cp.async while it solves the current one.
  template <bool PROF>
  __device__ static void run_resident(R* sm, R* ws_all, size_t cap_slot,
                                      int slots, const R* __restrict__ shared,
                                      const R* __restrict__ rows,
                                      R* __restrict__ out_all,
                                      long long* prof, int B, int H,
                                      int n_ref, int T, int max_it,
                                      int max_lg, int integ,
                                      const R* consts = nullptr) {
    Mem m{};
    {
      Carver c{sm, nullptr, ~(size_t)0, 0, 0};
      carve_shared(c, H, n_ref, &m);
      const R* p = shared;
      auto copy = [&](R* dst, size_t n) {
        for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = p[i];
        p += n;
      };
      copy(m.ulim, (size_t)H * NU * 2);
      copy(m.bw, NCL * 2);
      copy(m.cfg, 2);
      copy(m.alphas, NA);
      copy(m.tab, (size_t)P::NT * n_ref);
    }
    __syncthreads();
    const int w = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
    size_t slot_sm, slot_ws;
    slot_words(H, cap_slot, &slot_sm, &slot_ws);
    {
      const int slot = blockIdx.x * slots + w;
      Carver c{sm + shared_len(H, n_ref) + (size_t)w * slot_sm,
               ws_all + (size_t)slot * slot_ws, cap_slot, 0, 0};
      carve_slot(c, H, &m);
    }
    const Prm<R> Pr{m.scal, m.tab, n_ref, m.cfg[0], consts};
    const size_t rl = row_len(H);
    const int stride = gridDim.x * slots;
    auto stage_row = [&](int b) {
      const R* src = rows + (size_t)b * rl;
      for (size_t i = lane; i < rl; i += WARP) copy_async(m.row + i, src + i);
    };
    int b = blockIdx.x * slots + w;
    if (m.row_sm && b < B) stage_row(b);
    for (; b < B; b += stride) {
      Clock<PROF> pc;
      pc.start(b == 0 && lane == 0 ? prof : nullptr);
      const R* p = rows + (size_t)b * rl;
      if (m.row_sm) {
        copies_wait();
        __syncwarp();
        p = m.row;
      }
      auto copy = [&](R* dst, size_t n) {
        for (size_t i = lane; i < n; i += WARP) dst[i] = p[i];
        p += n;
      };
      copy(m.xs, NX);
      copy(m.us, (size_t)H * NU);
      copy(m.lam, (size_t)H * NCL);
      copy(m.scal, P::NS);
      copy(m.mu, 1);
      __syncwarp();
      if (m.row_sm && b + stride < B) stage_row(b + stride);
      pc.stamp(PH_LOAD);
      solve<Warp, PROF>(Pr, m, pc, out_all + (size_t)b * out_len(H), H, T,
                        max_it, max_lg, integ);
      __syncwarp();
    }
  }
};

// The block geometry is for a solve's latency, so the compiler may give it
// every register a thread of a lone block can have (left to choose, it
// held the small problems to 128 registers and spilled on the card).
template <class P, typename R, bool PROF>
__global__ void __launch_bounds__(THREADS, 1)
ilqr_generic_kernel(const R* __restrict__ shared, const R* __restrict__ rows,
                    R* __restrict__ out, R* ws, long long* prof, size_t cap,
                    int H, int n_ref, int T, int max_it, int max_lg,
                    int integ, const R* __restrict__ consts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Solve<P, R>::template run<PROF>(reinterpret_cast<R*>(smem_raw), ws, cap,
                                  shared, rows, out, prof, H, n_ref, T,
                                  max_it, max_lg, integ, consts);
}

template <class P, typename R, bool PROF>
__global__ void __launch_bounds__(MAX_SLOTS * WARP)
ilqr_generic_resident(const R* __restrict__ shared,
                      const R* __restrict__ rows, R* __restrict__ out, R* ws,
                      long long* prof, size_t cap_slot, int slots, int B,
                      int H, int n_ref, int T, int max_it, int max_lg,
                      int integ, const R* __restrict__ consts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Solve<P, R>::template run_resident<PROF>(
      reinterpret_cast<R*>(smem_raw), ws, cap_slot, slots, shared, rows, out,
      prof, B, H, n_ref, T, max_it, max_lg, integ, consts);
}

// the words of shared memory (which = 0) and of workspace a block (which =
// 1) of the block geometry of problem P in R at H, n_ref, when a block may
// use smem_limit bytes
template <class P, typename R>
inline size_t split_words(int H, int n_ref, size_t smem_limit, int which) {
  size_t n_sm = 0, n_ws = 0;
  Solve<P, R>::carve(nullptr, nullptr, H, n_ref, smem_limit / sizeof(R),
                     nullptr, &n_sm, &n_ws);
  return which == 0 ? n_sm : n_ws;
}

// A launch's geometry: the block geometry (resident = 0: `blocks` blocks of
// THREADS threads, one an instance) or the resident one (`blocks` blocks of
// `slots` warps); `smem` bytes of dynamic shared memory a block, `cap`
// words of it for a block's (or a slot's) arrays, `unit_ws` words of
// workspace a block (or slot) and `units` blocks (or slots) in all;
// `per_sm` blocks an SM.
struct Geometry {
  long long resident, slots, blocks, per_sm, smem, cap, unit_ws, units;
};

#ifdef __CUDACC__
// The launchers keep function-local statics (the last shape's geometry,
// the shared-memory marks).  In a template of external linkage the
// toolchain makes such a static one object for the whole process, shared
// by every library that instantiates the same template (two builds of
// this source compared in one process would read each other's marks), so
// they have internal linkage here.
namespace {

// The geometry of a launch of B instances: the block geometry while every
// instance can have a block of its own at once (the blocks an SM at the
// block's shared memory, by the occupancy calculator, times the SMs), else
// resident warps: the warps an SM the resident kernel's registers allow
// (at most two blocks of MAX_SLOTS), the shared memory an SM split among
// its blocks, the shared part once a block and the rest among its slots.
template <class P, typename R, bool PROF>
inline cudaError_t geometry(int B, int H, int n_ref, size_t smem_limit,
                            Geometry* g) {
  // the last shape's two geometries, by device
  struct Shape {
    int H = -1, n_ref = -1, sms = 0;
    size_t limit = 0;
    Geometry team, res;
  };
  static Shape last[smem_limit::MAX_DEVICES];
  static smem_limit::Marks team_marks, res_marks;
  auto team = ilqr_generic_kernel<P, R, PROF>;
  auto res = ilqr_generic_resident<P, R, PROF>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Shape scratch;
  Shape& s = dev >= 0 && dev < smem_limit::MAX_DEVICES ? last[dev] : scratch;
  if (s.H != H || s.n_ref != n_ref || s.limit != smem_limit) {
    int sms = 0, smem_sm = 0, reserved = 0, team_per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    const size_t team_smem =
        split_words<P, R>(H, n_ref, smem_limit, 0) * sizeof(R);
    if (err == cudaSuccess)
      err = smem_limit::ensure(team, team_smem, team_marks);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &team_per_sm, team, THREADS, team_smem);
    if (err != cudaSuccess) return err;
    s.team = Geometry{0, 1, 0, team_per_sm, (long long)team_smem,
                      (long long)(smem_limit / sizeof(R)),
                      (long long)split_words<P, R>(H, n_ref, smem_limit, 1),
                      0};
    s.res = Geometry{};
    int warps = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&warps, res, WARP, 0);
    if (err != cudaSuccess) return err;
    warps = warps < 2 * MAX_SLOTS ? warps : 2 * MAX_SLOTS;
    const int per_sm = warps > 0 ? (warps + MAX_SLOTS - 1) / MAX_SLOTS : 1;
    const int slots = warps / per_sm;
    size_t budget = (size_t)smem_sm / per_sm - (size_t)reserved;
    budget = budget < smem_limit ? budget : smem_limit;
    const size_t sh = Solve<P, R>::shared_len(H, n_ref);
    if (slots > 0 &&
        budget / sizeof(R) >= sh + (size_t)slots * Solve<P, R>::NSCR) {
      const size_t cap = (budget / sizeof(R) - sh) / slots;
      size_t slot_sm = 0, slot_ws = 0;
      Solve<P, R>::slot_words(H, cap, &slot_sm, &slot_ws);
      const size_t smem = (sh + (size_t)slots * slot_sm) * sizeof(R);
      int nb = 0;
      err = smem_limit::ensure(res, smem, res_marks);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &nb, res, slots * WARP, smem);
      if (err != cudaSuccess) return err;
      if (nb > 0)
        s.res = Geometry{1, slots, 0, nb, (long long)smem, (long long)cap,
                         (long long)slot_ws, 0};
    }
    s.H = H;
    s.n_ref = n_ref;
    s.limit = smem_limit;
    s.sms = sms;
  }
  if (B <= s.sms * s.team.per_sm || !s.res.resident) {
    *g = s.team;
    g->blocks = g->units = B;
    return cudaSuccess;
  }
  *g = s.res;
  const long long most = (long long)s.sms * g->per_sm;
  const long long blocks = ((long long)B + g->slots - 1) / g->slots;
  g->blocks = blocks < most ? blocks : most;
  g->units = g->blocks * g->slots;
  return cudaSuccess;
}

// One launch of B instances in the geometry above (prof: the cycle
// buffer, which selects the profiling instantiation, or null); the dynamic
// shared-memory limit is raised once per kernel, device and size
// (smem_limit.cuh).
template <class P, typename R, bool PROF>
inline int launch_instance(int integrator, const R* shared, const R* rows,
                           R* out, R* ws, long long* prof, int B, int H,
                           int n_ref, int T, int max_it, int max_lg,
                           size_t smem_limit, cudaStream_t stream,
                           const R* consts) {
  Geometry g;
  cudaError_t err = geometry<P, R, PROF>(B, H, n_ref, smem_limit, &g);
  if (err != cudaSuccess) return (int)err;
  if (g.resident)
    ilqr_generic_resident<P, R, PROF>
        <<<(unsigned)g.blocks, (unsigned)(g.slots * WARP), (size_t)g.smem,
           stream>>>(shared, rows, out, ws, prof, (size_t)g.cap,
                     (int)g.slots, B, H, n_ref, T, max_it, max_lg,
                     integrator, consts);
  else
    ilqr_generic_kernel<P, R, PROF><<<B, THREADS, (size_t)g.smem, stream>>>(
        shared, rows, out, ws, prof, (size_t)g.cap, H, n_ref, T, max_it,
        max_lg, integrator, consts);
  return (int)cudaGetLastError();
}

template <class P, typename R>
inline int launch(int integrator, const void* shared, const void* rows,
                  void* out, void* ws, long long* prof, int B, int H,
                  int n_ref, int T, int max_it, int max_lg,
                  size_t smem_limit, void* stream,
                  const void* consts = nullptr) {
  if (integrator != EULER && integrator != HEUN && integrator != RK4)
    return (int)cudaErrorInvalidValue;
  const R* c = (const R*)consts;
  const R* sh = (const R*)shared;
  const R* rw = (const R*)rows;
  R* o = (R*)out;
  R* w = (R*)ws;
  cudaStream_t s = (cudaStream_t)stream;
  return prof ? launch_instance<P, R, true>(integrator, sh, rw, o, w, prof,
                                            B, H, n_ref, T, max_it, max_lg,
                                            smem_limit, s, c)
              : launch_instance<P, R, false>(integrator, sh, rw, o, w, prof,
                                             B, H, n_ref, T, max_it, max_lg,
                                             smem_limit, s, c);
}

// the geometry of a launch of B instances (prof: the profiling
// instantiation's)
template <class P, typename R>
inline int launch_geometry(bool prof, int B, int H, int n_ref,
                           size_t smem_limit, Geometry* g) {
  return (int)(prof ? geometry<P, R, true>(B, H, n_ref, smem_limit, g)
                    : geometry<P, R, false>(B, H, n_ref, smem_limit, g));
}

// registers, local (spill) bytes and static shared bytes of the block
// geometry's kernel or the resident one's (prof: the profiling
// instantiation's)
template <class P, typename R>
inline int attributes(bool resident, bool prof, long long* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (resident)
    err = prof ? cudaFuncGetAttributes(&a, ilqr_generic_resident<P, R, true>)
               : cudaFuncGetAttributes(&a, ilqr_generic_resident<P, R, false>);
  else
    err = prof ? cudaFuncGetAttributes(&a, ilqr_generic_kernel<P, R, true>)
               : cudaFuncGetAttributes(&a, ilqr_generic_kernel<P, R, false>);
  out[0] = a.numRegs;
  out[1] = (long long)a.localSizeBytes;
  out[2] = (long long)a.sharedSizeBytes;
  return (int)err;
}

// loads every kernel's code onto the current device and raises their
// shared-memory limits
template <class P, typename R>
inline int prepare() {
  static smem_limit::Marks marks[4];
  cudaError_t err = cudaSuccess;
  int i = 0;
  auto one = [&](auto kernel) {
    if (err == cudaSuccess) err = smem_limit::prepare(kernel, marks[i]);
    ++i;
  };
  one(ilqr_generic_kernel<P, R, false>);
  one(ilqr_generic_kernel<P, R, true>);
  one(ilqr_generic_resident<P, R, false>);
  one(ilqr_generic_resident<P, R, true>);
  return (int)err;
}
}  // namespace
#endif  // __CUDACC__

}  // namespace ilqr_generic

#endif  // TPL_TPU_TORCH_ILQR_GENERIC_BODY_CUH_

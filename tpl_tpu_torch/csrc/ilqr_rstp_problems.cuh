// The two RSTP profile problems of csrc/ilqr_rstp.cu (lateral_profile and
// velocity_profile_space of tpl_tpu_torch/optim/problems.py): their sizes,
// dynamics, stage cost, end cost and constraints, and the table lookups of
// a step, which depend on its arc length alone (struct Ref).  The RSTP
// kernel tabulates each step's Ref once per launch; csrc/ilqr_generic.cu
// looks it up at each evaluation.

#ifndef TPL_TPU_TORCH_ILQR_RSTP_PROBLEMS_CUH_
#define TPL_TPU_TORCH_ILQR_RSTP_PROBLEMS_CUH_

#include "ilqr_jet.cuh"

namespace ilqr_rstp {

using namespace ilqr_jet;

// ---------------------------------------------------------------------
// the problems (tpl_tpu_torch/optim/problems.py)

template <typename R>
struct Prm {
  const R* s;     // scalars
  const R* tab;   // the problem's tables, n_ref each
  int n_ref;
  R dt;
};

// lateral_profile: states (d, v_d), action a_d
template <typename R>
struct Lateral {
  static constexpr int NX = 2, NU = 1, NC = 2, NS = 5, NT = 4;
  static constexpr bool END_COST = true;
  enum { REF_STEP, W_D, W_V_D, W_A_D, W_K };
  enum { K_REF, D_OFFSET, D_LOWER, D_UPPER };

  struct Ref {
    R k_r, d_o, d_lo, d_up;
  };

  // the reference at arc length s
  __device__ static Ref ref_at(const Prm<R>& P, R s) {
    const int n = P.n_ref;
    const Lookup<R> lk = lerp_at(s, P.s[REF_STEP], n);
    Ref r;
    r.k_r = lerp_row(lk, P.tab + K_REF * n);
    r.d_o = lerp_row(lk, P.tab + D_OFFSET * n);
    r.d_lo = lerp_row(lk, P.tab + D_LOWER * n);
    r.d_up = lerp_row(lk, P.tab + D_UPPER * n);
    return r;
  }

  template <class S>
  __device__ static void dynamics(const Prm<R>&, const Ref&, const S* x,
                                  const S* u, S* f) {
    f[0] = x[1];
    f[1] = u[0];
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, const Ref& r, const S* x,
                           const S* u) {
    const S& d = x[0];
    const S& v_d = x[1];
    const S& a_d = u[0];
    const R* p = P.s;
    const S k = (a_d / (sq(v_d) + R(1)) + r.k_r) * fcos(fatan(v_d))
                / (R(1) - d * r.k_r);
    S c = p[W_D] * sq(d - r.d_o) + p[W_V_D] * sq(v_d);
    c = c + p[W_A_D] * sq(a_d);
    return c + p[W_K] * sq(k);
  }

  template <class S>
  __device__ static void constraints(const Prm<R>&, const Ref& r, const S* x,
                                     const S*, S* g) {
    g[0] = r.d_lo - x[0];
    g[1] = x[0] - r.d_up;
  }

  // r: the reference at the end's arc length T*dt
  template <class S>
  __device__ static S end_cost(const Prm<R>& P, const Ref& r, const S* x) {
    return P.s[W_D] * sq(x[0] - r.d_o) + P.s[W_V_D] * sq(x[1]);
  }
};

// velocity_profile_space: states (v, st), action a
template <typename R>
struct Velocity {
  static constexpr int NX = 2, NU = 1, NC = 5, NS = 4, NT = 6;
  static constexpr bool END_COST = false;
  enum { P_V, P_A, MAX_A_TOTAL, REF_STEP };
  enum { REF_V, REF_K, REF_T_MAX, REF_T_MIN, REF_T_OFFSET, REF_V_WEIGHT };

  struct Ref {
    R v_trg, v_w, t_min, t_max, kk, t_off;
  };

  // the reference at arc length s
  __device__ static Ref ref_at(const Prm<R>& P, R s) {
    const int n = P.n_ref;
    const Lookup<R> lk = lerp_at(s, P.s[REF_STEP], n);
    Ref r;
    r.v_trg = lerp_row(lk, P.tab + REF_V * n);
    r.v_w = lerp_row(lk, P.tab + REF_V_WEIGHT * n);
    r.t_min = lerp_row(lk, P.tab + REF_T_MIN * n);
    r.t_max = lerp_row(lk, P.tab + REF_T_MAX * n);
    r.kk = box_row(s, P.s[REF_STEP], n, P.tab + REF_K * n);
    r.t_off = box_row(s, P.s[REF_STEP], n, P.tab + REF_T_OFFSET * n);
    return r;
  }

  // dv/ds = a/v, dt/ds = 1/v above v = 1 + 1e-3; a and t_offset below
  template <class S>
  __device__ static void dynamics(const Prm<R>&, const Ref& r, const S* x,
                                  const S* u, S* f) {
    if (val(x[0]) > (R)(1.0 + 1e-3)) {
      f[0] = u[0] / x[0];
      f[1] = R(1) / x[0];
    } else {
      f[0] = u[0];
      f[1] = S(r.t_off);
    }
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, const Ref& r, const S* x,
                           const S* u) {
    const R* p = P.s;
    return p[P_V] * sq(r.v_trg - x[0]) * r.v_w + p[P_A] * sq(u[0]);
  }

  template <class S>
  __device__ static void constraints(const Prm<R>& P, const Ref& r,
                                     const S* x, const S* u, S* g) {
    const S& v = x[0];
    const S& st = x[1];
    const S a_lat = sq(v) * r.kk;
    g[0] = (sq(u[0]) + sq(a_lat)) - sq(P.s[MAX_A_TOTAL]);
    g[1] = R(1) - v;
    g[2] = v - r.v_trg;
    g[3] = (st + r.t_off) - r.t_max;
    if (r.t_min > R(0))
      g[4] = (r.t_min - st) * (v - R(1));
    else
      g[4] = (r.t_min - st) * R(1);
  }

  template <class S>
  __device__ static S end_cost(const Prm<R>&, const Ref&, const S*) {
    return S(R(0));
  }
};

}  // namespace ilqr_rstp

#endif  // TPL_TPU_TORCH_ILQR_RSTP_PROBLEMS_CUH_

// The generic AL-iLQR kernel (csrc/ilqr_generic_body.cuh) for the native
// problems without a kernel of their own, for the RSTP profiles in a batch
// and for the two tracking MPCs beyond their own kernels' horizons (and the
// time-indexed one in a batch), float32 and float64, EULER / HEUN / RK4,
// single and batched.
//
// Replaces: the XLA programs of tpl_tpu/optim/ilqr.py:126
// (make_update_fn) and tpl_tpu/optim/batched.py:30
// (make_batched_update_fn) for these problems.  The structs are
// transcriptions of tpl_tpu_torch/optim/problems.py (trajectory_tracking_mpc,
// trajectory_tracking_mpc_time, velocity_profile_time, ref_line_smoother_k,
// ref_line_smoother_dk); the
// RSTP profiles (lateral_profile, velocity_profile_space) adapt
// csrc/ilqr_rstp_problems.cuh, looking a step's references up where the
// RSTP kernel tabulates them.  Problem ids, scalar and table orders: see
// tpl_tpu_torch/optim/ilqr_generic.py NATIVE.

#include "ilqr_generic_body.cuh"
#include "ilqr_rstp_problems.cuh"

namespace ilqr_generic {

// ref_line_smoother_k: states (x, y, theta), action the curvature
template <typename R>
struct RefLineSmootherK {
  static constexpr int NX = 3, NU = 1, NC = 0, NS = 3, NT = 2;
  static constexpr bool END_COST = false;
  enum { W_POS, W_K, REF_STEP };
  enum { REF_X, REF_Y };

  template <class S>
  __device__ static void dynamics(const Prm<R>&, int, const S* x,
                                  const S* u, S* f) {
    f[0] = j_cos(x[2]);
    f[1] = j_sin(x[2]);
    f[2] = u[0];
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, int t, const S* x, const S* u) {
    const R s = R(t) * P.dt;
    const R x_ref = j_lerp(R(0), P.s[REF_STEP], s, P.table(REF_X));
    const R y_ref = j_lerp(R(0), P.s[REF_STEP], s, P.table(REF_Y));
    return (P.s[W_POS] * sq(x[0] - x_ref) + P.s[W_POS] * sq(x[1] - y_ref))
           + P.s[W_K] * sq(u[0]);
  }
};

// ref_line_smoother_dk: states (x, y, theta, k), action the curvature rate
template <typename R>
struct RefLineSmootherDK {
  static constexpr int NX = 4, NU = 1, NC = 0, NS = 5, NT = 2;
  static constexpr bool END_COST = false;
  enum { W_POS, W_K, W_DK, S_START, REF_STEP };
  enum { REF_X, REF_Y };

  template <class S>
  __device__ static void dynamics(const Prm<R>&, int, const S* x,
                                  const S* u, S* f) {
    f[0] = j_cos(x[2]);
    f[1] = j_sin(x[2]);
    f[2] = x[3];
    f[3] = u[0];
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, int t, const S* x, const S* u) {
    const R s = P.s[S_START] + R(t) * P.dt;
    const R x_ref = j_lerp(R(0), P.s[REF_STEP], s, P.table(REF_X));
    const R y_ref = j_lerp(R(0), P.s[REF_STEP], s, P.table(REF_Y));
    return ((P.s[W_POS] * sq(x[0] - x_ref) + P.s[W_POS] * sq(x[1] - y_ref))
            + P.s[W_K] * sq(x[3]))
           + P.s[W_DK] * sq(u[0]);
  }
};

// velocity_profile_time: states (s, v), action a; the velocity limit is
// looked up at the state's s, the corridor at the step
template <typename R>
struct VelocityProfileTime {
  static constexpr int NX = 2, NU = 1, NC = 4, NS = 3, NT = 3;
  static constexpr bool END_COST = false;
  enum { W_V, W_A, REF_STEP };
  enum { REF_V, REF_S_MAX, REF_S_MIN };

  template <class S>
  __device__ static void dynamics(const Prm<R>&, int, const S* x,
                                  const S* u, S* f) {
    f[0] = x[1];
    f[1] = u[0];
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, int, const S* x, const S* u) {
    return P.s[W_V] * (R(1000) - x[1]) + P.s[W_A] * sq(u[0]);
  }

  template <class S>
  __device__ static void constraints(const Prm<R>& P, int t, const S* x,
                                     const S*, S* g) {
    const S& s = x[0];
    const S& v = x[1];
    const S v_max = j_lerp(R(0), P.s[REF_STEP], s, P.table(REF_V));
    const R s_max = j_box_interp(R(1), R(t), P.table(REF_S_MAX));
    const R s_min = j_box_interp(R(1), R(t), P.table(REF_S_MIN));
    g[0] = R(0) - v;
    g[1] = v - v_max;
    g[2] = j_select(s_max > R(0), s - s_max, S(R(0)));
    g[3] = j_select(s_min > R(0), s_min - s, S(R(0)));
  }
};

// trajectory_tracking_mpc: states (x, y, phi, delta, v, s_r, a), actions
// (jerk, delta_dot); a kinematic bicycle with a characteristic velocity,
// the course looked up at the progress s_r, a state (the reference speed
// at s_r without its slope)
template <typename R>
struct TrajectoryTrackingMpc {
  static constexpr int NX = 7, NU = 2, NC = 4, NS = 18, NT = 5;
  static constexpr bool END_COST = false;
  enum { PD, PV, PDELTA, MIN_PDELTA_DOT, PDELTA_DOT, MIN_P_PHI_DOT,
         P_PHI_DOT, P_PHI, P_PHI_REF_DOT_DIFF, PA, PJ, L, V_CH, REF_STEP,
         MAX_DELTA, MAX_ACC, MIN_ACC, A_OFFSET };
  enum { REF_X, REF_Y, REF_PHI, REF_K, REF_V };

  // phi_dot, d_r, s_dot and the course's heading and curvature at s_r
  // (problems.py core)
  template <class S>
  struct Core {
    S phi_dot, d_r, s_dot, r_phi, r_k;
  };

  template <class S>
  __device__ static Core<S> core(const Prm<R>& P, const S* x) {
    const S& s_r = x[5];
    const S r_x = j_lerp(R(0), P.s[REF_STEP], s_r, P.table(REF_X));
    const S r_y = j_lerp(R(0), P.s[REF_STEP], s_r, P.table(REF_Y));
    const S r_k = j_lerp(R(0), P.s[REF_STEP], s_r, P.table(REF_K));
    const S r_phi = j_lerp_angle(R(0), P.s[REF_STEP], s_r, P.table(REF_PHI));
    const S phi_dot = (x[4] / (P.s[L] * (R(1) + sq(x[4] / P.s[V_CH]))))
                      * j_tan(x[3]);
    const S d_r = j_cos(r_phi) * (x[1] - r_y) - j_sin(r_phi) * (x[0] - r_x);
    const S s_dot = (x[4] * j_cos(x[2] - r_phi)) / (R(1) - d_r * r_k);
    return Core<S>{phi_dot, d_r, s_dot, r_phi, r_k};
  }

  template <class S>
  __device__ static void dynamics(const Prm<R>& P, int, const S* x,
                                  const S* u, S* f) {
    const Core<S> k = core(P, x);
    f[0] = x[4] * j_cos(x[2]);
    f[1] = x[4] * j_sin(x[2]);
    f[2] = k.phi_dot;
    f[3] = u[1];
    f[4] = x[6] + P.s[A_OFFSET];
    f[5] = k.s_dot;
    f[6] = u[0];
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, int, const S* x, const S* u) {
    const Core<S> k = core(P, x);
    const R v_trg = j_lerp(R(0), P.s[REF_STEP], val(x[5]), P.table(REF_V));
    const S v2 = sq(x[4]);
    S c = (P.s[MIN_PDELTA_DOT] + P.s[PDELTA_DOT] * v2) * sq(u[1]);
    c = c + (P.s[MIN_P_PHI_DOT] + P.s[P_PHI_DOT] * v2) * sq(k.phi_dot);
    c = c + P.s[PA] * sq(x[6]);
    c = c + P.s[PJ] * sq(u[0]);
    c = c + P.s[PV] * sq(x[4] - v_trg);
    c = c + P.s[PD] * sq(k.d_r);
    c = c + P.s[P_PHI] * (R(1) - j_cos(x[2] - k.r_phi));
    c = c + (P.s[P_PHI_REF_DOT_DIFF] * sq(k.phi_dot - k.s_dot * k.r_k)) * v2;
    return c;
  }

  template <class S>
  __device__ static void constraints(const Prm<R>& P, int, const S* x,
                                     const S*, S* g) {
    g[0] = x[3] - P.s[MAX_DELTA];
    g[1] = (-P.s[MAX_DELTA]) - x[3];
    g[2] = x[6] - P.s[MAX_ACC];
    g[3] = P.s[MIN_ACC] - x[6];
  }
};

// trajectory_tracking_mpc_time: states (x, y, phi, delta, v, a), actions
// (jerk, delta_dot); a kinematic bicycle with the slip angle at the centre
// of gravity, the course looked up at the step's time
template <typename R>
struct TrajectoryTrackingMpcTime {
  static constexpr int NX = 6, NU = 2, NC = 4, NS = 19, NT = 4;
  static constexpr bool END_COST = false;
  enum { PD, PV, PDELTA, MIN_PDELTA_DOT, PDELTA_DOT, MIN_P_PHI_DOT,
         P_PHI_DOT, P_PHI, PA, PJ, L, V_CH, COG_POS, REF_DT, REF_T_OFFSET,
         MAX_DELTA, MAX_ACC, MIN_ACC, A_OFFSET };
  enum { REF_X, REF_Y, REF_PHI, REF_V };

  // the slip angle and the yaw rate
  template <class S>
  __device__ static void slip(const Prm<R>& P, const S* x, S* beta,
                              S* phi_dot) {
    const S tan_d = j_tan(x[3]);
    *beta = j_atan(tan_d * P.s[COG_POS]);
    *phi_dot = ((x[4] * tan_d) * j_cos(*beta))
               / (P.s[L] * (R(1) + sq(x[4] / P.s[V_CH])));
  }

  template <class S>
  __device__ static void dynamics(const Prm<R>& P, int, const S* x,
                                  const S* u, S* f) {
    S beta, phi_dot;
    slip(P, x, &beta, &phi_dot);
    f[0] = x[4] * j_cos(x[2] + beta);
    f[1] = x[4] * j_sin(x[2] + beta);
    f[2] = phi_dot;
    f[3] = u[1];
    f[4] = x[5] + P.s[A_OFFSET];
    f[5] = u[0];
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, int t, const S* x, const S* u) {
    const R rt = P.s[REF_T_OFFSET] + P.dt * R(t);
    const R r_x = j_lerp(R(0), P.s[REF_DT], rt, P.table(REF_X));
    const R r_y = j_lerp(R(0), P.s[REF_DT], rt, P.table(REF_Y));
    const R v_trg = j_lerp(R(0), P.s[REF_DT], rt, P.table(REF_V));
    const R r_phi = j_lerp_angle(R(0), P.s[REF_DT], rt, P.table(REF_PHI));
    S beta, phi_dot;
    slip(P, x, &beta, &phi_dot);
    const S v2 = sq(x[4]);
    S c = (P.s[MIN_PDELTA_DOT] + P.s[PDELTA_DOT] * v2) * sq(u[1]);
    c = c + (P.s[MIN_P_PHI_DOT] + P.s[P_PHI_DOT] * v2) * sq(phi_dot);
    c = c + P.s[PA] * sq(x[5]);
    c = c + P.s[PJ] * sq(u[0]);
    c = c + P.s[PV] * sq(x[4] - v_trg);
    c = (c + P.s[PD] * sq(x[0] - r_x)) + P.s[PD] * sq(x[1] - r_y);
    c = c + P.s[P_PHI] * (R(1) - j_cos(x[2] - r_phi));
    return c;
  }

  template <class S>
  __device__ static void constraints(const Prm<R>& P, int, const S* x,
                                     const S*, S* g) {
    g[0] = x[3] - P.s[MAX_DELTA];
    g[1] = (-P.s[MAX_DELTA]) - x[3];
    g[2] = x[5] - P.s[MAX_ACC];
    g[3] = P.s[MIN_ACC] - x[5];
  }
};

// an RSTP profile of csrc/ilqr_rstp_problems.cuh, its references looked up
// at the step's arc length t*dt (the end cost's at T*dt)
template <class Q, typename R>
struct RstpProfile {
  static constexpr int NX = Q::NX, NU = Q::NU, NC = Q::NC, NS = Q::NS,
                       NT = Q::NT;
  static constexpr bool END_COST = Q::END_COST;

  __device__ static ilqr_rstp::Prm<R> prm(const Prm<R>& P) {
    return ilqr_rstp::Prm<R>{P.s, P.tab, P.n_ref, P.dt};
  }

  __device__ static typename Q::Ref ref(const Prm<R>& P, int t) {
    return Q::ref_at(prm(P), R(t) * P.dt);
  }

  template <class S>
  __device__ static void dynamics(const Prm<R>& P, int t, const S* x,
                                  const S* u, S* f) {
    Q::dynamics(prm(P), ref(P, t), x, u, f);
  }

  template <class S>
  __device__ static S cost(const Prm<R>& P, int t, const S* x, const S* u) {
    return Q::cost(prm(P), ref(P, t), x, u);
  }

  template <class S>
  __device__ static void constraints(const Prm<R>& P, int t, const S* x,
                                     const S* u, S* g) {
    Q::constraints(prm(P), ref(P, t), x, u, g);
  }

  template <class S>
  __device__ static S end_cost(const Prm<R>& P, int t, const S* x) {
    return Q::end_cost(prm(P), ref(P, t), x);
  }
};

template <typename R>
using LateralProfile = RstpProfile<ilqr_rstp::Lateral<R>, R>;
template <typename R>
using VelocityProfileSpace = RstpProfile<ilqr_rstp::Velocity<R>, R>;

}  // namespace ilqr_generic

// problem ids, as in tpl_tpu_torch/optim/ilqr_generic.py NATIVE
#define ILQR_GENERIC_PROBLEMS(X)  \
  X(0, RefLineSmootherK)          \
  X(1, RefLineSmootherDK)         \
  X(2, VelocityProfileTime)       \
  X(3, LateralProfile)            \
  X(4, VelocityProfileSpace)      \
  X(5, TrajectoryTrackingMpc)     \
  X(6, TrajectoryTrackingMpcTime)

#include "ilqr_generic_entries.cuh"

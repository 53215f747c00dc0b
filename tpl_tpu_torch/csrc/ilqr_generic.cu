// The generic AL-iLQR kernel (csrc/ilqr_generic_body.cuh) for the native
// problems without a kernel of their own, and for the RSTP profiles in a
// batch, float32 and float64, EULER / HEUN / RK4, single and batched.
//
// Replaces: the XLA programs of tpl_tpu/optim/ilqr.py:126
// (make_update_fn) and tpl_tpu/optim/batched.py:30
// (make_batched_update_fn) for these problems.  The structs are
// transcriptions of tpl_tpu_torch/optim/problems.py:296-385
// (velocity_profile_time, ref_line_smoother_k, ref_line_smoother_dk); the
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
  X(4, VelocityProfileSpace)

#include "ilqr_generic_entries.cuh"

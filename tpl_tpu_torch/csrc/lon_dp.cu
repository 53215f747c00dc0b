// Longitudinal DP of the poly-lat / lon-DP planner chain, for Hopper (sm_90a).
//
// Replaces the two XLA programs of tpl_tpu/planning/dyn_prog/lon_kernel.py
// make_lon_solver (no Pallas kernel): the backward value iteration, a
// lax.scan over the T - 1 slices of `eval_grid` (:197-342, :408-418), and
// the greedy forward pass, a lax.scan of T steps of `eval_single` (:344-393,
// :425-451), which `reeval` (:455-474) runs too with each state's own jerk.
// The reference is lonBackwardStep / evalNode (lon_planner.cu).
//
// lon_dp_backward: one backward slice.  One thread per (s, v, a) node; a
// node tries the NB = 9 jerks: next state, the trilinear value lookup in the
// next slice (an s row shift and a (v, a) bilinear lookup, 8 corners of 3
// channels), cost and constraint terms, and keeps the lexicographic
// (constraint, cost) minimum, the first jerk winning.  The final slice is
// [state_cost, 0, 0, 0] and reads no next slice.  What bounds it: the
// lookups, 72 float4 loads a node (10.7 M a slice at the demo grid, 201 x 37
// x 20 nodes) from a next-slice table of 2.38 MB that sits in L2; the bytes
// the function must move (the table read once, the slice written once) take
// ~1.4 us and its ~0.13 GFLOP ~2 us, so a slice is bound by its loads and,
// at 9 launches a solve, by launch overhead.  Neighbouring threads take
// neighbouring a, so their corner loads fall on neighbouring rows.
//
// lon_dp_forward: one block of one warp.  Mode 0 is the forward pass: T
// dependent steps, the NF = 21 jerks of a step on the lanes (each lane its
// state terms, lookup, cost and constraint), lane 0 the lexicographic
// minimum in jerk order and the next state.  Mode 1 is the reeval pass:
// every row of a stored trajectory with its own jerk, rows on the lanes.
// Bound by the T-step dependency: a few microseconds.
//
// Every operation and its order follow the plain versions
// (tpl_tpu_torch/planning/dyn_prog/lon_kernel.py backward_slice_reference,
// forward_reference, reeval_reference), which the CPU tests hold against the
// JAX package: the grid points and jerk samples are XLA's contracted
// multiply-add (fma32 below, the plain version's fma32), a division by a
// constant is a product with its float32 reciprocal, round is rint
// (round-half-even, as jnp.round), an int cast truncates.  Build with
// --fmad=false so that nothing else is contracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace lon_dp {

constexpr int NB = 9;           // backward jerk samples
constexpr int NF = 21;          // forward jerk samples
constexpr int THREADS = 256;    // backward block
constexpr int WARP = 32;        // forward block

// the packed parameter vector (lon_kernel.py LON_PP_KEYS)
enum Pp {
  S_MIN, S_MAX, V_MIN, V_MAX, A_MIN, A_MAX, J_MIN, J_MAX, DT_START, DT,
  TIME_GAP, GAP_MIN, W_PROGRESS, W_A, W_J, W_SNAP, W_SAFETY_DIST,
  PATH_STEP_SIZE, WIDTH_VEH, LENGTH_VEH, N_PP
};
// lon state columns (LC_*) and path columns (PC_*)
enum { LC_T, LC_S, LC_V, LC_A, LC_J, LC_COST, LC_CONSTR, N_LC };
enum { PC_S = 2, PC_VMAX = 5, N_PC = 7 };

// a * b + c rounded once (exact product in double, one rounding of the sum
// there, then to float): the plain version's fma32
__host__ __device__ inline float fma32(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// lo + (hi - lo) * i / n as XLA on the CPU computes it
__host__ __device__ inline float axis_point(float lo, float hi, int i, int n) {
  return fma32((hi - lo) * (float)i, 1.0f / (float)n, lo);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int mini(int a, int b) { return a < b ? a : b; }

// a read-only load through the texture path
__device__ __forceinline__ float4 load4(const float4* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// column `col` of the path (P, 7) at distance `dist` (interp_path,
// common.cuh:115-139): floor / ceil rows clamped, the fraction unclamped
__device__ __forceinline__ float interp_col(const float* __restrict__ path,
                                            int col, float dist, float pss,
                                            int P) {
  const float a = dist / pss;
  const float i0f = clampf(floorf(a), 0.0f, (float)(P - 1));
  const float i1f = clampf(ceilf(a), 0.0f, (float)(P - 1));
  const float al = a - i0f;
  return path[(int)i0f * N_PC + col] * (1.0f - al)
      + path[(int)i1f * N_PC + col] * al;
}

// the path distance map at the rounded s index, less 0.6 vehicle lengths
__device__ __forceinline__ float s_dist_at(const float* __restrict__ dist_path,
                                           const float* pp, int t_idx,
                                           float s_path, int S) {
  const float si = clampf(rintf((s_path - pp[S_MIN]) / (pp[S_MAX] - pp[S_MIN])
                                * (float)(S - 1)),
                          0.0f, (float)(S - 1));
  return dist_path[t_idx * S + (int)si] - pp[LENGTH_VEH] * 0.6f;
}

struct StateTerms {
  float cost, constr;
};

__device__ __forceinline__ StateTerms state_terms(const float* pp, float s,
                                                  float v, float a,
                                                  float s_dist, float v_max) {
  StateTerms r;
  r.cost = (pp[W_A] * (a * a) + pp[W_PROGRESS] * fabsf(1000.0f - s))
      + pp[W_SAFETY_DIST]
            * fmaxf(v * pp[TIME_GAP] + pp[GAP_MIN] - s_dist, 0.0f);
  r.constr = fmaxf(v - v_max, 0.0f);
  return r;
}

struct Next {
  float s_change, sn, vn, an;
};

// the next state under jerk j over dt (lonDynamics)
__device__ __forceinline__ Next next_state(float s, float v, float a, float j,
                                           float dt) {
  Next n;
  const float ds_change = (v * dt + 0.5f * a * dt * dt)
      + j * (dt * (dt * dt)) * (1.0f / 6.0f);
  n.s_change = fmaxf(ds_change, 0.0f);
  n.vn = fmaxf(v + a * dt + 0.5f * j * dt * dt, 0.0f);
  n.an = a + j * dt;
  n.sn = s + n.s_change;
  return n;
}

// the action's cost and constraint from its looked-up value nn[0..2]
__device__ __forceinline__ void action_terms(
    const float* pp, const float* __restrict__ path, int P, StateTerms st,
    const float (&nn)[3], float j, float dt, const Next& n, float s_dist,
    float* cost_out, float* constr_out) {
  float cost = st.cost + nn[0];
  float constr = st.constr + nn[1];
  const float dj = nn[2] - j;
  cost = cost + pp[W_SNAP] * (dj * dj);
  const float jd = j * dt;
  cost = cost + pp[W_J] * (jd * jd);
  const float v_max_n = interp_col(path, PC_VMAX, n.sn, pp[PATH_STEP_SIZE], P);
  constr = constr + fmaxf(n.vn - v_max_n, 0.0f);
  constr = constr + fmaxf(n.s_change - s_dist, 0.0f);
  constr = constr + fmaxf(pp[A_MIN] - n.an, 0.0f);
  constr = constr + fmaxf(n.an - pp[A_MAX], 0.0f);
  *cost_out = cost;
  *constr_out = constr;
}

// ---------------------------------------------------------------------
// backward slice

__global__ void __launch_bounds__(THREADS)
lon_backward_kernel(const float4* __restrict__ nodes_next,
                    const float* __restrict__ pp_in,
                    const float* __restrict__ path,
                    const float* __restrict__ dist_path,
                    float4* __restrict__ out, int S, int V, int A, int P,
                    int t_idx, bool is_last) {
  float pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= S * V * A) return;
  const int i_a = node % A;
  const int i_v = (node / A) % V;
  const int i_s = node / (A * V);

  const float s = axis_point(pp[S_MIN], pp[S_MAX], i_s, S - 1);
  const float v = axis_point(pp[V_MIN], pp[V_MAX], i_v, V - 1);
  const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
  const float pss = pp[PATH_STEP_SIZE];
  const float v_max_s = interp_col(path, PC_VMAX, s, pss, P);
  const float s_dist = s_dist_at(dist_path, pp, t_idx,
                                 interp_col(path, PC_S, s, pss, P), S);
  const StateTerms st = state_terms(pp, s, v, a, s_dist, v_max_s);
  if (is_last) {
    out[node] = make_float4(st.cost, 0.0f, 0.0f, 0.0f);
    return;
  }

  const float dt = pp[DT];
  const float s_step_x = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
  float cost[NB], constr[NB];
#pragma unroll
  for (int jb = 0; jb < NB; ++jb) {
    const float j = axis_point(pp[J_MIN], pp[J_MAX], jb, NB - 1);
    const Next n = next_state(s, v, a, j, dt);
    // the value lookup: a fractional s row shift, a (v, a) bilinear lookup
    const float f_c = n.s_change / s_step_x;
    const float k_c = floorf(f_c);
    const float ax_c = f_c - k_c;
    const float y = clampf((n.vn - pp[V_MIN]) / (pp[V_MAX] - pp[V_MIN])
                           * (float)(V - 1), 0.0f, (float)(V - 1));
    const float z = clampf((n.an - pp[A_MIN]) / (pp[A_MAX] - pp[A_MIN])
                           * (float)(A - 1), 0.0f, (float)(A - 1));
    const float y0f = floorf(y), z0f = floorf(z);
    const float wy0 = 1.0f - (y - y0f);
    const float wz0 = 1.0f - (z - z0f);
    const int y0 = (int)y0f, z0 = (int)z0f;
    const int y1 = mini(y0 + 1, V - 1), z1 = mini(z0 + 1, A - 1);
    const float w00 = wy0 * wz0, w01 = wy0 * (1.0f - wz0);
    const float w10 = (1.0f - wy0) * wz0, w11 = (1.0f - wy0) * (1.0f - wz0);
    const int k = (int)k_c;
    const int rows[2] = {clampi(i_s + k, 0, S - 1),
                         clampi(i_s + k + 1, 0, S - 1)};
    const float ax_row = (float)i_s + f_c >= (float)(S - 1) ? 0.0f : ax_c;
    float b[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int base = rows[r] * V;
      const float4 t00 = load4(nodes_next + (base + y0) * A + z0);
      const float4 t01 = load4(nodes_next + (base + y0) * A + z1);
      const float4 t10 = load4(nodes_next + (base + y1) * A + z0);
      const float4 t11 = load4(nodes_next + (base + y1) * A + z1);
      b[r][0] = ((t00.x * w00 + t01.x * w01) + t10.x * w10) + t11.x * w11;
      b[r][1] = ((t00.y * w00 + t01.y * w01) + t10.y * w10) + t11.y * w11;
      b[r][2] = ((t00.z * w00 + t01.z * w01) + t10.z * w10) + t11.z * w11;
    }
    float nn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nn[c] = b[0][c] * (1.0f - ax_row) + b[1][c] * ax_row;
    action_terms(pp, path, P, st, nn, j, dt, n, s_dist, &cost[jb],
                 &constr[jb]);
  }
  float cmin = constr[0];
#pragma unroll
  for (int jb = 1; jb < NB; ++jb) cmin = fminf(cmin, constr[jb]);
  float best = INFINITY;
  int jbest = 0;
#pragma unroll
  for (int jb = 0; jb < NB; ++jb) {
    const float c = constr[jb] <= cmin ? cost[jb] : INFINITY;
    if (c < best) {
      best = c;
      jbest = jb;
    }
  }
  out[node] = make_float4(best, cmin,
                          axis_point(pp[J_MIN], pp[J_MAX], jbest, NB - 1),
                          0.0f);
}

// ---------------------------------------------------------------------
// forward pass / reeval

// the 8-corner value lookup of the forward pass (trilerp), channels 0..2
__device__ __forceinline__ void trilerp(const float4* __restrict__ nodes,
                                        const float* pp, int S, int V, int A,
                                        float s, float v, float a,
                                        float (&res)[3]) {
  int i0[3], i1[3];
  float fr[3];
  const float q[3] = {s, v, a};
  const float lo[3] = {pp[S_MIN], pp[V_MIN], pp[A_MIN]};
  const float hi[3] = {pp[S_MAX], pp[V_MAX], pp[A_MAX]};
  const int n[3] = {S, V, A};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = clampf((q[d] - lo[d]) / (hi[d] - lo[d]) * (float)(n[d] - 1),
                           0.0f, (float)(n[d] - 1));
    const float c0 = floorf(c);
    i0[d] = (int)c0;
    i1[d] = mini(i0[d] + 1, n[d] - 1);
    fr[d] = c - c0;
  }
  auto at = [&](int x, int y, int z) {
    return load4(nodes + (x * V + y) * A + z);
  };
  const float ax = fr[0], ay = fr[1], az = fr[2];
  const float4 n000 = at(i0[0], i0[1], i0[2]), n100 = at(i1[0], i0[1], i0[2]);
  const float4 n010 = at(i0[0], i1[1], i0[2]), n110 = at(i1[0], i1[1], i0[2]);
  const float4 n001 = at(i0[0], i0[1], i1[2]), n101 = at(i1[0], i0[1], i1[2]);
  const float4 n011 = at(i0[0], i1[1], i1[2]), n111 = at(i1[0], i1[1], i1[2]);
  const float v000[3] = {n000.x, n000.y, n000.z}, v100[3] = {n100.x, n100.y, n100.z};
  const float v010[3] = {n010.x, n010.y, n010.z}, v110[3] = {n110.x, n110.y, n110.z};
  const float v001[3] = {n001.x, n001.y, n001.z}, v101[3] = {n101.x, n101.y, n101.z};
  const float v011[3] = {n011.x, n011.y, n011.z}, v111[3] = {n111.x, n111.y, n111.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = v000[c] * (1.0f - ax) + v100[c] * ax;
    const float c10 = v010[c] * (1.0f - ax) + v110[c] * ax;
    const float c01 = v001[c] * (1.0f - ax) + v101[c] * ax;
    const float c11 = v011[c] * (1.0f - ax) + v111[c] * ax;
    const float c0 = c00 * (1.0f - ay) + c10 * ay;
    const float c1 = c01 * (1.0f - ay) + c11 * ay;
    res[c] = c0 * (1.0f - az) + c1 * az;
  }
}

// the slice row of a state's time (0 before dt_start)
__device__ __forceinline__ int t_index(float t, const float* pp, int T) {
  const float ti = t < pp[DT_START] ? 0.0f
                                    : rintf((t - pp[DT_START]) / pp[DT]) + 1.0f;
  return clampi((int)ti, 0, T - 1);
}

struct Scored {
  StateTerms st;
  float cost, constr;
};

// one action (jerk j) of the state tp with the next slice `nodes_next`
__device__ __forceinline__ Scored score(const float* tp, float j,
                                        const float4* __restrict__ nodes_next,
                                        int t_idx,
                                        const float* __restrict__ dist_path,
                                        const float* __restrict__ path,
                                        const float* pp, float dt, int S,
                                        int V, int A, int P) {
  const float s = tp[LC_S], v = tp[LC_V], a = tp[LC_A];
  const float pss = pp[PATH_STEP_SIZE];
  const float v_max = interp_col(path, PC_VMAX, s, pss, P);
  const float s_dist = s_dist_at(dist_path, pp, t_idx,
                                 interp_col(path, PC_S, s, pss, P), S);
  Scored r;
  r.st = state_terms(pp, s, v, a, s_dist, v_max);
  const Next n = next_state(s, v, a, j, dt);
  float nn[3];
  trilerp(nodes_next, pp, S, V, A, n.sn, n.vn, n.an, nn);
  action_terms(pp, path, P, r.st, nn, j, dt, n, s_dist, &r.cost, &r.constr);
  return r;
}

// the evaluated row: jerk, cost and constraint set unless tp is at the last
// slice (then its state cost)
__device__ __forceinline__ void finish_row(const float* tp, const float* pp,
                                           int T, float state_cost,
                                           float cost_best, float cmin,
                                           float j_best, float* out) {
  const bool is_last = rintf(tp[LC_T] / pp[DT]) == (float)(T - 1);
  for (int c = 0; c < N_LC; ++c) out[c] = tp[c];
  out[LC_J] = is_last ? tp[LC_J] : j_best;
  out[LC_COST] = is_last ? state_cost : cost_best;
  out[LC_CONSTR] = is_last ? tp[LC_CONSTR] : cmin;
}

__global__ void __launch_bounds__(WARP)
lon_forward_kernel(const float4* __restrict__ nodes,
                   const float* __restrict__ pp_in,
                   const float* __restrict__ path,
                   const float* __restrict__ dist_path,
                   const float* __restrict__ states, float* __restrict__ out,
                   int T, int S, int V, int A, int P, int n_rows, int mode) {
  // shared: the parameters, the state, each action's cost and constraint
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pp = reinterpret_cast<float*>(smem_raw);
  float* tp = pp + N_PP;
  float* a_cost = tp + N_LC;
  float* a_constr = a_cost + NF;
  float* a_state_cost = a_constr + NF;
  const int lane = threadIdx.x;
  if (lane >= WARP) return;
  for (int k = lane; k < N_PP; k += WARP) pp[k] = pp_in[k];
  const size_t slice = (size_t)S * V * A;
  __syncwarp();

  if (mode == 1) {
    // reeval: every row with its own jerk, rows on the lanes
    for (int r = lane; r < n_rows; r += WARP) {
      float row[N_LC];
      for (int c = 0; c < N_LC; ++c) row[c] = states[r * N_LC + c];
      const float dt_i = r == 0 ? pp[DT_START] : pp[DT];
      const int t_idx = t_index(row[LC_T], pp, T);
      const Scored sc = score(row, row[LC_J], nodes + mini(r + 1, T - 1) * slice,
                              t_idx, dist_path, path, pp, dt_i, S, V, A, P);
      // one action: cmin is its constraint, the cost survives unless NaN
      const float cost = sc.constr <= sc.constr ? sc.cost : INFINITY;
      finish_row(row, pp, T, sc.st.cost, cost, sc.constr, row[LC_J],
                 out + r * N_LC);
    }
    return;
  }

  if (lane < N_LC) tp[lane] = states[lane];
  __syncwarp();
  for (int i = 0; i < T; ++i) {
    const float dt_i = i == 0 ? pp[DT_START] : pp[DT];
    const int t_idx = t_index(tp[LC_T], pp, T);
    const float4* nodes_next = nodes + mini(i + 1, T - 1) * slice;
    for (int k = lane; k < NF; k += WARP) {
      const float j = axis_point(pp[J_MIN], pp[J_MAX], k, NF - 1);
      const Scored sc = score(tp, j, nodes_next, t_idx, dist_path, path, pp,
                              dt_i, S, V, A, P);
      a_cost[k] = sc.cost;
      a_constr[k] = sc.constr;
      if (k == 0) *a_state_cost = sc.st.cost;
    }
    __syncwarp();
    if (lane == 0) {
      float cmin = a_constr[0];
      for (int k = 1; k < NF; ++k) cmin = fminf(cmin, a_constr[k]);
      float best = INFINITY;
      int kbest = 0;
      for (int k = 0; k < NF; ++k) {
        const float c = a_constr[k] <= cmin ? a_cost[k] : INFINITY;
        if (c < best) {
          best = c;
          kbest = k;
        }
      }
      float row[N_LC];
      finish_row(tp, pp, T, *a_state_cost, best, cmin,
                 axis_point(pp[J_MIN], pp[J_MAX], kbest, NF - 1), row);
      for (int c = 0; c < N_LC; ++c) out[i * N_LC + c] = row[c];
      // the next state
      const float s = row[LC_S], v = row[LC_V], a = row[LC_A], j = row[LC_J];
      const float dt2 = dt_i * dt_i;
      tp[LC_T] = row[LC_T] + dt_i;
      tp[LC_S] = fmaxf(s, s + v * dt_i + 0.5f * a * dt2
                       + j * (dt_i * (dt_i * dt_i)) * (1.0f / 6.0f));
      tp[LC_V] = fmaxf(v + a * dt_i + 0.5f * j * dt2, 0.0f);
      tp[LC_A] = a + j * dt_i;
      tp[LC_J] = j;
      tp[LC_COST] = 0.0f;
      tp[LC_CONSTR] = 0.0f;
    }
    __syncwarp();
  }
}

__host__ __device__ inline size_t forward_smem_bytes() {
  return sizeof(float) * (N_PP + N_LC + 2 * NF + 1);
}

}  // namespace lon_dp

#ifdef __CUDACC__
extern "C" int lon_dp_n_params() { return lon_dp::N_PP; }

// One backward slice: out (S, V, A, 4) from nodes_next (S, V, A, 4); pp the
// packed parameters, path (P, 7), dist_path (T, S) of which row t_idx is
// read; the final slice (is_last) reads no nodes_next.
extern "C" int lon_dp_backward(const float* nodes_next, const float* pp,
                               const float* path, const float* dist_path,
                               float* out, int S, int V, int A, int P,
                               int t_idx, int is_last, void* stream) {
  using namespace lon_dp;
  const int n = S * V * A;
  lon_backward_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes_next), pp, path, dist_path,
      reinterpret_cast<float4*>(out), S, V, A, P, t_idx, is_last != 0);
  return (int)cudaGetLastError();
}

// The forward pass (mode 0: states is the start state (7,), out (T, 7)) or
// the reeval pass (mode 1: states and out (n_rows, 7)) over the nodes
// (T, S, V, A, 4).
extern "C" int lon_dp_forward(const float* nodes, const float* pp,
                              const float* path, const float* dist_path,
                              const float* states, float* out, int T, int S,
                              int V, int A, int P, int n_rows, int mode,
                              void* stream) {
  using namespace lon_dp;
  lon_forward_kernel<<<1, WARP, forward_smem_bytes(),
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), pp, path, dist_path, states,
      out, T, S, V, A, P, n_rows, mode);
  return (int)cudaGetLastError();
}
#endif

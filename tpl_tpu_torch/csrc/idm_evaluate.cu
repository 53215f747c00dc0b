// The collision and interaction screens and the costs of the IDM sampling
// planner's candidates, for Hopper (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/idm_sampling/idm_kernel.py make_idm_kernel's
// `evaluate_lanes` (:928-1112).  The reference is idm_sampling.cpp:531-639.
//
// Two candidates a block of 256 threads, a thread per (candidate, step) (128
// threads a candidate, the steps strided by 128).  A thread screens its step
// against every object, objects in index order:
//
// - collision: the objects' hulls interpolated at the step time (the same
//   for every candidate), the `near` gate (the ego centre against the
//   object's position and speed), and where it passes, the separating-axis
//   test of the ego rectangle against the hull: the ego's own axes as an
//   interval test in the ego frame, the hull's K edge normals against their
//   self-projections (K x K products) and the rectangle's centre +- extent;
// - interaction: the ego position projected onto the object's predicted path
//   (P - 1 segments, the first minimum), the station -> prediction time ->
//   hull interpolation, and where the projection is in bounds and close and
//   the object oncoming, the same rectangle test against that hull.
//
// It writes its step's collision flag, interaction term, path segment,
// deceleration cost term and road-edge count to shared memory; then one
// thread per candidate takes the first collision, the interaction sum
// before it, the distance, comfort and edge costs in step order (the plain
// version's order).  The objects and each predicted path's segment arc
// lengths (a float64 running sum, rounded once per segment) sit in shared
// memory.
//
// What bounds it: operations.  Each (candidate, step) does up to 2 x O hull
// tests of K x K products; at the JAX bench's 16,384 candidates x 100 steps
// x 12 objects x 16 vertices that is ~55 G float32 operations where every
// test runs (the gates skip most); the states it reads are 124.5 MB.
//
// The operations and their order follow the plain version
// (tpl_tpu_torch/planning/idm_sampling/idm_kernel.py evaluate_reference);
// the road-edge margin is float64 as in the JAX package.  Build with
// --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "idm_common.cuh"

namespace idm_evaluate_k {

using namespace idm;

constexpr int THREADS = 256;
constexpr int SLOTS = 128;                  // threads a candidate
constexpr int CANDS = THREADS / SLOTS;      // candidates a block
constexpr int MAX_STEPS = 1024;
constexpr int N_STEP = 5;                   // per-step values kept

// the per-step values
enum { S_COLL, S_INTER, S_SEG, S_ACC, S_EDGE };

// the ego rectangle in its own frame (_rect_geom)
struct Rect {
  float x_lo, x_hi, hw, mid_x, half_x;
};

// the ego rectangle at (cx, cy) heading (ux, uy) against the convex hull
// (px, py)[K] (_rect_sat_hit with _hull_edges)
__device__ __forceinline__ bool rect_hits(const float (&px)[MAX_HULL],
                                          const float (&py)[MAX_HULL], int K,
                                          float cx, float cy, float ux,
                                          float uy, const Rect& r) {
  float hx_max = -INFINITY, hx_min = INFINITY;
  float hy_max = -INFINITY, hy_min = INFINITY;
#pragma unroll
  for (int k = 0; k < MAX_HULL; ++k) {
    if (k < K) {
      const float rx = px[k] - cx, ry = py[k] - cy;
      const float hx = rx * ux + ry * uy;
      const float hy = -rx * uy + ry * ux;
      hx_max = fmaxf(hx_max, hx);
      hx_min = fminf(hx_min, hx);
      hy_max = fmaxf(hy_max, hy);
      hy_min = fminf(hy_min, hy);
    }
  }
  bool gap = hx_max < r.x_lo || hx_min > r.x_hi || hy_max < -r.hw ||
             hy_min > r.hw;
#pragma unroll
  for (int j = 0; j < MAX_HULL; ++j) {
    if (j < K && !gap) {
      const float nxt_x = j + 1 < K ? px[j + 1 < MAX_HULL ? j + 1 : 0] : px[0];
      const float nxt_y = j + 1 < K ? py[j + 1 < MAX_HULL ? j + 1 : 0] : py[0];
      const float ex = nxt_x - px[j], ey = nxt_y - py[j];
      const bool edge_ok = ex * ex + ey * ey > 1e-18f;
      const float n_x = -ey, n_y = ex;
      float hmin = INFINITY, hmax = -INFINITY;
#pragma unroll
      for (int k = 0; k < MAX_HULL; ++k) {
        if (k < K) {
          const float q = n_x * px[k] + n_y * py[k];
          hmin = fminf(hmin, q);
          hmax = fmaxf(hmax, q);
        }
      }
      const float cn = cx * n_x + cy * n_y;
      const float un = ux * n_x + uy * n_y;
      const float vn = -uy * n_x + ux * n_y;
      const float ecen = cn + r.mid_x * un;
      const float eext = r.half_x * fabsf(un) + r.hw * fabsf(vn);
      if (edge_ok && (ecen + eext < hmin || hmax < ecen - eext)) gap = true;
    }
  }
  return !gap;
}

// the hull of object o (hulls (O, P, K, 2)) at the bracket (i, a)
__device__ __forceinline__ void hull_at(const float* hulls, int o, int P,
                                        int K, int i, float a,
                                        float (&px)[MAX_HULL],
                                        float (&py)[MAX_HULL]) {
  const float* h0 = hulls + (size_t)(o * P + i) * K * 2;
  const float* h1 = h0 + K * 2;
#pragma unroll
  for (int k = 0; k < MAX_HULL; ++k) {
    px[k] = 0.0f;
    py[k] = 0.0f;
    if (k < K) {
      px[k] = lerp2(h0[2 * k], h1[2 * k], a);
      py[k] = lerp2(h0[2 * k + 1], h1[2 * k + 1], a);
    }
  }
}

__host__ __device__ inline size_t evaluate_smem_floats(int T, int O, int P,
                                                       int K) {
  return (size_t)O * P * (1 + 2 + 1 + 1 + 2 * K)   // t, xy, v, dists, hulls
      + 2 * O + (size_t)O * (P - 1)                  // radius, valid, arc0
      + (size_t)CANDS * N_STEP * T;                  // the per-step values
}

__global__ void __launch_bounds__(THREADS)
idm_evaluate_kernel(const float* __restrict__ refs,
                    const float* __restrict__ states,
                    const float* __restrict__ l_trgs,
                    const float* __restrict__ g_pred_t,
                    const float* __restrict__ g_pred_xy,
                    const float* __restrict__ g_pred_v,
                    const float* __restrict__ g_pred_dists,
                    const float* __restrict__ g_hulls,
                    const float* __restrict__ g_radius,
                    const float* __restrict__ g_valid,
                    const float* __restrict__ ref_line,
                    const float* __restrict__ ref_step_p,
                    const float* __restrict__ pp_in,
                    const float* __restrict__ l_trg_global_p,
                    float* __restrict__ out, int C, int T, int NR, int O,
                    int P, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* o_t = reinterpret_cast<float*>(smem_raw);   // (O, P)
  float* o_xy = o_t + O * P;                         // (O, P, 2)
  float* o_v = o_xy + O * P * 2;
  float* o_d = o_v + O * P;
  float* o_hull = o_d + O * P;                       // (O, P, K, 2)
  float* o_rad = o_hull + O * P * K * 2;
  float* o_valid = o_rad + O;
  float* o_arc0 = o_valid + O;                       // (O, P - 1)
  float* steps = o_arc0 + O * (P - 1);               // (CANDS, 5, T)

  const int tid = threadIdx.x;
  const int cl = tid / SLOTS, slot = tid % SLOTS;
  const int c_raw = blockIdx.x * CANDS + cl;
  const bool active = c_raw < C;
  const int c = active ? c_raw : C - 1;

  for (int i = tid; i < O * P; i += THREADS) {
    o_t[i] = g_pred_t[i];
    o_v[i] = g_pred_v[i];
    o_d[i] = g_pred_dists[i];
  }
  for (int i = tid; i < O * P * 2; i += THREADS) o_xy[i] = g_pred_xy[i];
  for (int i = tid; i < O * P * K * 2; i += THREADS) o_hull[i] = g_hulls[i];
  for (int o = tid; o < O; o += THREADS) {
    o_rad[o] = g_radius[o];
    o_valid[o] = g_valid[o];
    // the path's segment start arc lengths, a float64 running sum
    double acc = 0.0;
    for (int sg = 0; sg + 1 < P; ++sg) {
      o_arc0[o * (P - 1) + sg] = (float)acc;
      const float* a = g_pred_xy + (size_t)(o * P + sg) * 2;
      const float vx = a[2] - a[0], vy = a[3] - a[1];
      acc += (double)sqrtf(fmaxf(vx * vx + vy * vy, 1e-12f));
    }
  }
  __syncthreads();

  float pp[N_PP];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const float db = pp[DIST_BACK_VEH], df = pp[DIST_FRONT_VEH];
  const Rect rect = {fminf(db, df), fmaxf(db, df), pp[WIDTH_VEH] / 2.0f,
                     (db + df) / 2.0f, fabsf(df - db) / 2.0f};
  const float l_off = pp[LENGTH_VEH] / 2.0f - db;
  const float ref_step = *ref_step_p;
  const double margin = (double)(pp[WIDTH_VEH] / 2.0f) * sqrt(2.0);
  const float* st_c = states + (size_t)c * T * N_V;
  float* my = steps + (size_t)cl * N_STEP * T;

  for (int t = slot; t < T; t += SLOTS) {
    const float* st = st_c + (size_t)t * N_V;
    const float cx = st[V_X], cy = st[V_Y], ch = st[V_H];
    const float ts_t = states[(size_t)t * N_V + V_T];   // candidate 0's grid
    const float ux = cosf(ch), uy = sinf(ch);
    float px[MAX_HULL], py[MAX_HULL];

    // collision screen
    const float ccx = cx + l_off * cosf(ch);
    const float ccy = cy + l_off * sinf(ch);
    bool coll = false;
    for (int o = 0; o < O; ++o) {
      int i;
      float a;
      bracket(o_t + o * P, P, ts_t, i, a);
      const float pox = lerp2(o_xy[(o * P + i) * 2], o_xy[(o * P + i + 1) * 2], a);
      const float poy = lerp2(o_xy[(o * P + i) * 2 + 1],
                              o_xy[(o * P + i + 1) * 2 + 1], a);
      const float vo = lerp2(o_v[o * P + i], o_v[o * P + i + 1], a);
      const float ex = pox - ccx, ey = poy - ccy;
      const float dist_o = sqrtf(ex * ex + ey * ey);
      const bool near = dist_o <= pp[RADIUS_VEH] + o_rad[o] + vo &&
                        o_valid[o] != 0.0f;
      if (near && !coll) {
        hull_at(o_hull, o, P, K, i, a, px, py);
        if (rect_hits(px, py, K, cx, cy, ux, uy, rect)) coll = true;
      }
    }

    // interaction screen
    float inter = 0.0f;
    for (int o = 0; o < O; ++o) {
      float best_d2 = INFINITY;
      int best = 0;
      for (int sg = 0; sg + 1 < P; ++sg) {
        const float* a0 = o_xy + (o * P + sg) * 2;
        const float ax = a0[0], ay = a0[1];
        const float vx = a0[2] - ax, vy = a0[3] - ay;
        const float vv = fmaxf(vx * vx + vy * vy, 1e-12f);
        const float q = ((cx - ax) * vx + (cy - ay) * vy) / vv;
        const float qc = clampf(q, 0.0f, 1.0f);
        const float fx = ax + vx * qc, fy = ay + vy * qc;
        const float gx = cx - fx, gy = cy - fy;
        const float d2 = gx * gx + gy * gy;
        if (d2 < best_d2 || sg == 0) {
          best_d2 = d2;
          best = sg;
        }
      }
      const float* a0 = o_xy + (o * P + best) * 2;
      const float ax = a0[0], ay = a0[1];
      const float vx = a0[2] - ax, vy = a0[3] - ay;
      const float vv = fmaxf(vx * vx + vy * vy, 1e-12f);
      const float q_b = ((cx - ax) * vx + (cy - ay) * vy) / vv;
      const float qc = clampf(q_b, 0.0f, 1.0f);
      const float fx = ax + vx * qc, fy = ay + vy * qc;
      const float gx = cx - fx, gy = cy - fy;
      float dist = sqrtf(gx * gx + gy * gy);
      const bool in_b = !((best == 0 && q_b < 0.0f) ||
                          (best == P - 2 && q_b > 1.0f));
      const float fax = fx - ax, fay = fy - ay;
      const float arc = o_arc0[o * (P - 1) + best] + sqrtf(fax * fax + fay * fay);
      const float ang = atan2f(vy, vx);
      const float ox = fx - cx, oy = fy - cy;
      const float on = sqrtf(ox * ox + oy * oy);
      const float inv = 1.0f / fmaxf(on, 1e-12f);
      if (cosf(ang) * (-oy * inv) + sinf(ang) * (ox * inv) <= 0.0f) dist = -dist;
      if (on < 1e-9f) dist = 0.0f;
      const bool ok = in_b && o_valid[o] != 0.0f &&
                      fabsf(dist) <= pp[RADIUS_VEH] + o_rad[o];
      const bool oncoming = cosf(ch - ang) < 0.0f;
      float term = 0.0f;
      if (ok && oncoming) {
        int i_st;
        float a_st;
        bracket(o_d + o * P, P, arc, i_st, a_st);
        const float tt = lerp2(o_t[o * P + i_st], o_t[o * P + i_st + 1], a_st);
        int i_t;
        float aa;
        bracket(o_t + o * P, P, tt, i_t, aa);
        hull_at(o_hull, o, P, K, i_t, aa, px, py);
        if (rect_hits(px, py, K, cx, cy, ux, uy, rect))
          term = 1.0f / (1.0f + fabsf(dist));
      }
      inter = inter + term;
    }

    // the step's cost terms
    float seg = 0.0f;
    if (t + 1 < T) {
      const float dx = st[N_V + V_X] - cx, dy = st[N_V + V_Y] - cy;
      seg = sqrtf(dx * dx + dy * dy);
    }
    const float am = fminf(st[V_A], 0.0f);
    const float acc = pp[W_A] * (am * am);
    const float q = st[V_S] / ref_step;
    const float i0 = clampf(floorf(q), 0.0f, (float)(NR - 1));
    const float i1 = clampf(ceilf(q), 0.0f, (float)(NR - 1));
    const float a = clampf(q - i0, 0.0f, 1.0f);
    const float dl = ref_line[(size_t)i0 * REF_CH + 5] * (1.0f - a) +
                     ref_line[(size_t)i1 * REF_CH + 5] * a;
    const float dr = ref_line[(size_t)i0 * REF_CH + 6] * (1.0f - a) +
                     ref_line[(size_t)i1 * REF_CH + 6] * a;
    const double l = (double)st[V_L];
    const int edge = (l > (double)dl - margin ? 1 : 0) +
                     (l < (double)(-dr) + margin ? 1 : 0);
    my[S_COLL * T + t] = coll ? 1.0f : 0.0f;
    my[S_INTER * T + t] = inter;
    my[S_SEG * T + t] = seg;
    my[S_ACC * T + t] = acc;
    my[S_EDGE * T + t] = (float)edge;
  }
  __syncthreads();

  if (slot == 0 && active) {
    int first = T;
    for (int t = 0; t < T; ++t)
      if (my[S_COLL * T + t] != 0.0f) {
        first = t;
        break;
      }
    const bool any = first < T;
    const float t_coll = any ? states[(size_t)first * N_V + V_T] : 0.0f;
    const bool invalid = any && t_coll < 3.0f;
    float cost_collision = any ? (float)T * pp[DT] - t_coll : 0.0f;
    float cost_interaction = 0.0f;
    for (int t = 0; t < first; ++t)
      cost_interaction = cost_interaction + my[S_INTER * T + t];
    float seg_sum = 0.0f;
    for (int t = 0; t + 1 < T; ++t) seg_sum = seg_sum + my[S_SEG * T + t];
    float cost_distance = 1000.0f - seg_sum;

    const float dlt = *l_trg_global_p - l_trgs[c];
    float cost = pp[W_L] * (dlt * dlt);
    const float* rf = refs + (size_t)c * T * N_R;
    float min_dl = INFINITY, min_dr = INFINITY;
    for (int t = 0; t + 1 < T; ++t) {
      min_dl = fminf(min_dl, rf[(size_t)t * N_R + R_DL]);
      min_dr = fminf(min_dr, rf[(size_t)t * N_R + R_DR]);
    }
    const float dc = pp[D_COMF_LAT];
    cost = cost + (min_dl < dc ? pp[W_LAT_DIST] * (dc - min_dl) / dc : 0.0f);
    cost = cost + (min_dr < dc ? pp[W_LAT_DIST] * (dc - min_dr) / dc : 0.0f);
    float acc_sum = 0.0f;
    for (int t = 0; t < T; ++t) acc_sum = acc_sum + my[S_ACC * T + t];
    cost = cost + acc_sum;
    float edge = 0.0f;
    for (int t = 0; t < T; ++t) edge = edge + my[S_EDGE * T + t];

    cost_collision = cost_collision + (any ? 0.0f : edge);
    out[c] = any ? 0.0f : cost;
    out[C + c] = any ? 0.0f : cost_distance;
    out[2 * C + c] = cost_interaction;
    out[3 * C + c] = cost_collision;
    out[4 * C + c] = invalid ? 1.0f : 0.0f;
  }
}

}  // namespace idm_evaluate_k

#ifdef __CUDACC__
// lets the kernel take more than 48 KB of dynamic shared memory
static cudaError_t opt_in(size_t smem) {
  static size_t opted = 0;
  if (smem <= 48 * 1024 || smem <= opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      idm_evaluate_k::idm_evaluate_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) opted = smem;
  return e;
}

// blocks of the kernel an SM holds at these sizes (registers, shared
// memory, threads), or -1
extern "C" int idm_evaluate_blocks_per_sm(int T, int O, int P, int K) {
  using namespace idm_evaluate_k;
  const size_t smem = evaluate_smem_floats(T, O, P, K) * sizeof(float);
  int n = 0;
  if (opt_in(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, idm_evaluate_kernel, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}
extern "C" const char* idm_evaluate_param_keys() { return idm::PARAM_KEYS; }
extern "C" int idm_evaluate_max_steps() { return idm_evaluate_k::MAX_STEPS; }

// The screens and costs: out (5, C) [cost, cost_distance, cost_interaction,
// cost_collision, invalid] from the rollout's ref_states (C, T, 10) and
// states (C, T, 9), the lateral targets (C,), the ten object arrays (the
// heading, the hull projections and the on-map flags unused), the ref line
// (NR, 7), its step, the packed parameters and the global lateral target.
extern "C" int idm_evaluate(const float* refs, const float* states,
                            const float* l_trgs, const float* pred_t,
                            const float* pred_xy, const float* pred_heading,
                            const float* pred_v, const float* pred_dists,
                            const float* hull_preds, const float* hull_projs,
                            const float* radius_hull, const float* valid,
                            const float* on_local_map, const float* ref_line,
                            const float* ref_step, const float* pp,
                            const float* l_trg_global, float* out, int C,
                            int T, int NR, int O, int P, int K, void* stream) {
  using namespace idm_evaluate_k;
  (void)pred_heading;
  (void)hull_projs;
  (void)on_local_map;
  if (T > MAX_STEPS || T < 2 || O > MAX_OBJ || P > MAX_PRED || P < 2 ||
      K > MAX_HULL || C < 1 || NR < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = evaluate_smem_floats(T, O, P, K) * sizeof(float);
  const cudaError_t e = opt_in(smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (C + CANDS - 1) / CANDS;
  idm_evaluate_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      refs, states, l_trgs, pred_t, pred_xy, pred_v, pred_dists, hull_preds,
      radius_hull, valid, ref_line, ref_step, pp, l_trg_global, out, C, T,
      NR, O, P, K);
  return (int)cudaGetLastError();
}
#endif

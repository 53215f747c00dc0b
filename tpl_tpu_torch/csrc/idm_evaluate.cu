// The collision and interaction screens and the costs of the IDM sampling
// planner's candidates, for Hopper (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/idm_sampling/idm_kernel.py make_idm_kernel's
// `evaluate_lanes` (:928-1112).  The reference is idm_sampling.cpp:531-639.
//
// Persistent blocks of 256 threads (as many as the SMs hold, or one per
// batch where there are fewer batches), each walking batches of up to 32
// candidates.  A block sets up once: the packed parameters, the objects'
// times, path points and stations, each predicted path's segment arc
// lengths (a float64 running sum, rounded once per segment) and bounding
// box (grown by the rounding margin of idm_common.cuh), and the collision
// gate of every (step, object): the bracket of the step time on the
// object's time row, its position there and the `near` radius (the step
// times are candidate 0's grid, the same for every candidate).  The hulls
// stay in global memory: only a gate that passes reads them.
//
// In a batch, a thread per (candidate, step) screens its step against every
// object, objects in index order:
//
// - collision: the `near` gate (the ego centre against the table's position
//   and radius) and, where it passes, the separating-axis test of the ego
//   rectangle against the hull interpolated at the table's bracket (the
//   ego's own axes as an interval test in the ego frame, the hull's K edge
//   normals against their self-projections, K x K products, and the
//   rectangle's centre +- extent), until the first hit;
// - interaction: an object whose path box lies farther from the ego than
//   its radius gives an exact 0 term (no segment can be within the radius,
//   idm_common.cuh), and the sum plus 0 is the sum; otherwise the ego
//   position projected onto the object's path (P - 1 segments, the first
//   minimum), the station -> prediction time -> hull interpolation, and
//   where the projection is in bounds and close and the object oncoming,
//   the same rectangle test against that hull.
//
// It writes its step's interaction term and its collision and road-edge
// flags to shared memory; then five threads a candidate take its sums, each
// in step order: the first collision and the interaction before it, the
// segment lengths, the deceleration terms, the road-edge counts, the least
// side distances; then a thread a candidate writes its five results.
//
// What bounds it: operations.  Each (candidate, step) does the O gates and
// the projections and hull tests they let through; at the JAX bench's
// 16,384 candidates x 100 steps x 12 objects the gates pass a fraction of
// the 19.7 M (step, object) pairs; the states it reads are 124.5 MB.
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
constexpr int MIN_BLOCKS = 3;               // blocks an SM the registers allow
constexpr int MAX_CANDS = 16;               // candidates a batch
constexpr int MAX_STEPS = 512;
constexpr size_t SMEM_BYTES = 232448;       // shared memory a block may use
constexpr int N_TAB = 5;                    // per (step, object) values
constexpr int N_STEP = 4;                   // per (candidate, step) values

// the (step, object) table: the collision gate's bracket on the object's
// time row at the step time, its position there and the `near` radius
enum { B_I, B_A, B_X, B_Y, B_NEAR };
// the per (candidate, step) values: interaction term, segment length,
// deceleration term, collision flag (4) | road-edge count
enum { S_INTER, S_SEG, S_ACC, S_FLAGS };

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_sync(FULL, v, (threadIdx.x & 31) ^ off));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_sync(FULL, v, (threadIdx.x & 31) ^ off);
    v = o < v ? o : v;
  }
  return v;
}

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

// the hull of object o (hulls (O, P, K, 2), global memory) at the bracket
// (i, a)
__device__ __forceinline__ void hull_at(const float* __restrict__ hulls,
                                        int o, int P, int K, int i, float a,
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
                                                       int cands) {
  return 32                                          // the packed parameters
      + (size_t)O * P * (1 + 2 + 1)                  // t, xy, dists
      + 2 * O + (size_t)O * (P - 1) + 4 * O          // radius, valid, arc0,
                                                     // path boxes
      + (size_t)N_TAB * T * O                        // the (step, object) table
      + (size_t)cands * N_STEP * T;                  // the per-step values
}

// the most candidates a batch whose shared memory fits a block (at least 1:
// T <= MAX_STEPS, O <= MAX_OBJ, P <= MAX_PRED fit one)
__host__ __device__ inline int max_cands(int T, int O, int P) {
  const size_t room = SMEM_BYTES / sizeof(float) -
                      evaluate_smem_floats(T, O, P, 0);
  const size_t n = room / ((size_t)N_STEP * T);
  return n < 1 ? 1 : n > (size_t)MAX_CANDS ? MAX_CANDS : (int)n;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
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
                    int P, int K, int cands) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pp = reinterpret_cast<float*>(smem_raw);    // (N_PP), 32 floats
  float* o_t = pp + 32;                              // (O, P)
  float* o_xy = o_t + O * P;                         // (O, P, 2)
  float* o_d = o_xy + O * P * 2;
  float* o_rad = o_d + O * P;
  float* o_valid = o_rad + O;
  float* o_arc0 = o_valid + O;                       // (O, P - 1)
  float* o_box = o_arc0 + O * (P - 1);               // (O, 4)
  float* tab = o_box + 4 * O;                        // (T, O, 5)
  float* steps = tab + (size_t)N_TAB * T * O;        // (4, cands, T)
  float* s_inter = steps + (size_t)S_INTER * cands * T;
  float* s_seg = steps + (size_t)S_SEG * cands * T;
  float* s_acc = steps + (size_t)S_ACC * cands * T;
  int* s_flags = reinterpret_cast<int*>(steps + (size_t)S_FLAGS * cands * T);

  const int tid = threadIdx.x;
  for (int k = tid; k < N_PP; k += THREADS) pp[k] = pp_in[k];
  for (int i = tid; i < O * P; i += THREADS) {
    o_t[i] = g_pred_t[i];
    o_d[i] = g_pred_dists[i];
  }
  for (int i = tid; i < O * P * 2; i += THREADS) o_xy[i] = g_pred_xy[i];
  for (int o = tid; o < O; o += THREADS) {
    o_rad[o] = g_radius[o];
    o_valid[o] = g_valid[o];
    // the path's segment start arc lengths, a float64 running sum, and the
    // bounding box of its points, grown by the rounding margin
    double acc = 0.0;
    float xlo = INFINITY, xhi = -INFINITY, ylo = INFINITY, yhi = -INFINITY;
    for (int sg = 0; sg < P; ++sg) {
      const float* a = g_pred_xy + (size_t)(o * P + sg) * 2;
      xlo = fminf(xlo, a[0]);
      xhi = fmaxf(xhi, a[0]);
      ylo = fminf(ylo, a[1]);
      yhi = fmaxf(yhi, a[1]);
      if (sg + 1 < P) {
        o_arc0[o * (P - 1) + sg] = (float)acc;
        const float vx = a[2] - a[0], vy = a[3] - a[1];
        acc += (double)sqrtf(fmaxf(vx * vx + vy * vy, 1e-12f));
      }
    }
    box_grow(xlo, xhi, ylo, yhi);
    o_box[4 * o] = xlo;
    o_box[4 * o + 1] = xhi;
    o_box[4 * o + 2] = ylo;
    o_box[4 * o + 3] = yhi;
  }
  __syncthreads();
  // the collision gate at each step time (candidate 0's grid), per object
  for (int e = tid; e < T * O; e += THREADS) {
    const int t = e / O, o = e - t * O;
    const float ts_t = states[(size_t)t * N_V + V_T];
    int i;
    float a;
    bracket(o_t + o * P, P, ts_t, i, a);
    float* b = tab + (size_t)e * N_TAB;
    b[B_I] = (float)i;
    b[B_A] = a;
    b[B_X] = lerp2(o_xy[(o * P + i) * 2], o_xy[(o * P + i + 1) * 2], a);
    b[B_Y] = lerp2(o_xy[(o * P + i) * 2 + 1], o_xy[(o * P + i + 1) * 2 + 1],
                   a);
    const float vo = lerp2(g_pred_v[o * P + i], g_pred_v[o * P + i + 1], a);
    b[B_NEAR] = pp[RADIUS_VEH] + o_rad[o] + vo;
  }
  __syncthreads();

  const float db = pp[DIST_BACK_VEH], df = pp[DIST_FRONT_VEH];
  const Rect rect = {fminf(db, df), fmaxf(db, df), pp[WIDTH_VEH] / 2.0f,
                     (db + df) / 2.0f, fabsf(df - db) / 2.0f};
  const float l_off = pp[LENGTH_VEH] / 2.0f - db;
  const float ref_step = *ref_step_p;
  const double margin = (double)(pp[WIDTH_VEH] / 2.0f) * sqrt(2.0);
  const float skip_d2 = 1e-17f;   // (1e-9)^2 and more: `on` >= 1e-9 beyond
  const int n_batch = (C + cands - 1) / cands;

  for (int bt = blockIdx.x; bt < n_batch; bt += gridDim.x) {
    const int c0 = bt * cands;
    const int nc = C - c0 < cands ? C - c0 : cands;

    // a thread per (candidate, step): the screens and the step's flags
    for (int it = tid; it < nc * T; it += THREADS) {
      const int cl = it / T, t = it - cl * T;
      const float* st = states + ((size_t)(c0 + cl) * T + t) * N_V;
      const float cx = st[V_X], cy = st[V_Y], ch = st[V_H];
      const float ux = cosf(ch), uy = sinf(ch);
      float px[MAX_HULL], py[MAX_HULL];

      // collision screen
      const float ccx = cx + l_off * cosf(ch);
      const float ccy = cy + l_off * sinf(ch);
      bool coll = false;
      const float* bt_row = tab + (size_t)t * O * N_TAB;
      for (int o = 0; o < O && !coll; ++o) {
        const float* b = bt_row + o * N_TAB;
        const float ex = b[B_X] - ccx, ey = b[B_Y] - ccy;
        const float dist_o = sqrtf(ex * ex + ey * ey);
        if (dist_o <= b[B_NEAR] && o_valid[o] != 0.0f) {
          hull_at(g_hulls, o, P, K, (int)b[B_I], b[B_A], px, py);
          if (rect_hits(px, py, K, cx, cy, ux, uy, rect)) coll = true;
        }
      }

      // interaction screen: objects whose path box is farther than their
      // radius add an exact 0 and are skipped
      float inter = 0.0f;
      for (int o = 0; o < O; ++o) {
        const float rad = pp[RADIUS_VEH] + o_rad[o];
        const float r2 = rad * rad * (1.0f + BOX_REL);
        if (box_key(o_box + 4 * o, cx, cy) > fmaxf(r2, skip_d2)) continue;
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
        const float arc = o_arc0[o * (P - 1) + best] +
                          sqrtf(fax * fax + fay * fay);
        const float ang = atan2f(vy, vx);
        const float ox = fx - cx, oy = fy - cy;
        const float on = sqrtf(ox * ox + oy * oy);
        const float inv = 1.0f / fmaxf(on, 1e-12f);
        if (cosf(ang) * (-oy * inv) + sinf(ang) * (ox * inv) <= 0.0f)
          dist = -dist;
        if (on < 1e-9f) dist = 0.0f;
        const bool ok = in_b && o_valid[o] != 0.0f && fabsf(dist) <= rad;
        const bool oncoming = cosf(ch - ang) < 0.0f;
        float term = 0.0f;
        if (ok && oncoming) {
          int i_st;
          float a_st;
          bracket(o_d + o * P, P, arc, i_st, a_st);
          const float tt = lerp2(o_t[o * P + i_st], o_t[o * P + i_st + 1],
                                 a_st);
          int i_t;
          float aa;
          bracket(o_t + o * P, P, tt, i_t, aa);
          hull_at(g_hulls, o, P, K, i_t, aa, px, py);
          if (rect_hits(px, py, K, cx, cy, ux, uy, rect))
            term = 1.0f / (1.0f + fabsf(dist));
        }
        inter = inter + term;
      }

      // the road-edge count
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
      float seg = 0.0f;
      if (t + 1 < T) {
        const float dx = st[N_V + V_X] - cx, dy = st[N_V + V_Y] - cy;
        seg = sqrtf(dx * dx + dy * dy);
      }
      const float am = fminf(st[V_A], 0.0f);
      s_inter[it] = inter;
      s_seg[it] = seg;
      s_acc[it] = pp[W_A] * (am * am);
      s_flags[it] = (coll ? 4 : 0) | edge;
    }
    __syncthreads();

    // a warp a candidate: the first collision and the least side
    // distances (minima, in any order), then four sums in step order, one
    // a lane in lock step: the interaction before the first collision, the
    // segment lengths, the deceleration terms, the road-edge counts
    const int warp = tid >> 5, lane = tid & 31;
    for (int cl = warp; cl < nc; cl += THREADS / 32) {
      const int c = c0 + cl;
      const int* fl = s_flags + cl * T;
      int first = T;
      for (int t = lane; t < T; t += 32)
        if (fl[t] & 4) {
          first = t;
          break;
        }
      first = warp_min_int(first);
      const float* rf = refs + (size_t)c * T * N_R;
      float min_dl = INFINITY, min_dr = INFINITY;
      for (int t = lane; t + 1 < T; t += 32) {
        min_dl = fminf(min_dl, rf[(size_t)t * N_R + R_DL]);
        min_dr = fminf(min_dr, rf[(size_t)t * N_R + R_DR]);
      }
      min_dl = warp_min(min_dl);
      min_dr = warp_min(min_dr);
      float sum = 0.0f;
      if (lane < 4) {
        const float* col = steps + ((size_t)lane * cands + cl) * T;
        const int n_t = lane == 0 ? first : lane == 1 ? T - 1 : T;
        for (int t = 0; t < n_t; ++t)
          sum = sum + (lane == 3 ? (float)(fl[t] & 3) : col[t]);
      }
      const float inter = __shfl_sync(FULL, sum, 0);
      const float seg_sum = __shfl_sync(FULL, sum, 1);
      const float acc_sum = __shfl_sync(FULL, sum, 2);
      const float edge = __shfl_sync(FULL, sum, 3);
      if (lane == 0) {
        const bool any = first < T;
        const float t_coll = any ? states[(size_t)first * N_V + V_T] : 0.0f;
        const bool invalid = any && t_coll < 3.0f;
        float cost_collision = any ? (float)T * pp[DT] - t_coll : 0.0f;
        const float cost_distance = 1000.0f - seg_sum;
        const float dlt = *l_trg_global_p - l_trgs[c];
        float cost = pp[W_L] * (dlt * dlt);
        const float dc = pp[D_COMF_LAT];
        cost = cost + (min_dl < dc ? pp[W_LAT_DIST] * (dc - min_dl) / dc
                                   : 0.0f);
        cost = cost + (min_dr < dc ? pp[W_LAT_DIST] * (dc - min_dr) / dc
                                   : 0.0f);
        cost = cost + acc_sum;
        cost_collision = cost_collision + (any ? 0.0f : edge);
        out[c] = any ? 0.0f : cost;
        out[C + c] = any ? 0.0f : cost_distance;
        out[2 * C + c] = inter;
        out[3 * C + c] = cost_collision;
        out[4 * C + c] = invalid ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
  }
}

}  // namespace idm_evaluate_k

// The batch size and the grid for C candidates on `slots` resident blocks
// with batches of at most `cap`: the fewest rounds of full batches, then
// batches as even as they come, one block a batch up to the slots.
extern "C" void idm_evaluate_grid(int C, int slots, int cap, int* cands,
                                  int* grid) {
  const long long per_round = (long long)slots * cap;
  const int rounds = (int)((C + per_round - 1) / per_round);
  const long long spread = (long long)slots * rounds;
  int cb = (int)((C + spread - 1) / spread);
  cb = cb < 1 ? 1 : cb > cap ? cap : cb;
  const int batches = (C + cb - 1) / cb;
  *cands = cb;
  *grid = batches < slots ? batches : slots;
}

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

// blocks of the kernel an SM holds with batches of `cands` candidates
// (registers, shared memory, threads), or -1
static int blocks_per_sm(int T, int O, int P, int cands) {
  using namespace idm_evaluate_k;
  const size_t smem = evaluate_smem_floats(T, O, P, cands) * sizeof(float);
  int n = 0;
  if (opt_in(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, idm_evaluate_kernel,
                                                    THREADS, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// blocks an SM holds at these sizes with full batches, or -1
extern "C" int idm_evaluate_blocks_per_sm(int T, int O, int P, int K) {
  (void)K;
  return blocks_per_sm(T, O, P, idm_evaluate_k::max_cands(T, O, P));
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
  // the resident blocks with full batches on this device at these sizes,
  // asked again only when the device or the sizes change
  static int cached[5] = {-1, 0, 0, 0, 0};   // device, T, O, P, slots
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (cached[0] != dev || cached[1] != T || cached[2] != O ||
      cached[3] != P) {
    int n_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int per_sm = blocks_per_sm(T, O, P, max_cands(T, O, P));
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[0] = dev;
    cached[1] = T;
    cached[2] = O;
    cached[3] = P;
    cached[4] = n_sm * per_sm;
  }
  int cands = 0, grid = 0;
  idm_evaluate_grid(C, cached[4], max_cands(T, O, P), &cands, &grid);
  const size_t smem = evaluate_smem_floats(T, O, P, cands) * sizeof(float);
  e = opt_in(smem);
  if (e != cudaSuccess) return (int)e;
  idm_evaluate_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      refs, states, l_trgs, pred_t, pred_xy, pred_v, pred_dists, hull_preds,
      radius_hull, valid, ref_line, ref_step, pp, l_trg_global, out, C, T,
      NR, O, P, K, cands);
  return (int)cudaGetLastError();
}
#endif

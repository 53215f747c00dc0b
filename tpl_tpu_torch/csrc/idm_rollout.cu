// The closed-loop rollout of the IDM sampling planner's candidates, for
// Hopper (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/idm_sampling/idm_kernel.py make_idm_kernel's
// `rollout_lanes` (:444-743).  The reference is idm_sampling.cpp:354-530.
//
// One warp per candidate, 8 candidates a block.  A candidate's steps are a
// serial chain (each step's state feeds the next), so the warp walks the
// T - 1 steps one after the other and splits the work inside a step over
// its 32 lanes: the leader search over the O x K predicted hull points, the
// lane search over the O objects, the 25 speed-limit lookups, the stop
// point and the projection of the new position onto the ref line.  Every
// cross-lane reduction is a (value, index) minimum (the smallest index among
// equal values, as jnp.argmin), a minimum or an OR, which no order changes.
// Every lane then holds the same step state and does the scalar part (the
// IDM law, the Stanley controller, the kinematic update) redundantly.
//
// A step is a long chain of dependent full-precision operations, and one
// warp issues it in order.  Where the candidates are few (C <= SPLIT_MAX_C,
// the launcher's choice from C; the loop's C = 8 is one block on one SM),
// each takes two warps (SPLIT, 4 candidates a block): one the reference's
// half of a step (the leader and lane searches, the IDM law, the ref line
// ahead), one the vehicle's (the speed limit and the stop point, the
// controller, the kinematics, the projection).  They exchange the speed
// limit and stop distance, the new acceleration and the reference's state
// through shared memory, with two more block barriers a step; each value is
// computed by the same operations as with one warp, so the bits are equal.
//
// Shared tables, built once per block: the packed parameters, the ref line
// (channel-major), the ref line's segment arc lengths (a float64 running
// sum, rounded once per segment), the objects (their hulls stay in global
// memory, read once a step per block), and per 32-cell chunk of the ref line
// the least d_left and d_right, whether it holds a zero-speed cell, and per
// 32-segment chunk the segments' bounding box, grown by the rounding margin
// of idm_common.cuh.  Before each step the block's 256 threads interpolate
// the objects' hulls, headings, speeds and hull projections at the step
// time (the same for every candidate: the float32 running sum t0 + dt + dt
// + ...) into one of two buffers, so one barrier a step suffices.
//
// The two searches that would scan the whole ref line every step are exact
// pruned searches:
// - the stop point: its zero-speed leg is the first zero-speed cell at or
//   after i0 and its off-road leg the first off-road cell at or after s
//   (n * ref_step, and ss - s - d_safe_min with it, never decrease in n for
//   ref_step > 0, so the first is the least); the warp finds the first chunk
//   that can hold one with one ballot over 32 chunks, then the cell with one
//   ballot over the chunk.  A ref step that is not positive takes the full
//   scan of every cell.
// - the projection: the chunk of the previous step's segment first, then
//   every chunk whose box key is not above the best d2 so far, in index
//   order; a chunk is skipped only where every segment in it gives a
//   strictly larger float d2 than the minimum (idm_common.cuh), and the
//   (d2, index) minimum of the evaluated segments is the full scan's.
//
// What bounds it: the serial steps.  Per candidate and step the lanes do a
// few thousand float32 operations (the leader search over the hull points,
// ~12 full-precision transcendentals, two projections of one or two chunks
// on the bench's straight ref line), 0.9-1.8 G at the JAX bench's 16,384
// candidates x 99 steps; bytes are small (the states written, 124.5 MB
// there).  Registers are held to three blocks an SM (__launch_bounds__).
//
// The operations and their order follow the plain version
// (tpl_tpu_torch/planning/idm_sampling/idm_kernel.py rollout_reference),
// including the three multiply-adds it rounds once (fma32: the ref speed and
// acceleration updates and the controller's speed, where XLA's contraction
// decides when a stopped candidate starts again), the two-hot ref lookups
// (a row weighs (1 - a) + a where floor and ceil coincide) and the division
// by 25 as a product with its float32 reciprocal.  Build with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "idm_common.cuh"

namespace idm_rollout_k {

using namespace idm;

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
// at most this many candidates take two warps each (split): one for the
// reference's update, one for the vehicle's
constexpr int SPLIT_MAX_C = 512;
// a warp's role: the reference (leader, IDM law, ref line), the vehicle
// (speed limit, stop point, controller, kinematics, projection), or both
enum { REF, CON, BOTH };
// what the two warps of a split candidate exchange in shared memory: the
// reference's state, the speed limit and stop distance, the acceleration
enum { X_REF = 0, X_VTRG = N_R, X_DSTOP, X_ANEW, N_X = 16 };
constexpr int MIN_BLOCKS = 3;             // blocks an SM the registers allow
constexpr int MAX_PTS = MAX_OBJ * MAX_HULL;
constexpr int PTS_PER_LANE = MAX_PTS / WARP;
constexpr int MAX_REF = 4096;
constexpr int CHUNK = 32;                 // cells / segments a chunk

struct Objs {
  const float* pred_t;        // (O, P)
  const float* pred_xy;       // (O, P, 2)
  const float* pred_heading;  // (O, P)
  const float* pred_v;        // (O, P)
  const float* pred_dists;    // (O, P)
  const float* hull_preds;    // (O, P, K, 2)
  const float* hull_projs;    // (O, P, 4)
  const float* radius_hull;   // (O,)
  const float* valid;         // (O,) 0 / 1
  const float* on_local_map;  // (O,) 0 / 1
};

__host__ __device__ inline float fma32(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// jnp.mod(x, float32(2 pi)): fmod, plus the divisor where it is negative
__device__ __forceinline__ float mod_2pi(float x) {
  const float m = 6.2831855f;
  const float r = fmodf(x, m);
  return r < 0.0f ? r + m : r;
}

__device__ __forceinline__ float short_angle(float a0, float a1) {
  const float da = mod_2pi(a1 - a0);
  return mod_2pi(2.0f * da) - da;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_sync(FULL, v, (threadIdx.x & 31) ^ off));
  return v;
}

__device__ __forceinline__ unsigned warp_or(unsigned v) {
  for (int off = 16; off > 0; off >>= 1)
    v |= __shfl_sync(FULL, v, (threadIdx.x & 31) ^ off);
  return v;
}

// the (value, index) minimum, the smallest index among equal values
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int src = (threadIdx.x & 31) ^ off;
    const float ov = __shfl_sync(FULL, v, src);
    const int oi = __shfl_sync(FULL, i, src);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void take_min(float& bv, int& bi, float v, int i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// the two-hot lerp of ref channel ch (channel-major table of NR rows)
__device__ __forceinline__ float ref_2hot(const float* rl, int NR, int ch,
                                          float ref_step, float s) {
  const float q = s / ref_step;
  const float i0 = clampf(floorf(q), 0.0f, (float)(NR - 1));
  const float i1 = clampf(ceilf(q), 0.0f, (float)(NR - 1));
  const float a = clampf(q - i0, 0.0f, 1.0f);
  const float t0 = rl[ch * NR + (int)i0];
  if (i0 == i1) return t0 * ((1.0f - a) + a);
  return t0 * (1.0f - a) + rl[ch * NR + (int)i1] * a;
}

// the squared distance of (px, py) to ref segment n (x, y rows of rl)
__device__ __forceinline__ float seg_d2(const float* rl, int NR, int n,
                                        float px, float py) {
  const float ax = rl[n], ay = rl[NR + n];
  const float vx = rl[n + 1] - ax, vy = rl[NR + n + 1] - ay;
  const float vv = fmaxf(vx * vx + vy * vy, 1e-12f);
  const float q = ((px - ax) * vx + (py - ay) * vy) / vv;
  const float qc = clampf(q, 0.0f, 1.0f);
  const float fx = ax + vx * qc, fy = ay + vy * qc;
  const float ex = px - fx, ey = py - fy;
  return ex * ex + ey * ey;
}

// the per-step object table
struct StepTab {
  float* hx;     // (O * K)
  float* hy;
  float* head;   // (O)
  float* v;
  float* hp;     // (O * 4)
};

__host__ __device__ inline int seg_chunks(int NR) {
  return (NR - 1 + CHUNK - 1) / CHUNK;
}
__host__ __device__ inline int cell_chunks(int NR) {
  return (NR + CHUNK - 1) / CHUNK;
}

__host__ __device__ inline size_t rollout_smem_floats(int NR, int O, int P,
                                                      int K) {
  return 32                                      // the packed parameters
      + (size_t)REF_CH * NR + (NR - 1)           // ref line, arc lengths
      + 4 * (size_t)seg_chunks(NR)               // segment chunk boxes
      + 3 * (size_t)cell_chunks(NR)              // min d_l, min d_r, zero
      + (size_t)O * P * (1 + 1 + 1 + 4)          // t, heading, v, hp
      + 2 * O                                    // valid, valid & on map
      + 2 * ((size_t)2 * O * K + 2 * O + 4 * O)  // two step tables
      + (size_t)WARPS * N_X;                     // the split exchange
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
idm_rollout_kernel(const float* __restrict__ init_ref,
                   const float* __restrict__ init_con,
                   const float* __restrict__ l_trgs,
                   const float* __restrict__ d_stops,
                   const float* __restrict__ dt_replan_p,
                   const float* __restrict__ ref_line,
                   const float* __restrict__ ref_step_p, Objs ob,
                   const float* __restrict__ pp_in,
                   float* __restrict__ out_ref, float* __restrict__ out_con,
                   int C, int T, int NR, int O, int P, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pp = reinterpret_cast<float*>(smem_raw);   // (N_PP), 32 floats
  float* rl = pp + 32;                              // (7, NR)
  float* arc0 = rl + REF_CH * NR;                   // (NR - 1)
  const int n_sch = seg_chunks(NR), n_cch = cell_chunks(NR);
  float* sbox = arc0 + (NR - 1);                    // (n_sch, 4)
  float* c_dl = sbox + 4 * n_sch;                   // (n_cch)
  float* c_dr = c_dl + n_cch;
  float* c_zero = c_dr + n_cch;
  float* o_t = c_zero + n_cch;                      // (O, P)
  float* o_head = o_t + O * P;
  float* o_v = o_head + O * P;
  float* o_hp = o_v + O * P;                        // (O, P, 4)
  float* o_valid = o_hp + O * P * 4;                // (O)
  float* o_valid_map = o_valid + O;                 // (O)
  float* tab_base = o_valid_map + O;
  const int tab_floats = 2 * O * K + 2 * O + 4 * O;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid / WARP;
  const int slot = SPLIT ? warp >> 1 : warp;     // the block's candidate
  const int role = SPLIT ? warp & 1 : BOTH;
  float* xch = tab_base + 2 * tab_floats + slot * N_X;
  const int c_raw = blockIdx.x * (SPLIT ? WARPS / 2 : WARPS) + slot;
  const bool active = c_raw < C;
  const int c = active ? c_raw : C - 1;

  for (int k = tid; k < N_PP; k += THREADS) pp[k] = pp_in[k];
  for (int n = tid; n < NR; n += THREADS)
    for (int ch = 0; ch < REF_CH; ++ch)
      rl[ch * NR + n] = ref_line[(size_t)n * REF_CH + ch];
  for (int i = tid; i < O * P; i += THREADS) {
    o_t[i] = ob.pred_t[i];
    o_head[i] = ob.pred_heading[i];
    o_v[i] = ob.pred_v[i];
  }
  for (int i = tid; i < O * P * 4; i += THREADS) o_hp[i] = ob.hull_projs[i];
  for (int o = tid; o < O; o += THREADS) {
    o_valid[o] = ob.valid[o];
    o_valid_map[o] = (ob.valid[o] != 0.0f && ob.on_local_map[o] != 0.0f)
        ? 1.0f : 0.0f;
  }
  // the segments' lengths, then (one thread) their start arc lengths: a
  // float64 running sum, each partial sum rounded to float32
  for (int n = tid; n + 1 < NR; n += THREADS) {
    const float vx = ref_line[(size_t)(n + 1) * REF_CH] -
                     ref_line[(size_t)n * REF_CH];
    const float vy = ref_line[(size_t)(n + 1) * REF_CH + 1] -
                     ref_line[(size_t)n * REF_CH + 1];
    arc0[n] = sqrtf(fmaxf(vx * vx + vy * vy, 1e-12f));
  }
  __syncthreads();
  if (tid == 0) {
    double acc = 0.0;
    for (int n = 0; n + 1 < NR; ++n) {
      const float len = arc0[n];
      arc0[n] = (float)acc;
      acc += (double)len;
    }
  }
  // the chunk tables, a warp a chunk
  for (int j = warp; j < n_sch; j += WARPS) {
    const int n = j * CHUNK + lane;          // vertices n and n + 1
    const bool in = n + 1 < NR;
    float xlo = in ? fminf(rl[n], rl[n + 1]) : INFINITY;
    float xhi = in ? fmaxf(rl[n], rl[n + 1]) : -INFINITY;
    float ylo = in ? fminf(rl[NR + n], rl[NR + n + 1]) : INFINITY;
    float yhi = in ? fmaxf(rl[NR + n], rl[NR + n + 1]) : -INFINITY;
    xlo = warp_min(xlo);
    ylo = warp_min(ylo);
    xhi = -warp_min(-xhi);
    yhi = -warp_min(-yhi);
    if (lane == 0) {
      box_grow(xlo, xhi, ylo, yhi);
      sbox[4 * j] = xlo;
      sbox[4 * j + 1] = xhi;
      sbox[4 * j + 2] = ylo;
      sbox[4 * j + 3] = yhi;
    }
  }
  for (int j = warp; j < n_cch; j += WARPS) {
    const int n = j * CHUNK + lane;
    const bool in = n < NR;
    const float dl = warp_min(in ? rl[5 * NR + n] : INFINITY);
    const float dr = warp_min(in ? rl[6 * NR + n] : INFINITY);
    const unsigned z = __ballot_sync(FULL, in && rl[4 * NR + n] == 0.0f);
    if (lane == 0) {
      c_dl[j] = dl;
      c_dr[j] = dr;
      c_zero[j] = z ? 1.0f : 0.0f;
    }
  }

  const float ref_step = *ref_step_p;
  const float dt_replan = *dt_replan_p;
  const bool step_up = ref_step > 0.0f;   // n * ref_step never decreases
  const float l_trg = l_trgs[c];
  const float d_stop0 = d_stops[c];
  const float inf = INFINITY;
  const float* rl_v = rl + 4 * NR;
  const float* rl_dl = rl + 5 * NR;
  const float* rl_dr = rl + 6 * NR;

  float ref[N_R], con[N_V];
  for (int i = 0; i < N_R; ++i) ref[i] = init_ref[i];
  for (int i = 0; i < N_V; ++i) con[i] = init_con[i];
  float t_step = init_ref[R_T];     // the shared step time, as the carry sums
  int prev_seg = 0;                 // the last projection's segment
  if (SPLIT && role == REF && lane < N_R) xch[X_REF + lane] = init_ref[lane];
  __syncthreads();
  const float sq2 = 2.0f * sqrtf(pp[A_MAX] * pp[A_BREAK_COMF]);

  float* o_ref = out_ref + (size_t)c * T * N_R;
  float* o_con = out_con + (size_t)c * T * N_V;

  for (int k = 0; k + 1 < T; ++k) {
    // the objects at the step time, shared by the block's candidates
    float* tb0 = tab_base + (k & 1) * tab_floats;
    const StepTab tb = {tb0, tb0 + O * K, tb0 + 2 * O * K,
                        tb0 + 2 * O * K + O, tb0 + 2 * O * K + 2 * O};
    for (int p = tid; p < O * K; p += THREADS) {
      const int o = p / K, kk = p % K;
      int i;
      float a;
      bracket(o_t + o * P, P, t_step, i, a);
      const float* h0 = ob.hull_preds + ((size_t)(o * P + i) * K + kk) * 2;
      const float* h1 = h0 + K * 2;
      tb.hx[p] = lerp2(h0[0], h1[0], a);
      tb.hy[p] = lerp2(h0[1], h1[1], a);
    }
    for (int o = tid; o < O; o += THREADS) {
      int i;
      float a;
      bracket(o_t + o * P, P, t_step, i, a);
      tb.head[o] = lerp2(o_head[o * P + i], o_head[o * P + i + 1], a);
      tb.v[o] = lerp2(o_v[o * P + i], o_v[o * P + i + 1], a);
      for (int j = 0; j < 4; ++j)
        tb.hp[o * 4 + j] = lerp2(o_hp[(o * P + i) * 4 + j],
                                 o_hp[(o * P + i + 1) * 4 + j], a);
    }
    t_step = t_step + pp[DT];
    __syncthreads();
    if (SPLIT && role == CON) {
      // the reference's state of this step, from its warp
#pragma unroll
      for (int i = 0; i < N_R; ++i) ref[i] = xch[X_REF + i];
    }

    const float x = ref[R_X], y = ref[R_Y], h = ref[R_H], s = ref[R_S];
    const float l = ref[R_L], v = ref[R_V], a = ref[R_A];
    const float db = pp[DIST_BACK_VEH], df = pp[DIST_FRONT_VEH];
    const float half_w = pp[WIDTH_VEH] / 2.0f;

    // --- the speed limit ahead and the next stop point ---
    float v_trg = inf, d_stop = inf;
    if (role != REF) {
      const float v_trg_dist = v * pp[T_VEL_LOOKAHEAD];
      if (lane < 25) {
        const float sk = s + (float)lane * (v_trg_dist * (1.0f / 25.0f));
        v_trg = ref_2hot(rl, NR, 4, ref_step, sk);
      }
      v_trg = fmaxf(0.001f, warp_min(v_trg));

      // the first zero-v cell at or after ceil(s / step) and the first
      // off-road cell at or after s
      const int i0 = (int)clampf(ceilf(s / ref_step), 0.0f, (float)(NR - 1));
      float zmin = inf, dmin = inf;
      if (step_up) {
        // the zero-speed leg: chunks from i0's on that hold a zero cell
        const int cz = i0 / CHUNK;
        bool found = false;
        for (int g = cz - cz % WARP; g < n_cch && !found; g += WARP) {
          const int j = g + lane;
          unsigned m = __ballot_sync(FULL, j >= cz && j < n_cch &&
                                               c_zero[j] != 0.0f);
          while (m) {
            const int n = (g + __ffs(m) - 1) * CHUNK + lane;
            m &= m - 1;
            const unsigned hit = __ballot_sync(
                FULL, n < NR && n >= i0 && rl_v[n] == 0.0f);
            if (hit) {
              zmin = (float)((n & ~(CHUNK - 1)) + __ffs(hit) - 1) * ref_step;
              found = true;
              break;
            }
          }
        }
        // the off-road leg: chunks whose last cell is at or after s and
        // whose least d_right / d_left let this l off the road
        found = false;
        for (int g = 0; g < n_cch && !found; g += WARP) {
          const int j = g + lane;
          bool can = false;
          if (j < n_cch) {
            const int last = j * CHUNK + CHUNK - 1 < NR ? j * CHUNK + CHUNK - 1
                                                        : NR - 1;
            can = (float)last * ref_step >= s &&
                  (l < -c_dr[j] || l > c_dl[j]);
          }
          unsigned m = __ballot_sync(FULL, can);
          while (m) {
            const int n = (g + __ffs(m) - 1) * CHUNK + lane;
            m &= m - 1;
            const bool off = n < NR && (float)n * ref_step >= s &&
                             (l < -rl_dr[n] || l > rl_dl[n]);
            const unsigned hit = __ballot_sync(FULL, off);
            if (hit) {
              const float ss =
                  (float)((n & ~(CHUNK - 1)) + __ffs(hit) - 1) * ref_step;
              dmin = ss - s - pp[D_SAFE_MIN];
              found = true;
              break;
            }
          }
        }
      } else {
        for (int n = lane; n < NR; n += WARP) {
          const float ss = (float)n * ref_step;
          if (n >= i0 && rl_v[n] == 0.0f) zmin = fminf(zmin, ss);
          if (ss >= s && (l < -rl_dr[n] || l > rl_dl[n]))
            dmin = fminf(dmin, ss - s - pp[D_SAFE_MIN]);
        }
        zmin = warp_min(zmin);
        dmin = warp_min(dmin);
      }
      const float d_zero = zmin == inf ? inf : zmin - s;
      d_stop = fminf(d_zero, dmin);
      d_stop = fminf(d_stop0 - s, d_stop);
      if (SPLIT && lane == 0) {
        xch[X_VTRG] = v_trg;
        xch[X_DSTOP] = d_stop;
      }
    }

    // --- the leader (get_leader_lanes): hull points of every object, in
    // two passes (the sides each object spans, then the leader), each
    // point's frame coordinates computed in both ---
    float d_lead = inf, v_lead = 0.0f, d_right = 100.0f, d_left = 100.0f;
    if (role != CON) {
      const float dx = cosf(h), dy = sinf(h);
      const float p0x = x - dx * db;
      const float p0y = y - dy * db;
      const float ray_len = 200.0f + db;
      unsigned left = 0, right = 0;
#pragma unroll
      for (int r = 0; r < PTS_PER_LANE; ++r) {
        const int p = lane + r * WARP;
        if (p < O * K) {
          const float rx = tb.hx[p] - p0x;
          const float ry = tb.hy[p] - p0y;
          const float la = dx * ry - dy * rx;
          const int o = p / K;
          if (o_valid_map[o] != 0.0f) {
            if (la > 0.0f) left |= 1u << o;
            if (la < 0.0f) right |= 1u << o;
          }
        }
      }
      const unsigned spans = warp_or(left) & warp_or(right);
      int idx = 1 << 30;
      unsigned span_front = 0;
      const float close = half_w + pp[D_SAFE_LAT];
#pragma unroll
      for (int r = 0; r < PTS_PER_LANE; ++r) {
        const int p = lane + r * WARP;
        if (p < O * K) {
          const int o = p / K;
          const float rx = tb.hx[p] - p0x;
          const float ry = tb.hy[p] - p0y;
          const float ar = rx * dx + ry * dy;
          const float la = dx * ry - dy * rx;
          const bool vm = o_valid_map[o] != 0.0f;
          const bool sp = (spans >> o) & 1u;
          const bool in_b = ar > 0.0f && ar < ray_len;
          const bool lead = in_b && vm && (sp || fabsf(la) < close);
          take_min(d_lead, idx, lead ? ar - db : inf, p);
          const bool front = in_b && vm && ar < df;
          if (front && la < 0.0f && !sp) d_right = fminf(d_right, fabsf(la));
          if (front && la > 0.0f && !sp) d_left = fminf(d_left, fabsf(la));
          if (front && sp) span_front = 1;
        }
      }
      warp_argmin(d_lead, idx);
      d_right = warp_min(d_right);
      d_left = warp_min(d_left);
      if (warp_or(span_front)) {
        d_right = 0.0f;
        d_left = 0.0f;
      }
      if (isfinite(d_lead)) {
        const int io = idx / K;
        v_lead = tb.v[io] * cosf(tb.head[io] - h);
      }

      // the lane search over the objects' hull projections
      float lane_d = inf;
      int li = 1 << 30;
      if (lane < O) {
        const float* hp = tb.hp + lane * 4;
        const bool on_lane = l_trg > hp[2] - half_w - pp[D_SAFE_LAT] &&
                             l_trg < hp[3] + half_w + pp[D_SAFE_LAT] &&
                             s < hp[1] && o_valid[lane] != 0.0f;
        lane_d = on_lane ? hp[0] - s : inf;
        li = lane;
      }
      warp_argmin(lane_d, li);
      if (lane_d < d_lead) {
        v_lead = tb.v[li];
        d_lead = lane_d;
      }
      if (!isfinite(d_lead)) d_lead = 1e6f;
      if (v_lead < 0.0f) {
        d_lead = d_lead - 10.0f;
        v_lead = v_lead * 2.0f;
      }
    }
    if (SPLIT) {
      __syncthreads();
      if (role == REF) {
        v_trg = xch[X_VTRG];
        d_stop = xch[X_DSTOP];
      }
    }

    // --- reference update: the IDM law and the ref line ahead ---
    const float dt_control = k == 0 ? dt_replan : pp[DT];
    float a_new = 0.0f, nl = 0.0f, ns = 0.0f, nh = 0.0f;
    float nrp_x = 0.0f, nrp_y = 0.0f, nrp_h = 0.0f;
    if (role != CON) {
      const float th_ = tanhf((l - l_trg) * 0.5f);
      float t_headway = pp[T_HEADWAY_DESIRED] * (1.0f - th_ * th_);
      t_headway = fmaxf(t_headway, 0.5f);
      const float s_net_stop = d_stop - df + 1.0f;
      const float s_star_stop = 1.0f + v * t_headway + (v * v) / sq2;
      float inter_term = s_star_stop / s_net_stop;
      const float s_net = d_lead - df;
      const float s_star = pp[D_SAFE_MIN] + v * t_headway +
                           v * (v - v_lead) / sq2;
      if (d_lead < d_stop) inter_term = fmaxf(s_star / s_net, inter_term);
      const float v_rel = v / v_trg;
      const float expo = v_rel < 1.0f ? pp[IDM_EXP_ACC] : pp[IDM_EXP_DCC];
      float a_idm = pp[A_MAX] *
          (1.0f - powf(v_rel, expo) - inter_term * inter_term);

      const float dtc = fmaxf(dt_control, 1e-6f);
      const bool lane_changing = fabsf(l - l_trg) > 0.5f && v > 1.0f &&
                                 v < 5.0f;
      if (lane_changing) a_idm = fminf(a_idm, 0.0f);
      float j = (a_idm - a) / dtc;
      if (v == 0.0f && a < 0.0f)
        j = fminf(fmaxf(j, pp[J_MIN]), -a / dtc);
      else
        j = fminf(fmaxf(j, pp[J_MIN]), pp[J_MAX]);
      a_new = fminf(fmaxf(fma32(j, dt_control, a), pp[A_MIN]), pp[A_MAX]);
      if (SPLIT && lane == 0) xch[X_ANEW] = a_new;

      const float rp_h = ref_2hot(rl, NR, 2, ref_step, s);
      const float rp_k = ref_2hot(rl, NR, 3, ref_step, s);
      const float l_change = clampf(l_trg - l, -1.5f, 1.5f);
      nl = l + l_change * pp[DT];
      const float s_rate = v * cosf(h - rp_h) / (1.0f - l * rp_k);
      ns = s + s_rate * pp[DT];
      nrp_x = ref_2hot(rl, NR, 0, ref_step, ns);
      nrp_y = ref_2hot(rl, NR, 1, ref_step, ns);
      nrp_h = ref_2hot(rl, NR, 2, ref_step, ns);
      const float heading_rel = short_angle(h, rp_h) + s_rate * rp_k * pp[DT];
      nh = nrp_h + heading_rel;
    }

    // --- following controller (Stanley + PD): the steering, from the
    // step's states alone ---
    float new_steer = 0.0f;
    const float cx = con[V_X], cy = con[V_Y], ch = con[V_H];
    const float cst = con[V_ST], cv = con[V_V], ca = con[V_A];
    const float cs = con[V_S], cl = con[V_L];
    if (role != REF) {
      const float dtc = fmaxf(dt_control, 1e-6f);
      const float k_con = ref_2hot(rl, NR, 3, ref_step, cs);
      const float k_adj = fabsf(k_con) > 1e-4f ? 1.0f / (1.0f / k_con + cl)
                                               : k_con;
      const float steer_ref = atanf(k_adj * pp[WHEEL_BASE]);
      const float angle_diff = short_angle(ch, h);
      const float lat_diff = l - cl;
      float steer_angle = steer_ref + angle_diff +
          atanf(pp[K_STANLEY] * lat_diff / (pp[V_OFFSET_STANLEY] + cv));
      steer_angle = fminf(fmaxf(steer_angle, -pp[STEER_ANGLE_MAX]),
                          pp[STEER_ANGLE_MAX]);
      const float steer_rate = fminf(fmaxf((steer_angle - cst) / dtc,
                                           -pp[STEER_RATE_MAX]),
                                     pp[STEER_RATE_MAX]);
      const bool do_steer = cv > 1.0f || ca > 0.5f || fabsf(lat_diff) > 0.1f;
      new_steer = do_steer ? cst + steer_rate * dt_control : cst;
    }
    if (SPLIT) {
      __syncthreads();
      if (role == CON) a_new = xch[X_ANEW];
    }

    // the step's states: the reference (its acceleration and side
    // distances of this step), the vehicle (its steering and acceleration
    // of this step)
    if (role != CON && active && lane < N_R) {
      float val = 0.0f;
#pragma unroll
      for (int i = 0; i < N_R; ++i)
        if (lane == i)
          val = i == R_A ? a_new : i == R_DR ? d_right
              : i == R_DL ? d_left : ref[i];
      o_ref[(size_t)k * N_R + lane] = val;
    }
    if (role != REF) {
      const float a_con = a_new + (s - cs) * pp[K_P_S] + (v - cv) * pp[K_P_V];
      if (active && lane < N_V) {
        float val = 0.0f;
#pragma unroll
        for (int i = 0; i < N_V; ++i)
          if (lane == i)
            val = i == V_ST ? new_steer : i == V_A ? a_con : con[i];
        o_con[(size_t)k * N_V + lane] = val;
      }

      // the vehicle's kinematics, then its projection onto the ref
      // linestrip: the last step's chunk, then the chunks the boxes cannot
      // exclude, in index order
      const float nv = fmaxf(fma32(pp[DT], a_con, cv), 0.0f);
      const float nheading = ch + pp[DT] * nv * tanf(new_steer) /
                             pp[WHEEL_BASE];
      const float nx = cx + pp[DT] * nv * cosf(nheading);
      const float ny = cy + pp[DT] * nv * sinf(nheading);
      const int n_seg = NR - 1;
      float bd = inf;
      int bi = 1 << 30;
      const int wc = prev_seg / CHUNK;
      {
        const int n = wc * CHUNK + lane;
        if (n < n_seg) take_min(bd, bi, seg_d2(rl, NR, n, nx, ny), n);
      }
      float best = warp_min(bd);
      for (int g = 0; g < n_sch; g += WARP) {
        const int jl = g + lane;
        const float key = jl < n_sch && jl != wc
            ? box_key(sbox + 4 * jl, nx, ny) : inf;
        unsigned m = __ballot_sync(FULL, !(key > best));
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          if (__shfl_sync(FULL, key, b) > best) continue;   // best has fallen
          const int n = (g + b) * CHUNK + lane;
          if (n < n_seg) take_min(bd, bi, seg_d2(rl, NR, n, nx, ny), n);
          best = warp_min(bd);
        }
      }
      warp_argmin(bd, bi);
      prev_seg = bi;
      float arc_p, lat_p;
      {
        const int n = bi;
        const float ax = rl[n], ay = rl[NR + n];
        const float vx = rl[n + 1] - ax, vy = rl[NR + n + 1] - ay;
        const float vv = fmaxf(vx * vx + vy * vy, 1e-12f);
        const float q = ((nx - ax) * vx + (ny - ay) * vy) / vv;
        const float qc = clampf(q, 0.0f, 1.0f);
        const float fx = ax + vx * qc, fy = ay + vy * qc;
        const float ex = nx - fx, ey = ny - fy;
        float dist = sqrtf(ex * ex + ey * ey);
        const float gx = fx - ax, gy = fy - ay;
        arc_p = arc0[n] + sqrtf(gx * gx + gy * gy);
        const float ang = atan2f(vy, vx);
        const float ox = fx - nx, oy = fy - ny;
        const float on = sqrtf(ox * ox + oy * oy);
        const float inv = 1.0f / fmaxf(on, 1e-12f);
        const bool sign_neg =
            cosf(ang) * (-oy * inv) + sinf(ang) * (ox * inv) <= 0.0f;
        if (sign_neg) dist = -dist;
        if (on < 1e-9f) dist = 0.0f;
        lat_p = dist;
      }
      con[V_T] = con[V_T] + pp[DT];
      con[V_X] = nx;
      con[V_Y] = ny;
      con[V_H] = nheading;
      con[V_ST] = new_steer;
      con[V_V] = nv;
      con[V_A] = a_con;
      con[V_S] = arc_p;
      con[V_L] = lat_p;
    }
    if (role != CON) {
      ref[R_T] = ref[R_T] + pp[DT];
      ref[R_X] = nrp_x - nl * sinf(nrp_h);
      ref[R_Y] = nrp_y + nl * cosf(nrp_h);
      ref[R_H] = nh;
      ref[R_V] = fmaxf(fma32(a_new, pp[DT], v), 0.0f);
      ref[R_A] = a_new;
      ref[R_S] = ns;
      ref[R_L] = nl;
      ref[R_DR] = 0.0f;
      ref[R_DL] = 0.0f;
      if (SPLIT && lane < N_R) {
        float val = 0.0f;
#pragma unroll
        for (int i = 0; i < N_R; ++i)
          if (lane == i) val = ref[i];
        xch[X_REF + lane] = val;
      }
    }
  }
  if (role != CON && active && lane < N_R) {
    float val = 0.0f;
#pragma unroll
    for (int i = 0; i < N_R; ++i)
      if (lane == i) val = ref[i];
    o_ref[(size_t)(T - 1) * N_R + lane] = val;
  }
  if (role != REF && active && lane < N_V) {
    float val = 0.0f;
#pragma unroll
    for (int i = 0; i < N_V; ++i)
      if (lane == i) val = con[i];
    o_con[(size_t)(T - 1) * N_V + lane] = val;
  }
}

}  // namespace idm_rollout_k

// whether C candidates take two warps each: where they are few, the card
// has warps to spare and a step's two halves run side by side
extern "C" int idm_rollout_split(int C) {
  return C <= idm_rollout_k::SPLIT_MAX_C ? 1 : 0;
}

#ifdef __CUDACC__
// lets both instantiations take more than 48 KB of dynamic shared memory
static cudaError_t opt_in(size_t smem) {
  static size_t opted = 0;
  if (smem <= 48 * 1024 || smem <= opted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      idm_rollout_k::idm_rollout_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(idm_rollout_k::idm_rollout_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess) opted = smem;
  return e;
}

// blocks of the kernel an SM holds at these sizes (registers, shared
// memory, threads), or -1
extern "C" int idm_rollout_blocks_per_sm(int NR, int O, int P, int K) {
  using namespace idm_rollout_k;
  const size_t smem = rollout_smem_floats(NR, O, P, K) * sizeof(float);
  int n = 0;
  if (opt_in(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, idm_rollout_kernel<false>, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}
extern "C" const char* idm_rollout_param_keys() { return idm::PARAM_KEYS; }
extern "C" int idm_rollout_max_ref() { return idm_rollout_k::MAX_REF; }

// The rollout: ref_states (C, T, 10) and states (C, T, 9) from the initial
// ref and vehicle states, the candidates' lateral targets and stop
// distances (C,), the first step's control period, the ref line (NR, 7),
// its step, the ten object arrays and the packed parameters.
extern "C" int idm_rollout(const float* init_ref, const float* init_con,
                           const float* l_trgs, const float* d_stops,
                           const float* dt_replan, const float* ref_line,
                           const float* ref_step, const float* pred_t,
                           const float* pred_xy, const float* pred_heading,
                           const float* pred_v, const float* pred_dists,
                           const float* hull_preds, const float* hull_projs,
                           const float* radius_hull, const float* valid,
                           const float* on_local_map, const float* pp,
                           float* out_ref, float* out_con, int C, int T,
                           int NR, int O, int P, int K, void* stream) {
  using namespace idm_rollout_k;
  if (NR > MAX_REF || NR < 2 || O > MAX_OBJ || P > MAX_PRED || P < 2 ||
      K > MAX_HULL || C < 1 || T < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rollout_smem_floats(NR, O, P, K) * sizeof(float);
  const cudaError_t e = opt_in(smem);
  if (e != cudaSuccess) return (int)e;
  const Objs ob = {pred_t, pred_xy, pred_heading, pred_v, pred_dists,
                   hull_preds, hull_projs, radius_hull, valid, on_local_map};
  const bool split = idm_rollout_split(C) != 0;
  const int cands = split ? WARPS / 2 : WARPS;
  const int blocks = (C + cands - 1) / cands;
  auto* kernel = split ? idm_rollout_kernel<true> : idm_rollout_kernel<false>;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      init_ref, init_con, l_trgs, d_stops, dt_replan, ref_line, ref_step, ob,
      pp, out_ref, out_con, C, T, NR, O, P, K);
  return (int)cudaGetLastError();
}
#endif

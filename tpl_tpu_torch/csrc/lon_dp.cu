// Longitudinal DP of the poly-lat / lon-DP planner chain, for Hopper (sm_90a).
//
// Replaces the two XLA programs of tpl_tpu/planning/dyn_prog/lon_kernel.py
// make_lon_solver (no Pallas kernel): the backward value iteration, a
// lax.scan over the T - 1 slices of `eval_grid` (:197-342, :408-418), and
// the greedy forward pass, a lax.scan of T steps of `eval_single` (:344-393,
// :425-451), which `reeval` (:455-474) runs too with each state's own jerk.
// The reference is lonBackwardStep / evalNode (lon_planner.cu).
//
// lon_dp_backward: one backward slice.  A node (s, v, a) tries the NB = 9
// jerks: next state, the trilinear value lookup in the next slice (an s row
// shift and a (v, a) bilinear lookup, 8 corners of 3 channels), cost and
// constraint terms, and keeps the lexicographic (constraint, cost) minimum,
// the first jerk winning.  The final slice is [state_cost, 0, 0, 0] and
// reads no next slice.  The bytes the function must move (the next slice
// read once, 2.38 MB at the demo grid of 201 x 37 x 20 nodes, the slice
// written once) take ~1.4 us and its ~0.13 GFLOP ~2 us.  One thread a node
// with 72 float4 loads a node from L2 (the earlier design) spent its time
// on those loads and on recomputing, for each of the 201 s rows, what
// depends on (v, a, jerk) alone: the next v, a and s change, the row shift
// k, the fraction, the (v, a) corners and their four weights (three IEEE
// divisions a node-jerk).  So a block owns one v and a tile of s rows
// (all a):
// - it forms its (a, jerk) table once in shared memory (struct Coord), with
//   the plain operations in the plain order, and the jerk-only and
//   (a, jerk)-only terms of the cost and constraint with it;
// - the table's own clamped indices give the block's box of the next slice:
//   rows s0 + k_min .. s_last + k_max + 1 (clamped), v rows min y0 .. max
//   y1, every a.  The box is staged in shared memory with 4-byte cp.async
//   copies as three planes of floats (cost, constraint, jerk; the fourth
//   channel is never read), a row of v rows x a at an odd stride; the
//   copies run while the tile's s rows (grid value, v_max, distance slack)
//   and the path's v_max column are formed;
// - a thread per (s, a) of the tile, neighbouring s on neighbouring lanes:
//   a warp reads one or two table entries (a broadcast) and box rows that
//   fall on distinct banks.  Per node-jerk what is left is the s row pair,
//   the path lookup at s + s_change (one division), the blends, costs and
//   constraints; the tile's results go out a row of a at a time.
// On an NVIDIA H100 80GB HBM3 (700 W) a demo slice takes 0.0187 ms of
// device time against the earlier design's 0.0222 (chip_smoke.py
// --parent-csrc, from CUDA graphs).  What is left: the evaluation's
// instructions (the blends of 8 corners x 3 channels in the plain order),
// the staging (every row of the next slice is staged by about nine
// neighbouring v blocks) and the launch.
// The host picks the tile (lon_kernel.py backward_plan) from the largest box
// of any block, which it forms from the same table in float32, so that two
// blocks share an SM and the grid fits one wave; it raises where even one
// s row's box does not fit a block.  A block whose box exceeds the room it
// was given writes NaN (a guard, never taken with the host's plan).

// lon_dp_forward: one block of two warps.  Mode 0 is the forward pass: T
// dependent steps, the NF = 21 jerks of a step on the lanes of each warp.
// The path's s and v_max columns and the distance map (9.6 KB at the demo
// grid) are staged in shared memory once, while step 0's lookups load, so
// that a step's one round trip to device memory is its trilinear value
// lookup (8 corners), on warp 0.  Warp 1 forms, for each jerk, v_max at its
// next s and the state the row leads to if it wins, with that state's path
// terms; warp 0 takes the lexicographic minimum (two warp reductions and a
// ballot, warp_pick), and both read the winner's state and terms for the
// next step from shared memory.  Lane 0 writes the row.  Mode 1 is the
// reeval pass: every row of a stored trajectory with its own jerk, rows on
// the threads.  Bound by the T-step dependency.
//
// Both keep the plain version's lexicographic minimum (_lex_min, which is
// jnp.min / jnp.argmin in the JAX program), NaN included: a NaN constraint
// makes the least constraint NaN, which no action's mask passes, so the node
// gets cost inf, constraint NaN and the first jerk; among the actions of the
// least constraint the first NaN cost wins; where every such action costs
// inf the first jerk does.  So the NaN a backward block writes when its box
// overflows its room (the guard above) reaches the next slice, and the
// forward pass, as a NaN constraint, not dropped.  The cost and constraint
// terms keep a NaN of the distance map or of the path's v_max column as the
// plain version's torch.clamp does (max_nan, nan_minmax.cuh); the clamps
// that form an index or a coordinate of the value lookup drop it, so that a
// NaN never becomes an address.
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
#include <string.h>

#include "nan_minmax.cuh"
#include "smem_limit.cuh"

namespace lon_dp {

using nan_minmax::max_nan;

constexpr int NB = 9;           // backward jerk samples
constexpr int NF = 21;          // forward jerk samples
constexpr int MAX_THREADS = 384;    // backward block, at most
constexpr int WARP = 32;            // forward block

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

// a 4-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
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

// interp_col over a column staged on its own (v[i] is path[i * N_PC +
// col]): the same operations
__device__ __forceinline__ float interp_staged(const float* v, float dist,
                                               float pss, int P) {
  const float a = dist / pss;
  const float i0f = clampf(floorf(a), 0.0f, (float)(P - 1));
  const float i1f = clampf(ceilf(a), 0.0f, (float)(P - 1));
  const float al = a - i0f;
  return v[(int)i0f] * (1.0f - al) + v[(int)i1f] * al;
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
            * max_nan(v * pp[TIME_GAP] + pp[GAP_MIN] - s_dist, 0.0f);
  r.constr = max_nan(v - v_max, 0.0f);
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

// the terms of the next acceleration's limits
struct ALimits {
  float below, above;
};

__device__ __forceinline__ ALimits a_limits(const float* pp, float an) {
  return {fmaxf(pp[A_MIN] - an, 0.0f), fmaxf(an - pp[A_MAX], 0.0f)};
}

// the action's cost and constraint from its looked-up value nn[0..2], the
// path's v_max at the next s, v_max_n, and the acceleration limits' terms
__device__ __forceinline__ void action_terms(const float* pp, StateTerms st,
                                             const float (&nn)[3], float j,
                                             float dt, const Next& n,
                                             float s_dist, float v_max_n,
                                             ALimits al, float* cost_out,
                                             float* constr_out) {
  float cost = st.cost + nn[0];
  float constr = st.constr + nn[1];
  const float dj = nn[2] - j;
  cost = cost + pp[W_SNAP] * (dj * dj);
  const float jd = j * dt;
  cost = cost + pp[W_J] * (jd * jd);
  constr = constr + max_nan(n.vn - v_max_n, 0.0f);
  constr = constr + max_nan(n.s_change - s_dist, 0.0f);
  constr = constr + al.below;
  constr = constr + al.above;
  *cost_out = cost;
  *constr_out = constr;
}

// ---------------------------------------------------------------------
// backward slice

// What a node of the block's v needs of one (a, jerk) besides its s: the
// next s change and v, the s row shift and its fraction, the (v, a)
// corners' weights and their offsets in a box row (o[0..3], (y0, z0), (y0,
// z1), (y1, z0), (y1, z1); until the box is known y0, y1, z0, z1), the
// next acceleration's limit terms and the jerk.  16-byte aligned, so that
// a lane reads it in four loads.
struct __align__(16) Coord {
  float s_change, vn, f_c, ax_c;
  float w00, w01, w10, w11;
  int k, o[4];
  ALimits al;
  float j;
};

// a box row of n floats is laid out with an odd stride, so that lanes on
// neighbouring rows read distinct banks
__host__ __device__ inline int row_stride(int n) { return n | 1; }

__host__ __device__ inline size_t backward_smem_bytes(int A, int tile, int P,
                                                      int box_cap) {
  return sizeof(float4) * (size_t)tile * A
         + sizeof(float) * (((size_t)box_cap + 3) / 4 * 4)
         + sizeof(Coord) * (size_t)A * NB
         + sizeof(float) * ((size_t)P + 3 * (size_t)tile)
         + sizeof(int) * 4 * (MAX_THREADS / WARP);
}

// the threads of a block of `tile` s rows: every (s, a) of the tile at
// once, in whole warps, MAX_THREADS at most
__host__ __device__ inline int backward_threads(int A, int tile) {
  const int t = (tile * A + WARP - 1) / WARP * WARP;
  return t < 2 * WARP ? 2 * WARP : (t > MAX_THREADS ? MAX_THREADS : t);
}

// a block: one v (blockIdx.x) and the s rows s0 .. s0 + tile - 1
// (blockIdx.y), every a; `box_cap` floats of shared memory for its box
__global__ void __launch_bounds__(MAX_THREADS, 2)
lon_backward_kernel(const float4* __restrict__ nodes_next,
                    const float* __restrict__ pp_in,
                    const float* __restrict__ path,
                    const float* __restrict__ dist_path,
                    float4* __restrict__ out, int S, int V, int A, int P,
                    int t_idx, bool is_last, int tile, int box_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* res = reinterpret_cast<float4*>(smem_raw);      // (tile, A)
  float* box = reinterpret_cast<float*>(res + tile * A);
  Coord* tab = reinterpret_cast<Coord*>(box + (box_cap + 3) / 4 * 4);
  float* vmax = reinterpret_cast<float*>(tab + A * NB);   // (P,)
  float* s_val = vmax + P;
  float* s_vmax = s_val + tile;
  float* s_slack = s_vmax + tile;
  int* part = reinterpret_cast<int*>(s_slack + tile);     // (warps, 4)

  float pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const int tid = threadIdx.x;
  const int i_v = blockIdx.x;
  const int s0 = blockIdx.y * tile;
  const int n_s = mini(tile, S - s0);
  const float v = axis_point(pp[V_MIN], pp[V_MAX], i_v, V - 1);
  const float pss = pp[PATH_STEP_SIZE];
  const float dt = pp[DT];

  int bs0 = 0, rs = 0, plane = 0;
  bool fits = true;
  if (!is_last) {
    // the (a, jerk) table and each warp's extremes of its row shifts and v
    // rows, then the block's
    const float s_step_x = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
    int k_lo = 0x7fffffff, k_hi = -0x7fffffff - 1;
    int y_lo = 0x7fffffff, y_hi = -0x7fffffff - 1;
    for (int e = tid; e < A * NB; e += blockDim.x) {
      const int i_a = e / NB, jb = e - i_a * NB;
      const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
      const float j = axis_point(pp[J_MIN], pp[J_MAX], jb, NB - 1);
      const Next n = next_state(0.0f, v, a, j, dt);
      Coord c;
      c.s_change = n.s_change;
      c.vn = n.vn;
      c.f_c = n.s_change / s_step_x;
      const float k_c = floorf(c.f_c);
      c.ax_c = c.f_c - k_c;
      const float y = clampf((n.vn - pp[V_MIN]) / (pp[V_MAX] - pp[V_MIN])
                             * (float)(V - 1), 0.0f, (float)(V - 1));
      const float z = clampf((n.an - pp[A_MIN]) / (pp[A_MAX] - pp[A_MIN])
                             * (float)(A - 1), 0.0f, (float)(A - 1));
      const float y0f = floorf(y), z0f = floorf(z);
      const float wy0 = 1.0f - (y - y0f);
      const float wz0 = 1.0f - (z - z0f);
      const int y0 = (int)y0f, z0 = (int)z0f;
      c.o[0] = y0;
      c.o[1] = mini(y0 + 1, V - 1);
      c.o[2] = z0;
      c.o[3] = mini(z0 + 1, A - 1);
      c.w00 = wy0 * wz0;
      c.w01 = wy0 * (1.0f - wz0);
      c.w10 = (1.0f - wy0) * wz0;
      c.w11 = (1.0f - wy0) * (1.0f - wz0);
      c.k = (int)k_c;
      c.al = a_limits(pp, n.an);
      c.j = j;
      tab[e] = c;
      k_lo = mini(k_lo, c.k);
      k_hi = k_hi > c.k ? k_hi : c.k;
      y_lo = mini(y_lo, c.o[0]);
      y_hi = y_hi > c.o[1] ? y_hi : c.o[1];
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2) {
      k_lo = mini(k_lo, __shfl_xor_sync(0xffffffffu, k_lo, o));
      const int kh = __shfl_xor_sync(0xffffffffu, k_hi, o);
      k_hi = k_hi > kh ? k_hi : kh;
      y_lo = mini(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, o));
      const int yh = __shfl_xor_sync(0xffffffffu, y_hi, o);
      y_hi = y_hi > yh ? y_hi : yh;
    }
    if ((tid & (WARP - 1)) == 0) {
      int* w = part + 4 * (tid / WARP);
      w[0] = k_lo;
      w[1] = k_hi;
      w[2] = y_lo;
      w[3] = y_hi;
    }
    __syncthreads();
    for (int w = 0; w < (int)(blockDim.x / WARP); ++w) {
      k_lo = mini(k_lo, part[4 * w]);
      k_hi = k_hi > part[4 * w + 1] ? k_hi : part[4 * w + 1];
      y_lo = mini(y_lo, part[4 * w + 2]);
      y_hi = y_hi > part[4 * w + 3] ? y_hi : part[4 * w + 3];
    }

    // the box: the rows every (s, jerk) of the tile reads (clamped as the
    // lookup clamps them) x the v rows y_lo .. y_hi x every a, one plane
    // per channel (cost, constraint, jerk); the copies run while the s
    // rows below are formed
    bs0 = clampi(s0 + k_lo, 0, S - 1);
    const int bs1 = clampi(s0 + n_s - 1 + k_hi + 1, 0, S - 1);
    const int row_len = (y_hi - y_lo + 1) * A;
    rs = row_stride(row_len);
    plane = (bs1 - bs0 + 1) * rs;
    fits = 3 * plane <= box_cap;
    if (fits)
      for (int q = tid; q < (bs1 - bs0 + 1) * row_len; q += blockDim.x) {
        const int r = q / row_len, c = q - r * row_len;
        const float* src = reinterpret_cast<const float*>(
            nodes_next + ((bs0 + r) * V + y_lo) * A + c);
        float* dst = box + r * rs + c;
        copy4_async(dst, src);
        copy4_async(dst + plane, src + 1);
        copy4_async(dst + 2 * plane, src + 2);
      }
    // the table's corners as offsets in a box row
    for (int e = tid; e < A * NB; e += blockDim.x) {
      int* o = tab[e].o;
      const int y0 = (o[0] - y_lo) * A, y1 = (o[1] - y_lo) * A;
      const int z0 = o[2], z1 = o[3];
      o[0] = y0 + z0;
      o[1] = y0 + z1;
      o[2] = y1 + z0;
      o[3] = y1 + z1;
    }
  }
  // the path's v_max column; the tile's s rows: grid value, v_max there and
  // the distance map's slack
  if (!is_last)
    for (int q = tid; q < P; q += blockDim.x)
      vmax[q] = path[q * N_PC + PC_VMAX];
  for (int r = tid; r < n_s; r += blockDim.x) {
    const float s = axis_point(pp[S_MIN], pp[S_MAX], s0 + r, S - 1);
    s_val[r] = s;
    s_vmax[r] = interp_col(path, PC_VMAX, s, pss, P);
    s_slack[r] = s_dist_at(dist_path, pp, t_idx,
                           interp_col(path, PC_S, s, pss, P), S);
  }
  copies_wait();
  __syncthreads();

  // a thread per (s, a) of the tile, neighbouring s on neighbouring lanes
  // (their table entries are one, their box rows neighbours)
  for (int item = tid; item < n_s * A; item += blockDim.x) {
    const int i_a = item / n_s, r = item - i_a * n_s;
    const int i_s = s0 + r;
    const float s = s_val[r];
    const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
    const float s_dist = s_slack[r];
    const StateTerms st = state_terms(pp, s, v, a, s_dist, s_vmax[r]);
    float4& o = res[r * A + i_a];
    if (is_last) {
      o = make_float4(st.cost, 0.0f, 0.0f, 0.0f);
      continue;
    }
    if (!fits) {
      o = make_float4(NAN, NAN, NAN, NAN);
      continue;
    }
    float cost[NB], constr[NB];
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const Coord& c = tab[i_a * NB + jb];
      Next n;
      n.s_change = c.s_change;
      n.vn = c.vn;
      n.sn = s + c.s_change;
      const int rows[2] = {clampi(i_s + c.k, 0, S - 1) - bs0,
                           clampi(i_s + c.k + 1, 0, S - 1) - bs0};
      const float ax_row = (float)i_s + c.f_c >= (float)(S - 1) ? 0.0f
                                                               : c.ax_c;
      float b[2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* base = box + rows[q] * rs;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* p = base + ch * plane;
          b[q][ch] = ((p[c.o[0]] * c.w00 + p[c.o[1]] * c.w01)
                      + p[c.o[2]] * c.w10)
                     + p[c.o[3]] * c.w11;
        }
      }
      float nn[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        nn[q] = b[0][q] * (1.0f - ax_row) + b[1][q] * ax_row;
      action_terms(pp, st, nn, c.j, dt, n, s_dist,
                   interp_staged(vmax, n.sn, pss, P), c.al, &cost[jb],
                   &constr[jb]);
    }
    // the plain version's lexicographic minimum (the rule above)
    float cmin = constr[0];
    bool nan_c = constr[0] != constr[0];
#pragma unroll
    for (int jb = 1; jb < NB; ++jb) {
      cmin = fminf(cmin, constr[jb]);
      nan_c = nan_c || constr[jb] != constr[jb];
    }
    if (nan_c) cmin = NAN;
    float best = INFINITY;
    int jbest = 0;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const float cj = constr[jb] <= cmin ? cost[jb] : INFINITY;
      if (cj < best || (cj != cj && best == best)) {
        best = cj;
        jbest = jb;
      }
    }
    o = make_float4(best, cmin,
                    axis_point(pp[J_MIN], pp[J_MAX], jbest, NB - 1), 0.0f);
  }
  __syncthreads();

  // the tile's nodes, a row of A at a time
  for (int q = tid; q < n_s * A; q += blockDim.x) {
    const int r = q / A;
    out[((s0 + r) * V + i_v) * A + (q - r * A)] = res[q];
  }
}

// ---------------------------------------------------------------------
// forward pass / reeval

// the 8 corners of the forward pass's value lookup (trilerp) and their
// fractions; the loads are issued here and waited for at blend()
struct Corners {
  float4 n[8];      // (x, y, z) = 000, 100, 010, 110, 001, 101, 011, 111
  float ax, ay, az;
};

__device__ __forceinline__ Corners corners(const float4* __restrict__ nodes,
                                           const float* pp, int S, int V,
                                           int A, float s, float v, float a) {
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
  Corners k;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    k.n[e] = load4(nodes + ((e & 1 ? i1[0] : i0[0]) * V
                            + (e & 2 ? i1[1] : i0[1])) * A
                   + (e & 4 ? i1[2] : i0[2]));
  k.ax = fr[0];
  k.ay = fr[1];
  k.az = fr[2];
  return k;
}

// the trilinear blend of channels 0..2, in the plain version's order
__device__ __forceinline__ void blend(const Corners& k, float (&res)[3]) {
  const float ax = k.ax, ay = k.ay, az = k.az;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    auto ch = [&](int e) {
      return c == 0 ? k.n[e].x : (c == 1 ? k.n[e].y : k.n[e].z);
    };
    const float c00 = ch(0) * (1.0f - ax) + ch(1) * ax;
    const float c10 = ch(2) * (1.0f - ax) + ch(3) * ax;
    const float c01 = ch(4) * (1.0f - ax) + ch(5) * ax;
    const float c11 = ch(6) * (1.0f - ax) + ch(7) * ax;
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

// What the forward pass looks up besides the nodes, staged in shared memory
// once: the path's s and v_max columns and every row of the distance map
// (the state's time picks the row, clamped to 0 .. T - 1).  Lookups there
// are interp_col / s_dist_at over the staged values, the same operations.
struct Staged {
  const float* s_col;     // (P,)
  const float* vmax_col;  // (P,)
  const float* dmap;      // (T, S)
};

// the helper warp's candidates of a step (two steps' worth, by parity):
// each jerk's next state, its distance slack and state terms (N_CAND rows of
// NF), v_max at each jerk's next s, and the winner's index
enum { C_S, C_V, C_A, C_SDIST, C_COST, C_CONSTR, N_CAND };

__host__ __device__ inline size_t forward_smem_bytes(int T, int S, int P) {
  return sizeof(float) * (2 * (size_t)P + (size_t)T * S
                          + 2 * N_CAND * NF + NF)
         + sizeof(int) * 4;
}

// named barriers of the forward block's two warps (on the host, where the
// block's threads run on a barrier of their own, the block's barrier)
__device__ __forceinline__ void pair_sync(int id) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(2 * WARP) : "memory");
#else
  __syncthreads();
#endif
}

__device__ __forceinline__ void pair_arrive(int id) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(2 * WARP) : "memory");
#else
  __syncthreads();
#endif
}

// a state's path terms: v_max at s and the distance slack at the s index of
// the path's station
__device__ __forceinline__ void path_terms(const Staged& sg, const float* pp,
                                           int t_idx, float s, int S, int P,
                                           float* v_max, float* s_dist) {
  const float pss = pp[PATH_STEP_SIZE];
  *v_max = interp_staged(sg.vmax_col, s, pss, P);
  const float s_path = interp_staged(sg.s_col, s, pss, P);
  const float si = clampf(rintf((s_path - pp[S_MIN]) / (pp[S_MAX] - pp[S_MIN])
                                * (float)(S - 1)),
                          0.0f, (float)(S - 1));
  *s_dist = sg.dmap[t_idx * S + (int)si] - pp[LENGTH_VEH] * 0.6f;
}

// the evaluated row: jerk, cost and constraint set unless tp is at the last
// slice (then its state cost)
__device__ __forceinline__ void finish_row(const float* tp, const float* pp,
                                           int T, float state_cost,
                                           float cost_best, float cmin,
                                           float j_best, float* out) {
  const bool is_last = rintf(tp[LC_T] / pp[DT]) == (float)(T - 1);
#pragma unroll
  for (int c = 0; c < N_LC; ++c) out[c] = tp[c];
  out[LC_J] = is_last ? tp[LC_J] : j_best;
  out[LC_COST] = is_last ? state_cost : cost_best;
  out[LC_CONSTR] = is_last ? tp[LC_CONSTR] : cmin;
}

// a float's place in the total order of its values, a zero of either sign
// as +0 (so that the two compare equal, as they do in the plain version's
// comparisons)
__device__ __forceinline__ unsigned order_key(float x) {
  x = x == 0.0f ? 0.0f : x;
#ifdef __CUDA_ARCH__
  const unsigned b = __float_as_uint(x);
#else
  unsigned b;
  memcpy(&b, &x, sizeof(b));
#endif
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The lexicographic minimum of the lanes' (constraint c, cost k), the lanes
// that hold an action `valid` (lane = the action's index), on every lane:
// the plain version's rule (see the header).  Two warp reductions over
// order keys (the least constraint, then the least cost among the lanes of
// that constraint, a NaN cost first) and a ballot of the first lane that
// holds it.  Returns the winner's lane in `k`, and in `tier` a lane of the
// least constraint (the winner unless a rule of the header picks jerk 0).
struct Pick {
  bool nan_c, all_inf;
  int k, tier;
};

__device__ __forceinline__ Pick warp_pick(float c, float k, bool valid) {
  const unsigned FULL = 0xffffffffu;
  Pick p;
  p.nan_c = __ballot_sync(FULL, valid && c != c) != 0u;
  const unsigned ck = valid && c == c ? order_key(c) : 0xffffffffu;
  const unsigned cmin = __reduce_min_sync(FULL, ck);
  const bool tier = valid && ck == cmin;
  const unsigned kk = !tier ? 0xffffffffu : (k != k ? 0u : order_key(k) + 1u);
  const unsigned kmin = __reduce_min_sync(FULL, kk);
  p.tier = __ffs(__ballot_sync(FULL, tier && kk == kmin)) - 1;
  p.all_inf = kmin == order_key(INFINITY) + 1u;
  p.k = p.nan_c || p.all_inf ? 0 : p.tier;
  return p;
}

// the phases of the profiling instantiation, in the order lon_kernel.py
// FORWARD_PHASES names them: lane 0's clock64() cycles, summed over the
// steps (the staging once)
enum FwdPhase { F_STAGE, F_LOOKUP, F_TERMS, F_PICK, F_NEXT, N_FWD_PHASE };

template <bool PROF>
struct LaneClock {
  long long last = 0;
  long long acc[N_FWD_PHASE] = {};

  __device__ __forceinline__ void start() {
    if constexpr (PROF) last = clock64();
  }
  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[phase] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* prof) {
    if constexpr (PROF) {
      if (threadIdx.x == 0)
        for (int i = 0; i < N_FWD_PHASE; ++i)
          prof[i] += (unsigned long long)acc[i];
    }
  }
};

// a state's terms that do not depend on the action: the path's v_max at s,
// the distance slack and the state cost and constraint
struct Here {
  float s_dist;
  StateTerms st;
};

__device__ __forceinline__ Here here(const Staged& sg, const float* pp,
                                     int t_idx, float s, float v, float a,
                                     int S, int P) {
  Here h;
  float v_max;
  path_terms(sg, pp, t_idx, s, S, P, &v_max, &h.s_dist);
  h.st = state_terms(pp, s, v, a, h.s_dist, v_max);
  return h;
}

// Two warps.  Mode 0, the forward pass: T dependent steps, the NF = 21
// jerks on lanes 0..20 of each warp.  Both hold the state and its terms.
// Warp 0 forms its jerk's next state and issues the step's one round trip
// to device memory, the trilerp's 8 corners, blends them, forms the cost
// and constraint and takes the lexicographic minimum (warp_pick); lane 0
// writes the row.  Meanwhile warp 1 forms, for its jerk, v_max at the next
// s (which warp 0's constraint needs) and the state the row would lead to
// if that jerk won (the plain version's next-state formula) with that
// state's terms, into shared memory, so that after the minimum the next
// step's state and terms are the winner's, read there.  Mode 1, the reeval
// pass: every row of `states` with its own jerk, rows on the 64 threads.
// The path's columns and the distance map are staged in shared memory
// first; the copies run while step 0's corners load.
template <bool PROF>
__global__ void __launch_bounds__(2 * WARP)
lon_forward_kernel(const float4* __restrict__ nodes,
                   const float* __restrict__ pp_in,
                   const float* __restrict__ path,
                   const float* __restrict__ dist_path,
                   const float* __restrict__ states, float* __restrict__ out,
                   unsigned long long* __restrict__ prof, int T, int S, int V,
                   int A, int P, int n_rows, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const Staged sg = {smem, smem + P, smem + 2 * P};
  float* cand = smem + 2 * P + T * S;         // (2, N_CAND, NF)
  float* vmax_n = cand + 2 * N_CAND * NF;     // (NF,)
  int* win = reinterpret_cast<int*>(vmax_n + NF);
  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), warp = tid / WARP;
  LaneClock<PROF> clk;
  clk.start();
  float pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  for (int q = tid; q < P; q += 2 * WARP) {
    copy4_async(smem + q, path + q * N_PC + PC_S);
    copy4_async(smem + P + q, path + q * N_PC + PC_VMAX);
  }
  for (int q = tid; q < T * S; q += 2 * WARP) copy4_async(smem + 2 * P + q,
                                                          dist_path + q);
  const size_t slice = (size_t)S * V * A;
  const float pss = pp[PATH_STEP_SIZE];

  if (mode == 1) {
    copies_wait();
    __syncthreads();
    // reeval: every row with its own jerk, rows on the threads
    for (int r = tid; r < n_rows; r += 2 * WARP) {
      float row[N_LC];
#pragma unroll
      for (int c = 0; c < N_LC; ++c) row[c] = states[r * N_LC + c];
      const float dt_i = r == 0 ? pp[DT_START] : pp[DT];
      const float s = row[LC_S], v = row[LC_V], a = row[LC_A];
      const float j = row[LC_J];
      const Here h = here(sg, pp, t_index(row[LC_T], pp, T), s, v, a, S, P);
      const Next n = next_state(s, v, a, j, dt_i);
      float nn[3];
      blend(corners(nodes + mini(r + 1, T - 1) * slice, pp, S, V, A, n.sn,
                    n.vn, n.an), nn);
      float cost, constr;
      action_terms(pp, h.st, nn, j, dt_i, n, h.s_dist,
                   interp_staged(sg.vmax_col, n.sn, pss, P),
                   a_limits(pp, n.an), &cost, &constr);
      // one action: cmin is its constraint, the cost survives unless NaN
      cost = constr <= constr ? cost : INFINITY;
      float o[N_LC];
      finish_row(row, pp, T, h.st.cost, cost, constr, j, o);
#pragma unroll
      for (int c = 0; c < N_LC; ++c) out[r * N_LC + c] = o[c];
    }
    return;
  }

  const unsigned FULL = 0xffffffffu;
  float tp[N_LC];
#pragma unroll
  for (int c = 0; c < N_LC; ++c) tp[c] = states[c];
  const bool valid = lane < NF;
  const int jl = valid ? lane : 0;
  const float j = axis_point(pp[J_MIN], pp[J_MAX], jl, NF - 1);
  Here h;     // the state's terms (step 0's once the staging is in)
  clk.stamp(F_STAGE);
  for (int i = 0; i < T; ++i) {
    const float dt_i = i == 0 ? pp[DT_START] : pp[DT];
    const float s = tp[LC_S], v = tp[LC_V], a = tp[LC_A];
    const Next n = next_state(s, v, a, j, dt_i);
    const bool is_last = rintf(tp[LC_T] / pp[DT]) == (float)(T - 1);
    float* cb = cand + (i & 1) * N_CAND * NF;
    if (warp == 1) {
      if (i == 0) {
        copies_wait();
        __syncthreads();
        h = here(sg, pp, t_index(tp[LC_T], pp, T), s, v, a, S, P);
      }
      // v_max at each jerk's next s, for warp 0's constraints
      if (valid) vmax_n[lane] = interp_staged(sg.vmax_col, n.sn, pss, P);
      pair_arrive(1);
      // the state each jerk's row leads to, and its terms
      const float jj = is_last ? tp[LC_J] : j;
      const float dt2 = dt_i * dt_i;
      const float s_n = fmaxf(s, s + v * dt_i + 0.5f * a * dt2
                              + jj * (dt_i * (dt_i * dt_i)) * (1.0f / 6.0f));
      const float v_n = fmaxf(v + a * dt_i + 0.5f * jj * dt2, 0.0f);
      const float a_n = a + jj * dt_i;
      if (valid && i + 1 < T) {
        const Here h_n = here(sg, pp, t_index(tp[LC_T] + dt_i, pp, T), s_n,
                              v_n, a_n, S, P);
        cb[C_S * NF + lane] = s_n;
        cb[C_V * NF + lane] = v_n;
        cb[C_A * NF + lane] = a_n;
        cb[C_SDIST * NF + lane] = h_n.s_dist;
        cb[C_COST * NF + lane] = h_n.st.cost;
        cb[C_CONSTR * NF + lane] = h_n.st.constr;
      }
      pair_sync(2);
    } else {
      const Corners k = corners(nodes + mini(i + 1, T - 1) * slice, pp, S, V,
                                A, n.sn, n.vn, n.an);
      if (i == 0) {
        copies_wait();
        __syncthreads();
        h = here(sg, pp, t_index(tp[LC_T], pp, T), s, v, a, S, P);
        clk.stamp(F_STAGE);
      }
      float nn[3];
      blend(k, nn);
      clk.stamp(F_LOOKUP);
      pair_sync(1);
      float cost, constr;
      action_terms(pp, h.st, nn, j, dt_i, n, h.s_dist, vmax_n[jl],
                   a_limits(pp, n.an), &cost, &constr);
      clk.stamp(F_TERMS);
      const Pick pk = warp_pick(constr, cost, valid);
      clk.stamp(F_PICK);
      const float c_tier = __shfl_sync(FULL, constr, pk.tier);
      const float k_win = __shfl_sync(FULL, cost, pk.k);
      if (lane == 0) {
        float row[N_LC];
        finish_row(tp, pp, T, h.st.cost,
                   pk.nan_c || pk.all_inf ? INFINITY : k_win,
                   pk.nan_c ? NAN : c_tier,
                   axis_point(pp[J_MIN], pp[J_MAX], pk.k, NF - 1), row);
#pragma unroll
        for (int c = 0; c < N_LC; ++c) out[i * N_LC + c] = row[c];
        *win = pk.k;
      }
      pair_sync(2);
    }
    // the next state: the winner's, with its terms
    const int kw = *win;
    tp[LC_T] = tp[LC_T] + dt_i;
    tp[LC_J] = is_last ? tp[LC_J]
                       : axis_point(pp[J_MIN], pp[J_MAX], kw, NF - 1);
    tp[LC_COST] = 0.0f;
    tp[LC_CONSTR] = 0.0f;
    if (i + 1 < T) {
      tp[LC_S] = cb[C_S * NF + kw];
      tp[LC_V] = cb[C_V * NF + kw];
      tp[LC_A] = cb[C_A * NF + kw];
      h.s_dist = cb[C_SDIST * NF + kw];
      h.st.cost = cb[C_COST * NF + kw];
      h.st.constr = cb[C_CONSTR * NF + kw];
    }
    clk.stamp(F_NEXT);
  }
  clk.flush(prof);
}

}  // namespace lon_dp

// dynamic shared memory of a backward block of `tile` s rows, a path of P
// rows, room for a box of `box_cap` floats
extern "C" size_t lon_dp_backward_smem_bytes(int A, int tile, int P,
                                             int box_cap) {
  return lon_dp::backward_smem_bytes(A, tile, P, box_cap);
}

// the threads of that block
extern "C" int lon_dp_backward_threads(int A, int tile) {
  return lon_dp::backward_threads(A, tile);
}

// dynamic shared memory of the forward / reeval block: the path's two
// columns and the distance map staged (the wrapper checks it against the
// block's limit)
extern "C" size_t lon_dp_forward_smem_bytes(int T, int S, int P) {
  return lon_dp::forward_smem_bytes(T, S, P);
}

extern "C" int lon_dp_n_forward_phases() { return lon_dp::N_FWD_PHASE; }

#ifdef __CUDACC__
namespace {
smem_limit::Marks backward_marks, forward_marks[2];

template <bool PROF>
int forward_launch(const float* nodes, const float* pp, const float* path,
                   const float* dist_path, const float* states, float* out,
                   unsigned long long* prof, int T, int S, int V, int A,
                   int P, int n_rows, int mode, void* stream) {
  using namespace lon_dp;
  auto kernel = lon_forward_kernel<PROF>;
  const size_t smem = forward_smem_bytes(T, S, P);
  cudaError_t err = smem_limit::ensure(kernel, smem, forward_marks[PROF]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 2 * WARP, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), pp, path, dist_path, states,
      out, prof, T, S, V, A, P, n_rows, mode);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int lon_dp_n_params() { return lon_dp::N_PP; }

// One backward slice: out (S, V, A, 4) from nodes_next (S, V, A, 4); pp the
// packed parameters, path (P, 7), dist_path (T, S) of which row t_idx is
// read; the final slice (is_last) reads no nodes_next.  A block takes one
// v and `tile` s rows, with room for a box of `box_cap` floats
// (lon_kernel.py backward_plan); the dynamic shared-memory limit is raised
// once per device and size (smem_limit.cuh).
extern "C" int lon_dp_backward(const float* nodes_next, const float* pp,
                               const float* path, const float* dist_path,
                               float* out, int S, int V, int A, int P,
                               int t_idx, int is_last, int tile, int box_cap,
                               void* stream) {
  using namespace lon_dp;
  auto kernel = lon_backward_kernel;
  const size_t smem = backward_smem_bytes(A, tile, P, box_cap);
  cudaError_t err = smem_limit::ensure(kernel, smem, backward_marks);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(V, (S + tile - 1) / tile);
  kernel<<<grid, backward_threads(A, tile), smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes_next), pp, path, dist_path,
      reinterpret_cast<float4*>(out), S, V, A, P, t_idx, is_last != 0, tile,
      box_cap);
  return (int)cudaGetLastError();
}

// The forward pass (mode 0: states is the start state (7,), out (T, 7)) or
// the reeval pass (mode 1: states and out (n_rows, 7)) over the nodes
// (T, S, V, A, 4); the block stages lon_dp_forward_smem_bytes(T, S, P)
// bytes (the wrapper checks that they fit).
extern "C" int lon_dp_forward(const float* nodes, const float* pp,
                              const float* path, const float* dist_path,
                              const float* states, float* out, int T, int S,
                              int V, int A, int P, int n_rows, int mode,
                              void* stream) {
  return forward_launch<false>(nodes, pp, path, dist_path, states, out,
                               nullptr, T, S, V, A, P, n_rows, mode, stream);
}

// The profiling instantiation of the forward pass: the same rows, and per
// phase (lon_dp::FwdPhase) lane 0's cycles added into prof[N_FWD_PHASE].
extern "C" int lon_dp_forward_profile(const float* nodes, const float* pp,
                                      const float* path,
                                      const float* dist_path,
                                      const float* states, float* out,
                                      unsigned long long* prof, int T, int S,
                                      int V, int A, int P, void* stream) {
  return forward_launch<true>(nodes, pp, path, dist_path, states, out, prof,
                              T, S, V, A, P, T, 0, stream);
}

// Loads the kernels onto the current device and raises the backward
// kernel's shared-memory limit to the most a block may use, so that the
// first launch pays for neither (the wrapper calls it when it binds the
// library).  Returns the CUDA error code.
extern "C" int lon_dp_prepare() {
  using namespace lon_dp;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lon_forward_kernel<true>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, lon_forward_kernel<false>);
  if (err == cudaSuccess)
    err = smem_limit::prepare(lon_backward_kernel, backward_marks);
  return (int)err;
}
#endif

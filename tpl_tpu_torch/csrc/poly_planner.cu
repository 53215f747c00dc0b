// The graph DP planner's edge evaluation and cost propagation, for Hopper
// (sm_90a).
//
// Replaces XLA programs and a numpy loop of the JAX package (no Pallas
// kernel): tpl_tpu/planning/dyn_prog/poly_planner_kernel.py
// make_edge_eval's eval_edges (:130-270) and propagate_and_backtrack
// (:275-314).  The reference is poly_planner.cu:11-155 (evalEdge,
// propagateCost, copyTrajectory).
//
// poly_eval_edges: two launches.  The first gathers the directional field
// straight ahead, a contiguous (T, S, L) slice (169 KB at the demo widths,
// which L1 holds, where the (T, S, L, D) field is 3.55 MB and a read of one
// direction is a 32-byte sector of its own).  The second takes one thread
// per edge of a level and a block's copy of the ref line's column 4 in
// shared memory.  The thread reads its start point (8 floats) and end spec
// [t, ds, l], solves the quartic lon fit and the quintic lat fit (float32
// boundary values times the float32 inverses, products summed in index
// order), then integrates steps of 0.25 s: the squared lon and lat jerks
// up to the end time te, the speed, speed-limit (a lerp of column 4) and
// occupancy costs (the field's slice at the step's (t, s, l), rounded half
// to even) up to the end time or, on the last level, the horizon; the
// three sums run in step order.  It writes the end point [t, s, ds, 0, l,
// 0, 0, cost].
//
// The steps are taken in two loops: while ts <= te, the polynomials and
// their jerks; then, on the last level, the linear tail (s from the end
// speed, l and ds constant) while ts <= the horizon.  The plain version
// takes all R steps and adds +0.0 for every term past te (the jerks) or
// past the end of the evaluation (the costs).  Skipping those additions
// keeps the sums' bits: ts grows with the step (t0 + r * 0.25, each
// rounding monotone), so once a step is past te, or past the end, so are
// all later ones; and x + 0.0 == x for every float32 x but -0.0, which no
// sum here holds (each starts at +0.0, and a round-to-nearest sum is -0.0
// only when both terms are).  A NaN te or t0 makes every comparison false:
// no step is taken and no term added, as in the plain version.
//
// What bounds it: the operations of the steps it needs (on the demo graph
// at start index (7, 10) the last level's edges need 25.65 steps each, 19.25
// of them on the polynomial); each step takes eight IEEE divisions.
//
// poly_propagate: one launch for every level and the backtrack.  The
// blocks share the last level (K - 1), a warp a node: the node's edges are
// one contiguous range (its offsets in `seg`); the lanes take them 32
// apart, keeping the least (cost, edge) pair, and a butterfly of shuffles
// reduces the warp.  The order: a NaN cost first (the first NaN, as
// np.argmin), else the least cost, the smaller edge index among equal
// costs; it is a total order of the pairs, so any grouping of the edges
// selects the same one.  Edge costs are read as float64 (the last level's
// float32 end costs, the others' propagated costs), the node's own float32
// cost is raised in float64; a node without edges gets +inf and edge 0.
// Each block then arrives at a counter (a barrier, thread 0's fence, its
// atomic add).  The last block to arrive runs every lower level in turn,
// from K - 2 down to 0, with a barrier between levels: a level of at least
// 8 nodes a warp a node, a smaller one (the root) a node at a time over all
// 256 threads with a reduction across the warps; it reads the propagated
// costs through L2 (__ldcg), then backtracks on one thread and writes the
// (K + 1, 8) float64 trajectory.  It puts the counter back to 0, so a
// counter is allocated once and a CUDA graph replays the launch as it is.
// At the demo widths (eval_steps 2) the lower levels are the root alone; a
// graph of K >= 3 leaves its lower levels to the one last block: correct,
// but not measured.
//
// What bounds it: the last level's costs, one float of each node's 32-byte
// row (400,000 rows, 12.8 MB of sectors at the demo widths, against 1.6 MB
// of costs), then the last block's chain (the root's edges, two
// reductions, the backtrack's loads one level after the other).

// The operations and their order are the plain versions'
// (poly_planner_kernel.eval_edges_reference, propagate_reference), so the
// two agree to float32 rounding of the card's division and the math
// library (none is used past the IEEE operations) and select the same
// edges.  Build with --fmad=false.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include "smem_limit.cuh"

#ifndef __CUDA_ARCH__
// stand-in of the card's intrinsic for a host compile of the bodies
inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof(u));
  return u;
}
#endif

namespace poly_planner_k {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 8;
constexpr float DT_INT = 0.25f;
constexpr unsigned FULL = 0xffffffffu;

// point fields
enum { PP_T, PP_S, PP_DS, PP_DDS, PP_L, PP_DL, PP_DDL, PP_COST };
// the scalars (poly_planner_kernel.EVAL_KEYS)
enum Ev {
  W_J, W_L, W_V_DIFF, LENGTH_VEH, T_HORIZON, REF_STEP, DT_START, DT, S_MIN,
  S_MAX, L_MIN, L_MAX, DIR_MIN, DIR_MAX, N_EV
};
// the profiling instantiation's phases, clock64() cycles summed over the
// edges' threads: the ref column's staging and the two fits, the
// polynomial steps, the steps past te, the two lookups of every step (the
// field's slice and column 4: their indices and loads), the sums and the
// store; then the polynomial steps and the tail steps taken
enum EvalPhase { PE_FIT, PE_POLY, PE_TAIL, PE_LOOKUP, PE_SUMS, N_EVAL_PHASE };
constexpr int N_EVAL_PROF = N_EVAL_PHASE + 2;

struct EvalParams {
  float ev[N_EV];
  float m4[25];  // the quartic's inverse, row-major
  float h5[36];  // the quintic's inverse
};

// each level's first row in the node table and first entry in `seg`
struct Levels {
  int node_off[MAX_LEVELS + 2];
  int seg_off[MAX_LEVELS + 1];
};

// the deriv-th u-derivative of sum_k c[k] u^k: Horner from 0, each
// operation rounded on its own
template <int ORDER, int DERIV>
__device__ __forceinline__ float poly_eval(const float* c, float u) {
  float acc = 0.0f;
#pragma unroll
  for (int k = ORDER; k >= DERIV; --k) {
    float fac = 1.0f;
#pragma unroll
    for (int m = k - DERIV + 1; m <= k; ++m) fac *= (float)m;
    acc = acc * u + c[k] * fac;
  }
  return acc;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// max(0, x), a NaN passing through (jnp.maximum)
__device__ __forceinline__ float max0(float x) {
  return (x > 0.0f || x != x) ? x : 0.0f;
}

// the direction nearest straight ahead (dir_dist_lookup at dir = 0)
__device__ __forceinline__ int straight_ahead(float dir_min, float dir_max,
                                              int D) {
  return (int)clampf(rintf((0.0f - dir_min) / (dir_max - dir_min) *
                           (float)(D - 1)),
                     0.0f, (float)(D - 1));
}

// The field straight ahead: slice[c] = dir_dist[c * D + di] over the n
// cells of (T, S, L).
__global__ void __launch_bounds__(THREADS) field_slice_kernel(
    const float* __restrict__ dir_dist, float* __restrict__ slice,
    float dir_min, float dir_max, int n, int D) {
  const int di = straight_ahead(dir_min, dir_max, D);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n) slice[c] = dir_dist[(size_t)c * D + di];
}

// A thread's clock in the profiling instantiation (nothing otherwise).
template <bool PROF>
struct EdgeClock {
  long long last = 0;
  long long acc[N_EVAL_PHASE] = {};
  unsigned sink = 0;

  __device__ __forceinline__ void start() {
    if constexpr (PROF) last = clock64();
  }
  // waits for a loaded value before the next stamp
  __device__ __forceinline__ void settle(float v) {
    if constexpr (PROF) {
      sink ^= __float_as_uint(v);
#ifdef __CUDA_ARCH__
      asm volatile("" ::"r"(sink));
#endif
    }
  }
  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[phase] += now - last;
      last = now;
    }
  }
};

// the speed limit at s (a lerp of column 4) and the field straight ahead
// at (t, s, l)
__device__ __forceinline__ void step_lookups(
    const float* ev, const float* v_col, const float* field, float ts,
    float s_t, float l_t, float s_span, float l_span, int T, int S, int L,
    int n_ref, float& v_max, float& d_front) {
  const float q = s_t / ev[REF_STEP];
  const float i0 = clampf(floorf(q), 0.0f, (float)(n_ref - 1));
  const int i1 = (int)clampf(ceilf(q), 0.0f, (float)(n_ref - 1));
  const float a = clampf(q - i0, 0.0f, 1.0f);
  v_max = v_col[(int)i0] * (1.0f - a) + v_col[i1] * a;
  const float t_idx = ts < ev[DT_START]
                          ? 0.0f
                          : rintf((ts - ev[DT_START]) / ev[DT]) + 1.0f;
  const int ti = (int)clampf(t_idx, 0.0f, (float)(T - 1));
  const int si = (int)clampf(
      rintf((s_t - ev[S_MIN]) / s_span * (float)(S - 1)), 0.0f,
      (float)(S - 1));
  const int li = (int)clampf(
      rintf((l_t - ev[L_MIN]) / l_span * (float)(L - 1)), 0.0f,
      (float)(L - 1));
  d_front = field[(ti * S + si) * L + li];
}

// a step's speed, speed-limit and occupancy costs
__device__ __forceinline__ float step_cost(const float* ev, float ds_t,
                                           float v_max, float d_front) {
  float cost = ev[W_V_DIFF] * fabsf(100.0f - ds_t);
  cost = cost + 100.0f * max0(ds_t - v_max);
  const float d_safety = d_front - ev[LENGTH_VEH] * 0.5f - 1.0f - ds_t * 1.0f;
  const float x = ds_t * DT_INT;
  return cost + (x > d_safety ? 100.0f * (x - d_safety) : 0.0f);
}

// `field` the (T, S, L) slice straight ahead; dynamic shared memory: n_ref
// floats (column 4 of the ref line).  PROF adds each phase's cycles and
// the steps taken into prof[N_EVAL_PROF].
template <bool PROF>
__global__ void __launch_bounds__(THREADS) eval_edges_kernel(
    const float* __restrict__ start_pts, const int* __restrict__ edge_starts,
    const float* __restrict__ end_specs, const float* __restrict__ field,
    const float* __restrict__ ref_line, float* __restrict__ out,
    unsigned long long* __restrict__ prof, const EvalParams p, int E,
    int is_last, int R, int T, int S, int L, int n_ref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* v_col = reinterpret_cast<float*>(smem_raw);
  EdgeClock<PROF> clk;
  clk.start();
  for (int i = threadIdx.x; i < n_ref; i += blockDim.x)
    v_col[i] = ref_line[(size_t)i * 8 + 4];
  __syncthreads();
  long long n_poly = 0, n_tail = 0;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < E) {
    const float* ev = p.ev;
    const float4* sp4 = reinterpret_cast<const float4*>(start_pts) +
                        (size_t)edge_starts[e] * 2;
    const float4 sa = sp4[0], sb = sp4[1];
    const float t0 = sa.x, s0 = sa.y, ds0 = sa.z, dds0 = sa.w;
    const float l0 = sb.x, dl0 = sb.y, ddl0 = sb.z;
    const float te = end_specs[(size_t)e * 3];
    const float dse = end_specs[(size_t)e * 3 + 1];
    const float le = end_specs[(size_t)e * 3 + 2];
    const float d = te - t0;

    const float bl[5] = {s0, ds0 * d, dds0 * d * d, dse * d, 0.0f};
    const float bt[6] = {l0, dl0 * d, ddl0 * d * d, le, 0.0f, 0.0f};
    float cl[5], ct[6];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      float acc = bl[0] * p.m4[m * 5];
#pragma unroll
      for (int k = 1; k < 5; ++k) acc = acc + bl[k] * p.m4[m * 5 + k];
      cl[m] = acc;
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      float acc = bt[0] * p.h5[m * 6];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + bt[k] * p.h5[m * 6 + k];
      ct[m] = acc;
    }
    const float d3 = d * (d * d);
    const float s_end = poly_eval<4, 0>(cl, 1.0f);
    const float ds_end = poly_eval<4, 1>(cl, 1.0f) / d;
    const float l_end = poly_eval<5, 0>(ct, 1.0f);
    const float t_end_eval = is_last ? ev[T_HORIZON] : te;
    const float s_span = ev[S_MAX] - ev[S_MIN];
    const float l_span = ev[L_MAX] - ev[L_MIN];
    clk.stamp(PE_FIT);

    float j_lon = 0.0f, j_lat = 0.0f, steps = 0.0f;
    float v_max, d_front;
    int r = 0;
    // on the polynomials: ts <= te
    for (; r < R; ++r) {
      const float ts = t0 + (float)r * DT_INT;
      if (!(ts <= te)) break;
      const float u = clampf((ts - t0) / d, 0.0f, 1.0f);
      const float jl = poly_eval<4, 3>(cl, u) / d3;
      const float jt = poly_eval<5, 3>(ct, u) / d3;
      j_lon = j_lon + jl * jl;
      j_lat = j_lat + jt * jt;
      const float ds_t = poly_eval<4, 1>(cl, u) / d;
      const float s_t = poly_eval<4, 0>(cl, u);
      const float l_t = poly_eval<5, 0>(ct, u);
      clk.stamp(PE_POLY);
      step_lookups(ev, v_col, field, ts, s_t, l_t, s_span, l_span, T, S, L,
                   n_ref, v_max, d_front);
      clk.settle(v_max);
      clk.settle(d_front);
      clk.stamp(PE_LOOKUP);
      const float cost = step_cost(ev, ds_t, v_max, d_front);
      steps = steps + (ts <= t_end_eval ? cost : 0.0f);
      clk.stamp(PE_POLY);
      if (PROF) ++n_poly;
    }
    // past te, up to the end of the evaluation: the linear tail
    for (; r < R; ++r) {
      const float ts = t0 + (float)r * DT_INT;
      if (!(ts <= t_end_eval)) break;
      const float s_t = s_end + (ts - te) * ds_end;
      clk.stamp(PE_TAIL);
      step_lookups(ev, v_col, field, ts, s_t, l_end, s_span, l_span, T, S,
                   L, n_ref, v_max, d_front);
      clk.settle(v_max);
      clk.settle(d_front);
      clk.stamp(PE_LOOKUP);
      steps = steps + step_cost(ev, ds_end, v_max, d_front);
      clk.stamp(PE_TAIL);
      if (PROF) ++n_tail;
    }
    float c = ev[W_J] * j_lon;
    c = c + ev[W_J] * j_lat;
    c = c + ev[W_L] * fabsf(0.0f - le);
    c = c + steps;
    float4* o = reinterpret_cast<float4*>(out) + (size_t)e * 2;
    o[0] = make_float4(te, s_end, dse, 0.0f);
    o[1] = make_float4(le, 0.0f, 0.0f, c);
    clk.stamp(PE_SUMS);
  }
  if constexpr (PROF) {
    long long v[N_EVAL_PROF];
    for (int i = 0; i < N_EVAL_PHASE; ++i) v[i] = clk.acc[i];
    v[N_EVAL_PHASE] = n_poly;
    v[N_EVAL_PHASE + 1] = n_tail;
    for (int i = 0; i < N_EVAL_PROF; ++i) {
      long long x = v[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(FULL, x, off);
      if (threadIdx.x % 32 == 0)
        atomicAdd(prof + i, (unsigned long long)x);
    }
  }
}

// (c, i) before (bc, bi): a NaN first (the smaller index among NaNs), else
// the smaller cost, the smaller index among equal costs
__device__ __forceinline__ bool before(double c, int i, double bc, int bi) {
  const bool cn = c != c, bn = bc != bc;
  if (cn || bn) return cn && (!bn || i < bi);
  return c < bc || (c == bc && i < bi);
}

// the propagation's phases, thread 0's clock64() cycles summed over the
// blocks: the last level, the arrival; the lower levels and the backtrack
// (the last block only)
enum PropPhase { PH_LAST, PH_ARRIVE, PH_LOWER, PH_BACKTRACK, N_PROP_PHASE };

// the propagation's shared memory: the warps' pairs, the last-arrival flag
struct PropShared {
  double bc[WARPS];
  int bi[WARPS];
  int last;
};

// thread 0's clock in the profiling instantiation (nothing otherwise)
template <bool PROF>
struct BlockClock {
  long long last = 0;
  long long acc[N_PROP_PHASE] = {};

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
        for (int i = 0; i < N_PROP_PHASE; ++i)
          if (acc[i]) atomicAdd(prof + i, (unsigned long long)acc[i]);
    }
  }
};

// the least (cost, edge) pair of edges [lo, hi) of a level whose end nodes
// start at row b, from lo + first on, `stride` apart, into (bc, bi).  A
// lower level's propagated costs are read four at a time, so that a
// thread's loads from L2 overlap (the order of the compares is free); the
// last level's reads are bound by their sectors, one a node's row, and
// four at a time there measured slower.
template <bool LAST>
__device__ __forceinline__ void scan_edges(const float* pts,
                                           const double* node_cost, int b,
                                           int lo, int hi, int first,
                                           int stride, double& bc, int& bi) {
  int j = lo + first;
  if constexpr (!LAST) {
    for (; j + 3 * stride < hi; j += 4 * stride) {
      double c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) c[u] = __ldcg(node_cost + b + j + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (before(c[u], j + u * stride, bc, bi)) {
          bc = c[u];
          bi = j + u * stride;
        }
    }
  }
  for (; j < hi; j += stride) {
    const double c = LAST ? (double)pts[(size_t)(b + j) * 8 + PP_COST]
                          : __ldcg(node_cost + b + j);
    if (before(c, j, bc, bi)) {
      bc = c;
      bi = j;
    }
  }
}

__device__ __forceinline__ void warp_least(double& bc, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double oc = __shfl_xor_sync(FULL, bc, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (before(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
}

// node `node`'s propagated cost and edge from its least pair
__device__ __forceinline__ void settle(const float* pts, double* node_cost,
                                       int* best, int node, double bc,
                                       int bi) {
  if (bi == INT_MAX) {  // no edge
    bc = INFINITY;
    bi = 0;
  }
  node_cost[node] = (double)pts[(size_t)node * 8 + PP_COST] + bc;
  best[node] = bi;
}

// level k's nodes from `first` on, `step` apart, a warp each
template <bool LAST>
__device__ __forceinline__ void level_by_warps(
    const float* pts, double* node_cost, int* best, const int* seg,
    const Levels& lv, int k, int first, int step) {
  const int lane = threadIdx.x % 32;
  const int a = lv.node_off[k], b = lv.node_off[k + 1];
  const int* sg = seg + lv.seg_off[k];
  for (int i = first; i < b - a; i += step) {
    double bc = INFINITY;
    int bi = INT_MAX;
    scan_edges<LAST>(pts, node_cost, b, sg[i], sg[i + 1], lane, 32, bc, bi);
    warp_least(bc, bi);
    if (lane == 0) settle(pts, node_cost, best, a + i, bc, bi);
  }
}

// level k's nodes one after the other, each over the block's threads
__device__ __forceinline__ void level_by_block(
    const float* pts, double* node_cost, int* best, const int* seg,
    const Levels& lv, int k, PropShared& sh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = lv.node_off[k], b = lv.node_off[k + 1];
  const int* sg = seg + lv.seg_off[k];
  for (int i = 0; i < b - a; ++i) {
    double bc = INFINITY;
    int bi = INT_MAX;
    scan_edges<false>(pts, node_cost, b, sg[i], sg[i + 1], threadIdx.x,
                      THREADS, bc, bi);
    warp_least(bc, bi);
    if (lane == 0) {
      sh.bc[warp] = bc;
      sh.bi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bc = lane < WARPS ? sh.bc[lane] : INFINITY;
      bi = lane < WARPS ? sh.bi[lane] : INT_MAX;
      warp_least(bc, bi);
      if (lane == 0) settle(pts, node_cost, best, a + i, bc, bi);
    }
    __syncthreads();
  }
}

// A launch of ceil(n / WARPS) blocks of THREADS for the last level's n
// nodes (one block when n is 0); `node_cost` and `best` are read back by
// the last block (so neither is const __restrict__); `counter` is 0 at the
// launch and again at its end.
template <bool PROF>
__global__ void __launch_bounds__(THREADS) propagate_kernel(
    const float* __restrict__ pts, double* node_cost, int* best,
    const int* __restrict__ seg, double* __restrict__ traj, int* counter,
    unsigned long long* __restrict__ prof, const Levels lv, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PropShared& sh = *reinterpret_cast<PropShared*>(smem_raw);
  BlockClock<PROF> clk;
  clk.start();
  const int warp = threadIdx.x / 32;
  level_by_warps<true>(pts, node_cost, best, seg, lv, K - 1,
                       blockIdx.x * WARPS + warp, gridDim.x * WARPS);
  clk.stamp(PH_LAST);

  // the arrival (as a grid barrier does it): the block's barrier, then
  // thread 0's fence orders the block's writes before its count, and in the
  // last block its second fence the count before the block's reads
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    if (last) {
      *counter = 0;
      __threadfence();
    }
    sh.last = last;
  }
  __syncthreads();
  clk.stamp(PH_ARRIVE);
  if (!sh.last) {
    clk.flush(prof);
    return;
  }

  // the last block: the lower levels, then the backtrack
  for (int k = K - 2; k >= 0; --k) {
    if (lv.node_off[k + 1] - lv.node_off[k] >= WARPS)
      level_by_warps<false>(pts, node_cost, best, seg, lv, k, warp, WARPS);
    else
      level_by_block(pts, node_cost, best, seg, lv, k, sh);
    __syncthreads();
  }
  clk.stamp(PH_LOWER);
  if (threadIdx.x == 0) {
    for (int c = 0; c < 8; ++c) traj[c] = (double)pts[c];
    traj[PP_COST] = __ldcg(node_cost);
    // node r's edge is loaded beside its row, so each level waits on one
    // round of loads
    int idx = __ldcg(best);
    for (int kk = 0; kk < K; ++kk) {
      const int r = lv.node_off[kk + 1] + idx;
      const int next = kk + 1 < K ? __ldcg(best + r) : 0;
      double* row = traj + (kk + 1) * 8;
      for (int c = 0; c < 8; ++c) row[c] = (double)pts[(size_t)r * 8 + c];
      if (kk + 1 < K) row[PP_COST] = __ldcg(node_cost + r);
      idx = next;
    }
  }
  clk.stamp(PH_BACKTRACK);
  clk.flush(prof);
}

}  // namespace poly_planner_k

#ifdef __CUDACC__
namespace {

// the evaluation's dynamic shared-memory limit, raised once per device and
// size (smem_limit.cuh), for each instantiation
smem_limit::Marks eval_marks[2];

template <bool PROF>
int eval_launch(const float* start_pts, const int* edge_starts,
                const float* end_specs, const float* dir_dist,
                const float* ref_line, float* slice, float* out,
                unsigned long long* prof, const float* consts, int E,
                int is_last, int R, int T, int S, int L, int D, int n_ref,
                void* stream) {
  using namespace poly_planner_k;
  if (E < 0 || R < 1 || T < 1 || S < 1 || L < 1 || D < 1 || n_ref < 1 ||
      (size_t)T * S * L > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  EvalParams p;
  memcpy(p.ev, consts, sizeof(p.ev));
  memcpy(p.m4, consts + N_EV, sizeof(p.m4));
  memcpy(p.h5, consts + N_EV + 25, sizeof(p.h5));
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = T * S * L;
  field_slice_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      dir_dist, slice, p.ev[DIR_MIN], p.ev[DIR_MAX], n, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = eval_edges_kernel<PROF>;
  const size_t smem = (size_t)n_ref * sizeof(float);
  err = smem_limit::ensure(kernel, smem, eval_marks[PROF]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(E + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      start_pts, edge_starts, end_specs, slice, ref_line, out, prof, p, E,
      is_last, R, T, S, L, n_ref);
  return (int)cudaGetLastError();
}

template <bool PROF>
int propagate_launch(const float* pts, double* node_cost, int* best,
                     const int* seg, double* traj, const int* offs,
                     int* counter, unsigned long long* prof, int K,
                     void* stream) {
  using namespace poly_planner_k;
  if (K < 1 || K > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  memcpy(lv.node_off, offs, sizeof(lv.node_off));
  memcpy(lv.seg_off, offs + MAX_LEVELS + 2, sizeof(lv.seg_off));
  const int n = lv.node_off[K] - lv.node_off[K - 1];
  const int blocks = n > 0 ? (n + WARPS - 1) / WARPS : 1;
  propagate_kernel<PROF><<<blocks, THREADS, sizeof(PropShared),
                           (cudaStream_t)stream>>>(
      pts, node_cost, best, seg, traj, counter, prof, lv, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int poly_planner_n_eval_params() { return poly_planner_k::N_EV; }
extern "C" int poly_planner_max_levels() { return poly_planner_k::MAX_LEVELS; }
extern "C" int poly_planner_n_eval_prof() {
  return poly_planner_k::N_EVAL_PROF;
}
extern "C" int poly_planner_n_prop_phases() {
  return poly_planner_k::N_PROP_PHASE;
}

// One level's end points (E, 8) float32 from its start points, its edges'
// start indices (E,) int32 and end specs (E, 3), the directional field
// (T, S, L, D) and the ref line (n_ref, 8); `slice` is scratch of T x S x L
// floats (the field straight ahead); `consts` (host) holds the scalars of
// EVAL_KEYS, then the quartic's and the quintic's inverses.  Two launches
// (the slice, the evaluation); none for E = 0.
extern "C" int poly_eval_edges(const float* start_pts, const int* edge_starts,
                               const float* end_specs, const float* dir_dist,
                               const float* ref_line, float* slice,
                               float* out, const float* consts, int E,
                               int is_last, int R, int T, int S, int L, int D,
                               int n_ref, void* stream) {
  return eval_launch<false>(start_pts, edge_starts, end_specs, dir_dist,
                            ref_line, slice, out, nullptr, consts, E,
                            is_last, R, T, S, L, D, n_ref, stream);
}

// the profiling instantiation: the same end points, and per phase
// (poly_planner_k::EvalPhase) the edges' clock64() cycles, then the
// polynomial and the tail steps taken, added into prof[N_EVAL_PROF]
extern "C" int poly_eval_edges_profile(
    const float* start_pts, const int* edge_starts, const float* end_specs,
    const float* dir_dist, const float* ref_line, float* slice, float* out,
    unsigned long long* prof, const float* consts, int E, int is_last, int R,
    int T, int S, int L, int D, int n_ref, void* stream) {
  return eval_launch<true>(start_pts, edge_starts, end_specs, dir_dist,
                           ref_line, slice, out, prof, consts, E, is_last, R,
                           T, S, L, D, n_ref, stream);
}

// The propagation and the backtrack in one launch: every node's float64
// propagated cost (`node_cost`) and edge (`best`) of levels 0..K-1 and the
// (K + 1, 8) float64 trajectory (`traj`); `offs` (host): the node offsets
// (K + 2), then from MAX_LEVELS + 2 on the seg offsets (K + 1); `counter`
// one int that is 0 (the launch leaves it 0).
extern "C" int poly_propagate(const float* pts, double* node_cost, int* best,
                              const int* seg, double* traj, const int* offs,
                              int* counter, int K, void* stream) {
  return propagate_launch<false>(pts, node_cost, best, seg, traj, offs,
                                 counter, nullptr, K, stream);
}

// the profiling instantiation: the same results, and per phase
// (poly_planner_k::PropPhase) thread 0's cycles added into
// prof[N_PROP_PHASE]
extern "C" int poly_propagate_profile(const float* pts, double* node_cost,
                                      int* best, const int* seg,
                                      double* traj, const int* offs,
                                      int* counter, unsigned long long* prof,
                                      int K, void* stream) {
  return propagate_launch<true>(pts, node_cost, best, seg, traj, offs,
                                counter, prof, K, stream);
}

// Loads the five kernels onto the current device and sets the evaluation's
// shared-memory limits, so that a replan's first launches pay for neither
// (the wrapper calls it when it binds the library).  Returns the CUDA
// error code.
extern "C" int poly_planner_prepare() {
  using namespace poly_planner_k;
  cudaError_t err = smem_limit::prepare(eval_edges_kernel<false>,
                                        eval_marks[0]);
  if (err == cudaSuccess)
    err = smem_limit::prepare(eval_edges_kernel<true>, eval_marks[1]);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, field_slice_kernel);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, propagate_kernel<false>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, propagate_kernel<true>);
  return (int)err;
}
#endif

// Lateral candidate sweep and selection of the poly-lat / lon-DP planner
// chain, for Hopper (sm_90a): one launch.
//
// Replaces two XLA programs of the JAX package (no Pallas kernel):
// tpl_tpu/planning/dyn_prog/poly_lat_kernel.py make_poly_lat_kernel's
// `evaluate` (:121-223) and poly_chain_kernel.py `select_path_device`
// (:78-113).  The reference is poly_lat_planner.cu.
//
// poly_lat_sweep_select, the sweep: one block per (l_dst, s_dst) candidate, a
// thread per lateral sample (S = 201 at the demo set).  Six threads form the
// candidate's quintic coefficients; every sample evaluates the quintic (l and
// its three derivatives), the reference line at its station, the cartesian
// point, curvature, speed limit, constraint and cost, then its segment time;
// the segment times are summed into path times, S - 1 dependent additions on
// the block's last thread (the order of the plain version's cumsum: the
// collision lookups round the times, so they keep their bits), while the
// block's warps reduce the costs and the other threads form their samples'
// occupancy indices but the time's; then each sample looks up the occupancy
// grid 9 times (3 time offsets x 3 lateral offsets) and the block's warps
// reduce the collision stations to their least.  A NaN is kept where the plain
// version keeps it (torch.maximum of the occupancy cells, so that a NaN cell
// is no collision; torch.amin of the stations; torch.clamp / torch.maximum /
// torch.minimum of the speed limit, the constraints and the segment times, so
// that a NaN lane bound makes the candidate's cost NaN; nan_minmax.cuh), and
// dropped where it would form an index.  Dtypes are the JAX program's: the
// float64 Hermite inverse promotes the quintics, the geometry and the cost to
// float64 (the JAX package runs with x64 on); the reference line lookup, the
// stations and the occupancy's s index stay float32, and so does the collision
// distance.  What bounds it: the dependent time sum (a float64 add chain of S
// steps) and the float64 arithmetic, not bytes: the sweep reads a few hundred
// reference rows and at most the 2.6 MB occupancy grid, and writes 12 bytes a
// candidate.

// The selection: every block, once it has written its candidate's cd and
// tc, arrives at a counter (a block barrier, thread 0's fence and atomic
// add); the last block to arrive puts the counter back to 0 (so that a CUDA
// graph replays the launch as it is), stages every candidate's cd and
// (float)tc in shared memory, read back through L2, and takes the two
// order-dependent passes of the JAX fori_loops: flat (il, isd) order, every
// value and comparison in float32, the first update from index
// min(LD / 2 + 1, LD - 1) * SD + SD - 1.  The passes are serial chains of
// compares, which one thread walked over L2 in an earlier design (a launch
// of its own and two dependent chains of L2 loads).  Here a warp tests 32
// candidates' update conditions against the current state at once and takes
// a ballot: the lowest set lane is the next update of the serial pass; the
// warp takes its value, re-tests the lanes after it against the new state,
// and moves to the next 32 once no lane is set.  Each step depends on the
// state alone, so the updates are the serial pass's, bit for bit (a NaN
// compares false, ties keep the first).  A one-thread scan of the staged
// values measured slower on an NVIDIA H100 80GB HBM3 (700 W): the launch
// took 0.0110 ms with it against 0.0097 with the lanes at the FAS loop's
// 1 x 20 candidates, and 0.0357 against 0.0195 at the lattice loop's
// 21 x 13, from CUDA graphs (chip_smoke.py).  The staged values take 8
// bytes a candidate over the sweep's region (5 S doubles), so a launch
// takes at most MAX_CANDIDATES; past 5 S candidates (1005 at S = 201)
// every block reserves the larger region.  Staging a chunk at a time
// instead, with no cap, cost 0.0003-0.0007 ms a launch at both loops'
// grids on the same card (chip_smoke.py --parent-csrc, in turns).
//
// The operations and their order follow the plain versions
// (tpl_tpu_torch/planning/dyn_prog/poly_lat_kernel.py evaluate_reference,
// select_reference).  Two sums are taken in another order than the plain
// version's library calls (the 6-term coefficient products, which the plain
// version makes with a matrix product, and the cost sum, a tree here), and
// sinf / cosf come from another math library, so the cost agrees with its
// plain version to rounding (the collision distance bit for bit).  Build
// with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "nan_minmax.cuh"

namespace poly_lat {

using nan_minmax::max_nan;
using nan_minmax::min_nan;

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int ORDER = 5;        // quintic
constexpr int NC = ORDER + 1;
constexpr int MAX_SAMPLES = 900;   // shared memory under 48 KB
constexpr int PER_THREAD = (MAX_SAMPLES + THREADS - 1) / THREADS;
constexpr int REF_CH = 8;       // reference line channels
// candidates of one launch, at most: their staged selection values, 8
// bytes each, and a block's sweep region of 900 samples stay within the
// 48 KB a block has without opting in
constexpr int MAX_CANDIDATES = 4096;

// the packed parameter vectors (poly_lat_kernel.py PL_PP_KEYS, ENV_PP_KEYS)
enum Pp {
  L_MIN, L_MAX, S_MIN, S_MAX, L_DST_MIN, L_DST_MAX, S_DST_MIN, S_DST_MAX,
  L_TRG, W_L, W_K, W_DL, W_DDL, W_DDDL, W_RIGHT, W_LEN, K_ABS_MAX,
  A_LAT_ABS_MAX, WIDTH_VEH, LENGTH_VEH, N_PP
};
enum EnvPp { E_DT_START, E_DT, E_S_MIN, E_S_MAX, E_L_MIN, E_L_MAX, N_ENV };
// reference line channels
enum { RL_X, RL_Y, RL_H, RL_K, RL_V, RL_DL, RL_DR };

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

__device__ __forceinline__ double clampd(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

// k! / (k - d)!
__device__ __forceinline__ double falling(int k, int d) {
  double f = 1.0;
  for (int m = k - d + 1; m <= k; ++m) f *= (double)m;
  return f;
}

// the d-th u-derivative of the series c at u (Horner)
__device__ __forceinline__ double horner(const double (&c)[NC], double u,
                                         int d) {
  double acc = 0.0;
  for (int k = ORDER; k >= d; --k) acc = acc * u + c[k] * falling(k, d);
  return acc;
}

// the bytes of the block's region that holds per sample l, x, y, v, t
// (double) during the sweep, and in the last block every candidate's cd and
// (float)tc
__host__ __device__ inline size_t region_bytes(int S, int n) {
  const size_t sweep = (size_t)S * 5 * sizeof(double);
  const size_t select = ((size_t)n * 2 * sizeof(float) + 7) / 8 * 8;
  return sweep > select ? sweep : select;
}

__host__ __device__ inline size_t sweep_smem_bytes(int S, int n) {
  // the coefficients, a partial cost sum a warp, the region, a collision
  // station a warp and the last block's flag
  return sizeof(double) * (NC + WARPS) + region_bytes(S, n)
         + sizeof(float) * WARPS + sizeof(int);
}

// the phases of the profiling instantiation, in the order poly_lat_kernel.py
// SWEEP_PHASES names them: thread 0's clock64() cycles (the selection's in
// the last block only)
enum Phase { P_COEF, P_SAMPLES, P_SEGMENTS, P_TIMES, P_COLLISION, P_REDUCE,
             P_ARRIVE, P_SELECT, N_PHASE };

template <bool PROF>
struct BlockClock {
  long long last = 0;
  long long acc[N_PHASE] = {};

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
        for (int i = 0; i < N_PHASE; ++i)
          if (acc[i]) atomicAdd(prof + i, (unsigned long long)acc[i]);
    }
  }
};

// The selection's two passes over the staged values c (cd) and t ((float)tc)
// of n candidates, on the 32 lanes of a warp (see the header): the winner's
// flat index and its cost on every lane.
__device__ __forceinline__ void select_lanes(const float* c_s,
                                             const float* t_s, int n,
                                             int init, float lv, int lane,
                                             int* best_out,
                                             float* cost_out) {
  const unsigned FULL = 0xffffffffu;
  float max_cd = c_s[init];
  for (int base = 0; base < n; base += WARP) {
    const int i = base + lane;
    const bool in = i < n;
    const float c = in ? c_s[i] : 0.0f;
    const bool feasible = in && t_s[i] < 1e6f;
    unsigned m = __ballot_sync(FULL, feasible && c > max_cd + lv);
    while (m) {
      const int k = __ffs(m) - 1;
      max_cd = __shfl_sync(FULL, c, k);
      m = __ballot_sync(FULL, lane > k && feasible && c > max_cd + lv);
    }
  }
  float min_cost = INFINITY;
  int best = init;
  for (int base = 0; base < n; base += WARP) {
    const int i = base + lane;
    const bool in = i < n;
    const float c = in ? c_s[i] : 0.0f;
    const float t = in ? t_s[i] : 0.0f;
    unsigned m = __ballot_sync(
        FULL, in && fabsf(c - max_cd) <= 1.0f && t < min_cost);
    while (m) {
      const int k = __ffs(m) - 1;
      max_cd = __shfl_sync(FULL, c, k);
      min_cost = __shfl_sync(FULL, t, k);
      best = base + k;
      m = __ballot_sync(FULL, lane > k && in && fabsf(c - max_cd) <= 1.0f
                                  && t < min_cost);
    }
  }
  *best_out = best;
  *cost_out = min_cost;
}

// The selection on a block: every candidate's cd and (float)tc, read through
// L2, staged in `stage` (2 LD SD floats of shared memory), then the two
// passes on warp 0's lanes; thread 0 writes the winner's flat index and its
// cost.
__device__ __forceinline__ void select_block(const float* cd,
                                             const double* tc, int LD,
                                             int SD, float lv, float* stage,
                                             long long* best_out,
                                             float* cost_out) {
  const int n = LD * SD, tid = threadIdx.x;
  float* c_s = stage;
  float* t_s = stage + n;
  for (int i = tid; i < n; i += blockDim.x) {
    c_s[i] = __ldcg(cd + i);
    t_s[i] = (float)__ldcg(tc + i);
  }
  __syncthreads();
  const int init_l = LD / 2 + 1 < LD - 1 ? LD / 2 + 1 : LD - 1;
  const int init = init_l * SD + SD - 1;
  int best = init;
  float min_cost = INFINITY;
  if (tid < WARP) select_lanes(c_s, t_s, n, init, lv, tid, &best, &min_cost);
  if (tid == 0) {
    *best_out = best;
    *cost_out = min_cost;
  }
}

// A block per candidate, a thread per sample (S <= THREADS at the demo
// sets; more samples take turns).  The quintic's six coefficients are formed
// once, by six threads; each sample's evaluation and segment time as
// before; the path times are the running sum of the segment times on
// thread 0 in the plain version's order (the chain's sums stay in a
// register; the loads of the segment times run ahead of it); the cost sum
// and the least collision station are a block's warp reductions.  Then the
// arrival, and in the last block the selection (the header).  cd_out and
// tc_out are written here and, in the last block, read back: no
// __restrict__ on them.
template <bool PROF>
__global__ void __launch_bounds__(THREADS)
poly_lat_sweep_kernel(const float* __restrict__ occ,
                      const float* __restrict__ ref_line,
                      const float* __restrict__ ref_step_p,
                      const float* __restrict__ pp_in,
                      const float* __restrict__ env_in,
                      const float* __restrict__ start,
                      const double* __restrict__ hermite_inv, float* cd_out,
                      double* tc_out, long long* __restrict__ best_out,
                      float* __restrict__ cost_out, int* __restrict__ counter,
                      unsigned long long* __restrict__ prof, int LD, int SD,
                      int S, int TE, int SE, int LE, int n_ref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_cand = LD * SD;
  double* coef = reinterpret_cast<double*>(smem_raw);   // (NC,)
  double* w_cost = coef + NC;                            // (WARPS,)
  double* sl = w_cost + WARPS;                           // the region
  double* sx = sl + S;
  double* sy = sx + S;
  double* sv = sy + S;
  double* st = sv + S;
  float* w_coll = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sl) + region_bytes(S, n_cand));
  int* flag = reinterpret_cast<int*>(w_coll + WARPS);

  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), warp = tid / WARP;
  const int cand = blockIdx.x;
  const int il = cand / SD, isd = cand % SD;
  BlockClock<PROF> clk;
  clk.start();
  float pp[N_PP], ep[N_ENV];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  for (int k = 0; k < N_ENV; ++k) ep[k] = env_in[k];
  const float l0 = start[0], dl0 = start[1], ddl0 = start[2], s0 = start[3];
  const float v0 = start[4];
  const float ref_step = *ref_step_p;

  const float l_dst = axis_point(pp[L_DST_MIN], pp[L_DST_MAX], il,
                                 LD - 1 > 1 ? LD - 1 : 1);
  const float s_dst = axis_point(pp[S_DST_MIN], pp[S_DST_MAX], isd,
                                 SD - 1 > 1 ? SD - 1 : 1);
  const float s_step = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
  const float s_base = s0 + pp[S_MIN];
  const float s_end = s0 + s_dst;

  // the quintic from its boundary values (PolyQuintic): b scaled by d^k,
  // c[m] = sum_k b[k] inv[m][k] on thread m
  const float d = s_end - s0;
  if (tid < NC) {
    const float b[NC] = {l0, dl0 * d, ddl0 * (d * d), l_dst, 0.0f * d,
                         0.0f * (d * d)};
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      acc += (double)b[k] * hermite_inv[tid * NC + k];
    coef[tid] = acc;
  }
  __syncthreads();
  double c[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) c[m] = coef[m];
  clk.stamp(P_COEF);
  const double d1 = (double)d, d2 = (double)(d * d);
  const double d3 = (double)(d * (d * d));
  const double margin = (double)(pp[WIDTH_VEH] * 0.5f) * sqrt(2.0);
  const float a_lat = pp[A_LAT_ABS_MAX];

  double cost_part = 0.0;
  for (int i = tid; i < S; i += blockDim.x) {
    const float s = fma32((float)i, s_step, s_base);
    const double u = (double)((s - s0) / d);
    const bool past_end = s >= s_end;
    const double l = past_end ? (double)l_dst : horner(c, u, 0);
    const double dl = past_end ? 0.0 : horner(c, u, 1) / d1;
    const double ddl = past_end ? 0.0 : horner(c, u, 2) / d2;
    const double dddl = past_end ? 0.0 : horner(c, u, 3) / d3;

    // the reference line at s (RefLine::lerp, float32)
    const float q = s / ref_step;
    const float i0f = clampf(floorf(q), 0.0f, (float)(n_ref - 1));
    const float i1f = clampf(ceilf(q), 0.0f, (float)(n_ref - 1));
    const float w = clampf(q - i0f, 0.0f, 1.0f);
    const float* r0 = ref_line + (size_t)(int)i0f * REF_CH;
    const float* r1 = ref_line + (size_t)(int)i1f * REF_CH;
    float rp[7];
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) rp[ch] = r0[ch] * (1.0f - w) + r1[ch] * w;

    const double hf = atan(dl);
    const double x = (double)rp[RL_X] - (double)sinf(rp[RL_H]) * l;
    const double y = (double)rp[RL_Y] + (double)cosf(rp[RL_H]) * l;
    const double rk = (double)rp[RL_K];
    const double k = ((ddl / (dl * dl + 1.0) + rk) * cos(hf)) / (1.0 - l * rk);
    const double ak = fabs(k);
    const double k_abs_path = max_nan(ak, (double)fabsf(rp[RL_K]));
    const double rv = (double)rp[RL_V];
    const double v = k_abs_path > 1e-6
        ? min_nan(rv, sqrt((double)a_lat / max_nan(k_abs_path, 1e-9)))
        : rv;

    // local constraints (poly_lat_planner.cu:64-76)
    const float mv = min_nan(rp[RL_V], v0);
    double constr = max_nan((double)(mv * mv) * ak - (double)a_lat, 0.0);
    const bool in_poly = s <= s_end;
    constr = constr
        + (in_poly ? max_nan(ak - (double)pp[K_ABS_MAX], 0.0) : 0.0);
    constr = constr
        + (in_poly ? max_nan(l - ((double)rp[RL_DL] - margin), 0.0) : 0.0);
    constr = constr
        + (in_poly ? max_nan((-(double)rp[RL_DR] + margin) - l, 0.0) : 0.0);
    // local cost (poly_lat_planner.cu:78-92)
    double cost = ((double)pp[W_DL] * (dl * dl) + (double)pp[W_DDL] * (ddl * ddl))
        + (double)pp[W_DDDL] * (dddl * dddl);
    cost = cost + (ak > (double)fabsf(rp[RL_K]) ? (double)pp[W_K] * (k * k) : 0.0);
    cost = cost + 10e6 * constr;

    sl[i] = l;
    sx[i] = x;
    sy[i] = y;
    sv[i] = v;
    cost_part = cost_part + cost;
  }
  __syncthreads();
  clk.stamp(P_SAMPLES);

  // the segment times (poly_lat_planner.cu:102-148)
  for (int i = 1 + tid; i < S; i += blockDim.x) {
    const double dx = sx[i] - sx[i - 1];
    const double dy = sy[i] - sy[i - 1];
    st[i] = sqrt(dx * dx + dy * dy) / max_nan(sv[i], 1.0);
  }
  // the cost sum: each warp's, then warp 0 adds the warps' (an order other
  // than the plain version's sum, to rounding)
#pragma unroll
  for (int o = WARP / 2; o > 0; o /= 2)
    cost_part = cost_part + __shfl_xor_sync(0xffffffffu, cost_part, o);
  if (lane == 0) w_cost[warp] = cost_part;
  __syncthreads();
  clk.stamp(P_SEGMENTS);
  // their running sum, in order, on the block's last thread (which holds
  // no sample at the demo set's S = 201); meanwhile the other threads form
  // what their samples' occupancy lookups need besides the time: the s
  // index and the three lateral indices
  if (tid == (int)blockDim.x - 1) {
    double t = 0.0;
    st[0] = 0.0;
#pragma unroll 16
    for (int i = 1; i < S; ++i) {
      t = t + st[i];
      st[i] = t;
    }
  }
  const float e_s_span = ep[E_S_MAX] - ep[E_S_MIN];
  const double e_l_span = (double)(ep[E_L_MAX] - ep[E_L_MIN]);
  int s_idx[PER_THREAD], l_idx[PER_THREAD][3];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = tid + q * THREADS;
    if (i >= S) continue;
    const float s = fma32((float)i, s_step, s_base);
    s_idx[q] = (int)clampf(rintf((s - ep[E_S_MIN]) / e_s_span
                                 * (float)(SE - 1)), 0.0f, (float)(SE - 1));
#pragma unroll
    for (int b2 = 0; b2 < 3; ++b2) {
      const double lq = sl[i] + (b2 == 0 ? 0.0 : (b2 == 1 ? 0.25 : -0.25));
      l_idx[q][b2] = (int)clampd(
          rint((lq - (double)ep[E_L_MIN]) / e_l_span * (double)(LE - 1)),
          0.0, (double)(LE - 1));
    }
  }
  __syncthreads();
  clk.stamp(P_TIMES);

  // collision checks (poly_lat_planner.cu:150-185): interpDistField
  // (env.cu:229-239) with the dt_start time mapping, time offsets -1, 0,
  // 1 s and lateral offsets 0, 0.25, -0.25 m
  float coll = INFINITY;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = tid + q * THREADS;
    if (i >= S) continue;
    const float s = fma32((float)i, s_step, s_base);
    const double t = st[i];
    float dist_sem = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double tq = t + (double)(a - 1);
      const double t_idx = tq < (double)ep[E_DT_START]
          ? 0.0 : rint((tq - (double)ep[E_DT_START]) / (double)ep[E_DT]) + 1.0;
      const int ti = (int)clampd(t_idx, 0.0, (double)(TE - 1));
#pragma unroll
      for (int b2 = 0; b2 < 3; ++b2)
        dist_sem = max_nan(
            dist_sem, occ[((size_t)ti * SE + s_idx[q]) * LE + l_idx[q][b2]]);
    }
    const bool hit = dist_sem > 0.0f && t < 8.0 && s > pp[LENGTH_VEH];
    coll = min_nan(coll, hit ? s : 10000.0f);
  }
  clk.stamp(P_COLLISION);
  // the least collision station: each warp's, then thread 0's
#pragma unroll
  for (int o = WARP / 2; o > 0; o /= 2)
    coll = min_nan(coll, __shfl_xor_sync(0xffffffffu, coll, o));
  if (lane == 0) w_coll[warp] = coll;
  __syncthreads();

  if (tid == 0) {
    const int warps = (int)(blockDim.x / WARP);
    float cmin = w_coll[0];
    double tc = w_cost[0];
    for (int w2 = 1; w2 < warps; ++w2) {
      cmin = min_nan(cmin, w_coll[w2]);
      tc = tc + w_cost[w2];
    }
    tc = tc + (double)(l_dst < -0.1f ? pp[W_RIGHT] : 0.0f);
    const float dl_t = l_dst - pp[L_TRG];
    tc = tc + (double)(pp[W_L] * (dl_t * dl_t));
    tc = tc + (double)(pp[W_LEN] * fabsf(s_dst));
    cd_out[cand] = min_nan(cmin, 1000.0f);
    tc_out[cand] = tc;
  }
  clk.stamp(P_REDUCE);

  // the arrival (as a grid barrier does it): the block's barrier, then
  // thread 0's fence orders the block's cd and tc before its count, and in
  // the last block its second fence the count before the block's reads
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == n_cand - 1;
    if (last) {
      *counter = 0;
      __threadfence();
    }
    *flag = last;
  }
  __syncthreads();
  clk.stamp(P_ARRIVE);
  if (!*flag) {
    clk.flush(prof);
    return;
  }

  // the last block: the selection, its values staged over the region
  select_block(cd_out, tc_out, LD, SD, pp[LENGTH_VEH],
               reinterpret_cast<float*>(sl), best_out, cost_out);
  clk.stamp(P_SELECT);
  clk.flush(prof);
}

}  // namespace poly_lat

// dynamic shared memory of a block of S samples in a launch of n candidates
extern "C" size_t poly_lat_sweep_smem_bytes(int S, int n) {
  return poly_lat::sweep_smem_bytes(S, n);
}

extern "C" int poly_lat_n_phases() { return poly_lat::N_PHASE; }
extern "C" int poly_lat_max_candidates() { return poly_lat::MAX_CANDIDATES; }

#ifdef __CUDACC__
extern "C" int poly_lat_n_params() { return poly_lat::N_PP; }
extern "C" int poly_lat_n_env_params() { return poly_lat::N_ENV; }
extern "C" int poly_lat_max_samples() { return poly_lat::MAX_SAMPLES; }

namespace {
template <bool PROF>
int launch(const float* occ, const float* ref_line, const float* ref_step,
           const float* pp, const float* env, const float* start,
           const double* hermite_inv, float* cd, double* tc, long long* best,
           float* cost, int* counter, unsigned long long* prof, int LD,
           int SD, int S, int TE, int SE, int LE, int n_ref, void* stream) {
  using namespace poly_lat;
  const int n = LD * SD;
  if (S > MAX_SAMPLES || S < 2 || n < 1 || n > MAX_CANDIDATES)
    return (int)cudaErrorInvalidValue;
  poly_lat_sweep_kernel<PROF><<<n, THREADS, sweep_smem_bytes(S, n),
                                (cudaStream_t)stream>>>(
      occ, ref_line, ref_step, pp, env, start, hermite_inv, cd, tc, best,
      cost, counter, prof, LD, SD, S, TE, SE, LE, n_ref);
  return (int)cudaGetLastError();
}
}  // namespace

// The candidate sweep and the selection in one launch: cd (LD, SD) float32
// and tc (LD, SD) float64, the winner's flat index (int64) and its cost
// (float32), from the occupancy grid (TE, SE, LE), the reference line
// (n_ref, 8), the reference step, the packed parameters, the env
// parameters, the start [l, dl, ddl, s, v] and the 6 x 6 float64 Hermite
// inverse of the quintic; `counter` one int that is 0 (the launch leaves it
// 0).  At most MAX_CANDIDATES candidates (the header).
extern "C" int poly_lat_sweep_select(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start,
    const double* hermite_inv, float* cd, double* tc, long long* best,
    float* cost, int* counter, int LD, int SD, int S, int TE, int SE, int LE,
    int n_ref, void* stream) {
  return launch<false>(occ, ref_line, ref_step, pp, env, start, hermite_inv,
                       cd, tc, best, cost, counter, nullptr, LD, SD, S, TE,
                       SE, LE, n_ref, stream);
}

// The profiling instantiation: the same results, and per phase
// (poly_lat::Phase) thread 0's cycles added into prof[N_PHASE] over the
// blocks.
extern "C" int poly_lat_sweep_select_profile(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start,
    const double* hermite_inv, float* cd, double* tc, long long* best,
    float* cost, int* counter, unsigned long long* prof, int LD, int SD,
    int S, int TE, int SE, int LE, int n_ref, void* stream) {
  return launch<true>(occ, ref_line, ref_step, pp, env, start, hermite_inv,
                      cd, tc, best, cost, counter, prof, LD, SD, S, TE, SE,
                      LE, n_ref, stream);
}

// Loads the kernels onto the current device, so that the first launch does
// not pay for it (the wrapper calls it when it binds the library).  Returns
// the CUDA error code.
extern "C" int poly_lat_prepare() {
  using namespace poly_lat;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, poly_lat_sweep_kernel<false>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, poly_lat_sweep_kernel<true>);
  return (int)err;
}
#endif

// Lateral candidate sweep and selection of the poly-lat / lon-DP planner
// chain, for Hopper (sm_90a).
//
// Replaces two XLA programs of the JAX package (no Pallas kernel):
// tpl_tpu/planning/dyn_prog/poly_lat_kernel.py make_poly_lat_kernel's
// `evaluate` (:121-223) and poly_chain_kernel.py `select_path_device`
// (:78-113).  The reference is poly_lat_planner.cu.
//
// poly_lat_sweep: one block per (l_dst, s_dst) candidate, a thread per
// lateral sample (S = 201 at the demo set).  Six threads form the
// candidate's quintic coefficients; every sample evaluates the quintic (l
// and its three derivatives), the reference line at its station, the
// cartesian point, curvature, speed limit, constraint and cost, then its
// segment time; the segment times are summed into path times, S - 1
// dependent additions on the block's last thread (the order of the plain
// version's cumsum: the collision lookups round the times, so they keep
// their bits), while the block's warps reduce the costs and the other
// threads form their samples' occupancy indices but the time's; then each
// sample looks up the occupancy grid 9 times (3 time offsets x 3 lateral
// offsets) and the block's warps reduce the collision stations to their
// least.  A NaN is kept where the plain version keeps it (torch.maximum of
// the occupancy cells, so that a NaN cell is no collision; torch.amin of
// the stations).  Dtypes are the JAX program's: the float64 Hermite
// inverse promotes the quintics, the geometry and the cost to float64 (the
// JAX package runs with x64 on); the reference line lookup, the stations
// and the occupancy's s index stay float32, and so does the collision
// distance.  What bounds it: the dependent time sum (a float64 add chain of
// S steps) and the float64 arithmetic, not bytes: the sweep reads a few
// hundred reference rows and at most the 2.6 MB occupancy grid, and writes
// 12 bytes a candidate.

// poly_lat_select: one thread.  The two order-dependent passes of the
// selection in flat (il, isd) order, every value and comparison in float32,
// exactly as the JAX fori_loops do.
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

namespace poly_lat {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int ORDER = 5;        // quintic
constexpr int NC = ORDER + 1;
constexpr int MAX_SAMPLES = 900;   // shared memory under 48 KB
constexpr int PER_THREAD = (MAX_SAMPLES + THREADS - 1) / THREADS;
constexpr int REF_CH = 8;       // reference line channels

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

__host__ __device__ inline size_t sweep_smem_bytes(int S) {
  // the coefficients, a partial cost sum and collision station a warp,
  // then per sample l, x, y, v, t (double)
  return sizeof(double) * (NC + WARPS) + sizeof(float) * WARPS
         + (size_t)S * 5 * sizeof(double);
}

// the NaN-passing minimum and maximum (torch.amin, torch.clamp and
// torch.maximum keep a NaN)
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : (a < b ? a : b));
#endif
}

__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : (a > b ? a : b));
#endif
}

// the phases of the profiling instantiation, in the order poly_lat_kernel.py
// SWEEP_PHASES names them: thread 0's clock64() cycles
enum Phase { P_COEF, P_SAMPLES, P_SEGMENTS, P_TIMES, P_COLLISION, P_REDUCE,
             N_PHASE };

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

// A block per candidate, a thread per sample (S <= THREADS at the demo
// sets; more samples take turns).  The quintic's six coefficients are formed
// once, by six threads; each sample's evaluation and segment time as
// before; the path times are the running sum of the segment times on
// thread 0 in the plain version's order (the chain's sums stay in a
// register; the loads of the segment times run ahead of it); the cost sum
// and the least collision station are a block's warp reductions.
template <bool PROF>
__global__ void __launch_bounds__(THREADS)
poly_lat_sweep_kernel(const float* __restrict__ occ,
                      const float* __restrict__ ref_line,
                      const float* __restrict__ ref_step_p,
                      const float* __restrict__ pp_in,
                      const float* __restrict__ env_in,
                      const float* __restrict__ start,
                      const double* __restrict__ hermite_inv,
                      float* __restrict__ cd_out, double* __restrict__ tc_out,
                      unsigned long long* __restrict__ prof, int LD, int SD,
                      int S, int TE, int SE, int LE, int n_ref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* coef = reinterpret_cast<double*>(smem_raw);   // (NC,)
  double* w_cost = coef + NC;                            // (WARPS,)
  double* sl = w_cost + WARPS;
  double* sx = sl + S;
  double* sy = sx + S;
  double* sv = sy + S;
  double* st = sv + S;
  float* w_coll = reinterpret_cast<float*>(st + S);      // (WARPS,)

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
    const double k_abs_path = fmax(ak, (double)fabsf(rp[RL_K]));
    const double rv = (double)rp[RL_V];
    const double v = k_abs_path > 1e-6
        ? fmin(rv, sqrt((double)a_lat / fmax(k_abs_path, 1e-9)))
        : rv;

    // local constraints (poly_lat_planner.cu:64-76)
    const float mv = fminf(rp[RL_V], v0);
    double constr = fmax((double)(mv * mv) * ak - (double)a_lat, 0.0);
    const bool in_poly = s <= s_end;
    constr = constr + (in_poly ? fmax(ak - (double)pp[K_ABS_MAX], 0.0) : 0.0);
    constr = constr
        + (in_poly ? fmax(l - ((double)rp[RL_DL] - margin), 0.0) : 0.0);
    constr = constr
        + (in_poly ? fmax((-(double)rp[RL_DR] + margin) - l, 0.0) : 0.0);
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
    st[i] = sqrt(dx * dx + dy * dy) / fmax(sv[i], 1.0);
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
  clk.flush(prof);
}

__global__ void poly_lat_select_kernel(const float* __restrict__ cd,
                                       const double* __restrict__ tc,
                                       const float* __restrict__ length_veh,
                                       long long* __restrict__ best_out,
                                       float* __restrict__ cost_out, int LD,
                                       int SD) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int n = LD * SD;
  const float lv = *length_veh;
  const int init_l = LD / 2 + 1 < LD - 1 ? LD / 2 + 1 : LD - 1;
  const int init = init_l * SD + SD - 1;
  float max_cd = cd[init];
  for (int i = 0; i < n; ++i) {
    if ((float)tc[i] < 1e6f && cd[i] > max_cd + lv) max_cd = cd[i];
  }
  float min_cost = INFINITY;
  int best = init;
  for (int i = 0; i < n; ++i) {
    const float ti = (float)tc[i];
    if (fabsf(cd[i] - max_cd) <= 1.0f && ti < min_cost) {
      max_cd = cd[i];
      min_cost = ti;
      best = i;
    }
  }
  *best_out = best;
  *cost_out = min_cost;
}

}  // namespace poly_lat

// dynamic shared memory of a sweep block of S samples
extern "C" size_t poly_lat_sweep_smem_bytes(int S) {
  return poly_lat::sweep_smem_bytes(S);
}

extern "C" int poly_lat_n_phases() { return poly_lat::N_PHASE; }

#ifdef __CUDACC__
extern "C" int poly_lat_n_params() { return poly_lat::N_PP; }
extern "C" int poly_lat_n_env_params() { return poly_lat::N_ENV; }
extern "C" int poly_lat_max_samples() { return poly_lat::MAX_SAMPLES; }

namespace {
template <bool PROF>
int sweep_launch(const float* occ, const float* ref_line,
                 const float* ref_step, const float* pp, const float* env,
                 const float* start, const double* hermite_inv, float* cd,
                 double* tc, unsigned long long* prof, int LD, int SD, int S,
                 int TE, int SE, int LE, int n_ref, void* stream) {
  using namespace poly_lat;
  if (S > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  poly_lat_sweep_kernel<PROF><<<LD * SD, THREADS, sweep_smem_bytes(S),
                                (cudaStream_t)stream>>>(
      occ, ref_line, ref_step, pp, env, start, hermite_inv, cd, tc, prof, LD,
      SD, S, TE, SE, LE, n_ref);
  return (int)cudaGetLastError();
}
}  // namespace

// The candidate sweep: cd (LD, SD) float32 and tc (LD, SD) float64 from the
// occupancy grid (TE, SE, LE), the reference line (n_ref, 8), the reference
// step, the packed parameters, the env parameters, the start [l, dl, ddl, s,
// v] and the 6 x 6 float64 Hermite inverse of the quintic.
extern "C" int poly_lat_sweep(const float* occ, const float* ref_line,
                              const float* ref_step, const float* pp,
                              const float* env, const float* start,
                              const double* hermite_inv, float* cd,
                              double* tc, int LD, int SD, int S, int TE,
                              int SE, int LE, int n_ref, void* stream) {
  return sweep_launch<false>(occ, ref_line, ref_step, pp, env, start,
                             hermite_inv, cd, tc, nullptr, LD, SD, S, TE, SE,
                             LE, n_ref, stream);
}

// The profiling instantiation of the sweep: the same results, and per phase
// (poly_lat::Phase) thread 0's cycles added into prof[N_PHASE] over the
// blocks.
extern "C" int poly_lat_sweep_profile(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start,
    const double* hermite_inv, float* cd, double* tc,
    unsigned long long* prof, int LD, int SD, int S, int TE, int SE, int LE,
    int n_ref, void* stream) {
  return sweep_launch<true>(occ, ref_line, ref_step, pp, env, start,
                            hermite_inv, cd, tc, prof, LD, SD, S, TE, SE, LE,
                            n_ref, stream);
}

// The selection: the winner's flat index (int64) and its cost (float32).
extern "C" int poly_lat_select(const float* cd, const double* tc,
                               const float* length_veh, long long* best,
                               float* cost, int LD, int SD, void* stream) {
  poly_lat::poly_lat_select_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      cd, tc, length_veh, best, cost, LD, SD);
  return (int)cudaGetLastError();
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
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, poly_lat_select_kernel);
  return (int)err;
}
#endif

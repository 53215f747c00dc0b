// Lateral candidate sweep and selection of the poly-lat / lon-DP planner
// chain, for Hopper (sm_90a).
//
// Replaces two XLA programs of the JAX package (no Pallas kernel):
// tpl_tpu/planning/dyn_prog/poly_lat_kernel.py make_poly_lat_kernel's
// `evaluate` (:121-223) and poly_chain_kernel.py `select_path_device`
// (:78-113).  The reference is poly_lat_planner.cu.
//
// poly_lat_sweep: one block per (l_dst, s_dst) candidate, a thread per
// lateral sample (S = 201 at the demo set).  A sample evaluates the
// candidate's quintic (l and its three derivatives), the reference line at
// its station, the cartesian point, curvature, speed limit, constraint and
// cost; then the samples' segment times are summed into path times, 201
// dependent additions on one thread (the order of the plain version's
// cumsum), while a thread of another warp sums the costs; then each sample
// looks up the occupancy grid 9 times (3 time offsets x 3 lateral offsets)
// and the block takes the minimum collision station.  Dtypes are the JAX
// program's: the float64 Hermite inverse promotes the quintics, the geometry
// and the cost to float64 (the JAX package runs with x64 on); the reference
// line lookup, the stations and the occupancy's s index stay float32, and so
// does the collision distance.  What bounds it: the dependent time sum (a
// float64 add chain of S steps) and the float64 arithmetic, not bytes: the
// sweep reads a few hundred reference rows and at most the 2.6 MB occupancy
// grid, and writes 12 bytes a candidate.
//
// poly_lat_select: one thread.  The two order-dependent passes of the
// selection in flat (il, isd) order, every value and comparison in float32,
// exactly as the JAX fori_loops do.
//
// The operations and their order follow the plain versions
// (tpl_tpu_torch/planning/dyn_prog/poly_lat_kernel.py evaluate_reference,
// select_reference).  Three sums are taken in another order than the plain
// version's library calls (the 6-term coefficient products, which the plain
// version makes with a matrix product, and the cost sum), and sinf / cosf
// come from another math library, so the sweep agrees with its plain version
// to rounding, not bit for bit.  Build with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace poly_lat {

constexpr int THREADS = 256;
constexpr int ORDER = 5;        // quintic
constexpr int NC = ORDER + 1;
constexpr int MAX_SAMPLES = 900;   // shared memory under 48 KB
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
  // the cost sum, then per sample l, x, y, v, cost, t (double) and the
  // collision station (float)
  return sizeof(double) + (size_t)S * (6 * sizeof(double) + sizeof(float));
}

__global__ void __launch_bounds__(THREADS)
poly_lat_sweep_kernel(const float* __restrict__ occ,
                      const float* __restrict__ ref_line,
                      const float* __restrict__ ref_step_p,
                      const float* __restrict__ pp_in,
                      const float* __restrict__ env_in,
                      const float* __restrict__ start,
                      const double* __restrict__ hermite_inv,
                      float* __restrict__ cd_out, double* __restrict__ tc_out,
                      int LD, int SD, int S, int TE, int SE, int LE,
                      int n_ref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cost_sum = reinterpret_cast<double*>(smem_raw);
  double* sl = cost_sum + 1;
  double* sx = sl + S;
  double* sy = sx + S;
  double* sv = sy + S;
  double* scost = sv + S;
  double* st = scost + S;
  float* scoll = reinterpret_cast<float*>(st + S);

  const int tid = threadIdx.x;
  const int cand = blockIdx.x;
  const int il = cand / SD, isd = cand % SD;
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

  // the quintic from its boundary values (PolyQuintic): b scaled by d^k
  const float d = s_end - s0;
  const float b[NC] = {l0, dl0 * d, ddl0 * (d * d), l_dst, 0.0f * d,
                       0.0f * (d * d)};
  double c[NC];
  for (int m = 0; m < NC; ++m) {
    double acc = 0.0;
    for (int k = 0; k < NC; ++k) acc += (double)b[k] * hermite_inv[m * NC + k];
    c[m] = acc;
  }
  const double d1 = (double)d, d2 = (double)(d * d);
  const double d3 = (double)(d * (d * d));
  const double margin = (double)(pp[WIDTH_VEH] * 0.5f) * sqrt(2.0);
  const float a_lat = pp[A_LAT_ABS_MAX];

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
    scost[i] = cost;
  }
  __syncthreads();

  // the segment times (poly_lat_planner.cu:102-148)
  for (int i = 1 + tid; i < S; i += blockDim.x) {
    const double dx = sx[i] - sx[i - 1];
    const double dy = sy[i] - sy[i - 1];
    st[i] = sqrt(dx * dx + dy * dy) / fmax(sv[i], 1.0);
  }
  __syncthreads();
  // their running sum on thread 0, the cost sum on a thread of warp 1
  if (tid == 0) {
    double t = 0.0;
    st[0] = 0.0;
    for (int i = 1; i < S; ++i) {
      t = t + st[i];
      st[i] = t;
    }
  } else if (tid == 32) {
    double acc = 0.0;
    for (int i = 0; i < S; ++i) acc = acc + scost[i];
    *cost_sum = acc;
  }
  __syncthreads();

  // collision checks (poly_lat_planner.cu:150-185): interpDistField
  // (env.cu:229-239) with the dt_start time mapping
  const float e_s_span = ep[E_S_MAX] - ep[E_S_MIN];
  const double e_l_span = (double)(ep[E_L_MAX] - ep[E_L_MIN]);
  for (int i = tid; i < S; i += blockDim.x) {
    const float s = fma32((float)i, s_step, s_base);
    const double t = st[i];
    const double l = sl[i];
    const float si = clampf(rintf((s - ep[E_S_MIN]) / e_s_span * (float)(SE - 1)),
                            0.0f, (float)(SE - 1));
    float dist_sem = 0.0f;
    // time offsets -1, 0, 1 s, lateral offsets 0, 0.25, -0.25 m
    for (int a = 0; a < 3; ++a) {
      const double tq = t + (double)(a - 1);
      const double t_idx = tq < (double)ep[E_DT_START]
          ? 0.0 : rint((tq - (double)ep[E_DT_START]) / (double)ep[E_DT]) + 1.0;
      const int ti = (int)clampd(t_idx, 0.0, (double)(TE - 1));
      for (int b2 = 0; b2 < 3; ++b2) {
        const double lq = l + (b2 == 0 ? 0.0 : (b2 == 1 ? 0.25 : -0.25));
        const int li = (int)clampd(
            rint((lq - (double)ep[E_L_MIN]) / e_l_span * (double)(LE - 1)),
            0.0, (double)(LE - 1));
        dist_sem = fmaxf(dist_sem,
                         occ[((size_t)ti * SE + (int)si) * LE + li]);
      }
    }
    const bool hit = dist_sem > 0.0f && t < 8.0 && s > pp[LENGTH_VEH];
    scoll[i] = hit ? s : 10000.0f;
  }
  __syncthreads();

  if (tid == 0) {
    float cmin = scoll[0];
    for (int i = 1; i < S; ++i) cmin = fminf(cmin, scoll[i]);
    double tc = *cost_sum;
    tc = tc + (double)(l_dst < -0.1f ? pp[W_RIGHT] : 0.0f);
    const float dl_t = l_dst - pp[L_TRG];
    tc = tc + (double)(pp[W_L] * (dl_t * dl_t));
    tc = tc + (double)(pp[W_LEN] * fabsf(s_dst));
    cd_out[cand] = fminf(cmin, 1000.0f);
    tc_out[cand] = tc;
  }
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

#ifdef __CUDACC__
extern "C" int poly_lat_n_params() { return poly_lat::N_PP; }
extern "C" int poly_lat_n_env_params() { return poly_lat::N_ENV; }
extern "C" int poly_lat_max_samples() { return poly_lat::MAX_SAMPLES; }

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
  using namespace poly_lat;
  if (S > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  poly_lat_sweep_kernel<<<LD * SD, THREADS, sweep_smem_bytes(S),
                          (cudaStream_t)stream>>>(
      occ, ref_line, ref_step, pp, env, start, hermite_inv, cd, tc, LD, SD, S,
      TE, SE, LE, n_ref);
  return (int)cudaGetLastError();
}

// The selection: the winner's flat index (int64) and its cost (float32).
extern "C" int poly_lat_select(const float* cd, const double* tc,
                               const float* length_veh, long long* best,
                               float* cost, int LD, int SD, void* stream) {
  poly_lat::poly_lat_select_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      cd, tc, length_veh, best, cost, LD, SD);
  return (int)cudaGetLastError();
}
#endif

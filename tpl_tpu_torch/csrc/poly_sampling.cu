// The Werling candidate grid of the Frenet polynomial sampling planner, for
// Hopper (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/poly_sampling/poly_kernel.py make_poly_sampling_kernel's
// `run` (:76-196).  The reference is poly_sampling.cpp:37-258.
//
// poly_sampling_eval: one block per (d_end, T, v_end) candidate, a thread
// per step (strided by the block).  Thread 0 solves the candidate's quintic
// and quartic coefficients (float32 boundary values times the float64
// inverses, as the JAX program promotes them); each step evaluates both
// polynomials and their derivatives (Horner, float64), the reference path
// at the station (lerp_xs: float64 weights, the heading's short angle in
// float32), the cartesian point and heading, the constraint terms, and the
// separating-axis test of the ego rectangle posed there against every
// obstacle hull (the hull's edge normals and self-projections, float32, are
// made once per block); then each step its segment length (jnp.hypot's
// form) and curvature; then thread 0 sums the step terms in step order and
// forms the cost.  The candidate's 11 rows and its cost go to scratch.
//
// poly_sampling_select: one block.  Thread 0 takes the first minimum of the
// costs; the block copies the winner's rows.
//
// What bounds it: neither bytes nor operations at these sizes (30 x 25
// candidate steps at the JAX bench's scene, 6 x 25 at the demo set): the
// launch and the serial chain of one candidate, a step's float64 chain and
// the N-step sums.
//
// The operations and their order follow the plain version
// (tpl_tpu_torch/planning/poly_sampling/poly_kernel.py run_reference), but
// for the coefficient solves (6- and 5-term sums in index order, a matrix
// product there) and the math library's last bits, so the two agree to
// rounding, and the winner as an index.  Build with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace poly_sampling_k {

constexpr int MAX_STEPS = 1024;
constexpr int N_ROWS = 11;
constexpr double PENALTY = 10.0e6;
constexpr float PI_F = 3.14159274f;       // float32(pi)
constexpr float TWO_PI_F = 6.28318548f;   // float32(2 pi)
constexpr double PI_D = 3.141592653589793;
constexpr double TWO_PI_D = 6.283185307179586;

// the packed parameters (poly_kernel.py PP_KEYS)
enum Pp {
  K_J, K_T, TRG_D, K_D, K_V, K_LAT, K_LON, K_OVERTAKE_RIGHT, A_MAX, K_MAX,
  REAR_AXIS_TO_REAR, REAR_AXIS_TO_FRONT, WIDTH_EGO, N_PP
};
// the rows (poly_kernel.py OUT_KEYS)
enum { O_D, O_D_D, O_D_DD, O_S, O_S_D, O_S_DD, O_X, O_Y, O_YAW, O_C, O_DS };
// the per-step terms summed per candidate
enum { T_JP, T_JS, T_JR, T_P1, T_P2, T_P3, T_P4, N_TERMS };

__device__ __forceinline__ float mod_f(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? r + m : r;
}

__device__ __forceinline__ double mod_d(double x, double m) {
  const double r = fmod(x, m);
  return r < 0.0 ? r + m : r;
}

// ops.interp.short_angle_dist in float32 and in float64
__device__ __forceinline__ float sad_f(float a0, float a1) {
  return mod_f((a1 - a0) + PI_F, TWO_PI_F) - PI_F;
}
__device__ __forceinline__ double sad_d(double a0, double a1) {
  return mod_d((a1 - a0) + PI_D, TWO_PI_D) - PI_D;
}

// the deriv-th u-derivative of the degree-`top` series c (Horner), over x
// scaled by d^deriv (d * (d * d) for a cube, float32)
__device__ __forceinline__ double poly_eval(const double* c, int top,
                                            int deriv, float u, float d) {
  double acc = 0.0;
  for (int k = top; k >= deriv; --k) {
    double fac = 1.0;
    for (int m = k - deriv + 1; m <= k; ++m) fac *= (double)m;
    acc = acc * (double)u + c[k] * fac;
  }
  float dp = 1.0f;
  if (deriv == 1) dp = d;
  if (deriv == 2) dp = d * d;
  if (deriv == 3) dp = d * (d * d);
  return deriv == 0 ? acc : acc / (double)dp;
}

// lerp_xs(x, path[:, 3], path[:, col]) with x float64 (path (n, 6))
__device__ __forceinline__ double lerp_path(const float* path, int n,
                                            double q, int col, bool angle) {
  const int start = (int)fmin(fmax(floor(q), 0.0), (double)(n - 2));
  const int end = (int)fmin(fmax(ceil(q), 0.0), (double)(n - 1));
  const double a = q - (double)start;
  const float y0 = path[(size_t)start * 6 + col];
  const float y1 = path[(size_t)end * 6 + col];
  if (angle) return (double)y0 + (double)sad_f(y0, y1) * a;
  return (double)y0 * (1.0 - a) + (double)y1 * a;
}

// jnp.hypot
__device__ __forceinline__ double hypot_jnp(double a, double b) {
  a = fabs(a);
  b = fabs(b);
  const double hi = fmax(a, b), lo = fmin(a, b);
  if (isinf(a) || isinf(b)) return INFINITY;
  if (hi == 0.0) return hi;
  const double r = lo / hi;
  return hi * sqrt(1.0 + r * r);
}

__host__ __device__ inline size_t eval_smem_bytes(int N, int O, int K) {
  // coefficients, per step 9 rows + 7 terms (double) and the hit count,
  // the obstacles' normals and self-projections
  return sizeof(double) * (6 + 5 + (size_t)N * (9 + N_TERMS)) +
         sizeof(int) * (size_t)N + sizeof(float) * (size_t)O * K * 4;
}

__global__ void poly_sampling_eval_kernel(
    const float* __restrict__ start, const float* __restrict__ di,
    const float* __restrict__ Ti, const float* __restrict__ tv,
    const float* __restrict__ ts, const float* __restrict__ path,
    const float* __restrict__ hulls, const float* __restrict__ valid,
    const float* __restrict__ pp_in, const double* __restrict__ inv,
    double* __restrict__ rows_out, double* __restrict__ cost_out, int C,
    int N, int n_path, int O, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cl = reinterpret_cast<double*>(smem_raw);    // quintic (6)
  double* cs = cl + 6;                                 // quartic (5)
  double* row = cs + 5;                                // (9, N)
  double* term = row + 9 * N;                          // (N_TERMS, N)
  int* hits = reinterpret_cast<int*>(term + N_TERMS * N);
  float* nrm = reinterpret_cast<float*>(hits + N);     // (O, K, 2)
  float* po_min = nrm + O * K * 2;                     // (O, K)
  float* po_max = po_min + O * K;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = blockIdx.x;
  float pp[N_PP];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const float T_end = Ti[c];
  const float d = T_end - 0.0f;        // x1 - x0, the polynomials' span

  if (tid == 0) {
    // PolyQuintic(0, d0, dd0, ddd0, T, d_end, 0, 0): b = [y0, dy0 d,
    // ddy0 (d d), y1, 0 d, 0 (d d)], c = b . inv^T
    const float b5[6] = {start[0], start[1] * d, start[2] * (d * d), di[c],
                         0.0f * d, 0.0f * (d * d)};
    for (int m = 0; m < 6; ++m) {
      double acc = 0.0;
      for (int k = 0; k < 6; ++k) acc += (double)b5[k] * inv[m * 6 + k];
      cl[m] = acc;
    }
    // PolyQuartic(0, s0, sd0, sdd0, T, v_end, 0): b = [s0, v d, (a d) d,
    // ve d, (0 d) d]
    const float b4[5] = {start[3], start[4] * d, start[5] * d * d, tv[c] * d,
                         0.0f * d * d};
    for (int m = 0; m < 5; ++m) {
      double acc = 0.0;
      for (int k = 0; k < 5; ++k) acc += (double)b4[k] * inv[36 + m * 5 + k];
      cs[m] = acc;
    }
  }
  // the obstacles' edge normals and their self-projections
  for (int e = tid; e < O * K; e += nt) {
    const int o = e / K, j = e % K;
    const float* h = hulls + (size_t)o * K * 2;
    const int jn = j + 1 < K ? j + 1 : 0;
    const float ex = h[jn * 2] - h[j * 2], ey = h[jn * 2 + 1] - h[j * 2 + 1];
    const float nx = -ey, ny = ex;
    nrm[e * 2] = nx;
    nrm[e * 2 + 1] = ny;
    float lo = INFINITY, hi = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float p = h[k * 2] * nx + h[k * 2 + 1] * ny;
      lo = fminf(lo, p);
      hi = fmaxf(hi, p);
    }
    po_min[e] = lo;
    po_max[e] = hi;
  }
  __syncthreads();

  const double x0e = (double)(-pp[REAR_AXIS_TO_REAR]);
  const double x1e = (double)pp[REAR_AXIS_TO_FRONT];
  const double be = (double)(pp[WIDTH_EGO] / 2.0f);
  const float xs0 = path[3], dxs = path[6 + 3] - path[3];
  for (int n = tid; n < N; n += nt) {
    const float u = (ts[n] - 0.0f) / d;
    const double dv = poly_eval(cl, 5, 0, u, d);
    const double d_d = poly_eval(cl, 5, 1, u, d);
    const double d_dd = poly_eval(cl, 5, 2, u, d);
    const double d_ddd = poly_eval(cl, 5, 3, u, d);
    const double sv = poly_eval(cs, 4, 0, u, d);
    const double s_d = poly_eval(cs, 4, 1, u, d);
    const double s_dd = poly_eval(cs, 4, 2, u, d);
    const double s_ddd = poly_eval(cs, 4, 3, u, d);

    const double q = (sv - (double)xs0) / (double)dxs;
    const double rx = lerp_path(path, n_path, q, 0, false);
    const double ry = lerp_path(path, n_path, q, 1, false);
    const double rh = lerp_path(path, n_path, q, 2, true);
    const double rv = lerp_path(path, n_path, q, 5, false);
    const double hf = atan(d_d / (s_d == 0.0 ? 1e-9 : s_d));
    const double x = rx - sin(rh) * dv;
    const double y = ry + cos(rh) * dv;
    const double yaw = hf + rh;

    // the collision screen at this pose
    int nh = 0;
    const double cy_ = cos(yaw), sy_ = sin(yaw);
    for (int o = 0; o < O; ++o) {
      if (valid[o] == 0.0f) continue;
      const float* h = hulls + (size_t)o * K * 2;
      double qx_max = -INFINITY, qx_min = INFINITY;
      double qy_max = -INFINITY, qy_min = INFINITY;
      for (int k = 0; k < K; ++k) {
        const double rx_ = (double)h[k * 2] - x, ry_ = (double)h[k * 2 + 1] - y;
        const double qx = rx_ * cy_ + ry_ * sy_;
        const double qy = -rx_ * sy_ + ry_ * cy_;
        qx_max = fmax(qx_max, qx);
        qx_min = fmin(qx_min, qx);
        qy_max = fmax(qy_max, qy);
        qy_min = fmin(qy_min, qy);
      }
      bool sep = qx_max < x0e || qx_min > x1e || qy_max < -be || qy_min > be;
      for (int j = 0; j < K && !sep; ++j) {
        const double n_x = (double)nrm[(o * K + j) * 2];
        const double n_y = (double)nrm[(o * K + j) * 2 + 1];
        const double nx = n_x * cy_ + n_y * sy_;
        const double ny = -n_x * sy_ + n_y * cy_;
        const double pc = n_x * x + n_y * y;
        const double hi = fmax(nx * x0e, nx * x1e) + fabs(ny) * be;
        const double lo = fmin(nx * x0e, nx * x1e) - fabs(ny) * be;
        if (pc + hi < (double)po_min[o * K + j] ||
            pc + lo > (double)po_max[o * K + j])
          sep = true;
      }
      if (!sep) ++nh;
    }

    row[O_D * N + n] = dv;
    row[O_D_D * N + n] = d_d;
    row[O_D_DD * N + n] = d_dd;
    row[O_S * N + n] = sv;
    row[O_S_D * N + n] = s_d;
    row[O_S_DD * N + n] = s_dd;
    row[O_X * N + n] = x;
    row[O_Y * N + n] = y;
    row[O_YAW * N + n] = yaw;
    term[T_JP * N + n] = d_ddd * d_ddd;
    term[T_JS * N + n] = s_ddd * s_ddd;
    term[T_JR * N + n] = dv < 0.0 ? -dv : 0.0;
    term[T_P1 * N + n] = fmax(fabs(s_d) - rv, 0.0);
    term[T_P3 * N + n] = fmax(fabs(s_dd) - (double)pp[A_MAX], 0.0);
    term[T_P4 * N + n] = fmax(fabs(dv) - 4.0, 0.0);
    hits[n] = nh;
  }
  __syncthreads();

  // the segments and the curvature
  double* out = rows_out + (size_t)c * N_ROWS * N;
  for (int n = tid; n + 1 < N; n += nt) {
    const double seg = hypot_jnp(row[O_X * N + n + 1] - row[O_X * N + n],
                                 row[O_Y * N + n + 1] - row[O_Y * N + n]);
    const double k = sad_d(row[O_YAW * N + n], row[O_YAW * N + n + 1]) /
                     fmax(seg, 1e-9);
    out[O_DS * N + n] = seg;
    out[O_C * N + n] = k;
    term[T_P2 * N + n] = fmax(fabs(k) - (double)pp[K_MAX], 0.0);
    if (n + 2 == N) {
      out[O_C * N + n + 1] = k;
      out[O_DS * N + n + 1] = 0.0;
      term[T_P2 * N + n + 1] = term[T_P2 * N + n];
    }
  }
  for (int i = tid; i < 9 * N; i += nt) out[i] = row[i];
  __syncthreads();

  if (tid == 0) {
    double sums[N_TERMS];
    int n_hits = 0;
    for (int t = 0; t < N_TERMS; ++t) {
      double acc = term[t * N];
      for (int n = 1; n < N; ++n) acc = acc + term[t * N + n];
      sums[t] = acc;
    }
    for (int n = 0; n < N; ++n) n_hits += hits[n];
    const double kt_T = (double)(pp[K_T] * T_end);
    const double dd_end = (double)pp[TRG_D] - row[O_D * N + N - 1];
    const double vd_end = 100.0 - row[O_S_D * N + N - 1];
    const double cd = (double)pp[K_J] * sums[T_JP] + kt_T +
                      (double)pp[K_D] * (dd_end * dd_end) +
                      (double)pp[K_OVERTAKE_RIGHT] * sums[T_JR];
    const double cv = (double)pp[K_J] * sums[T_JS] + kt_T +
                      (double)pp[K_V] * (vd_end * vd_end);
    double cost = (double)pp[K_LAT] * cd + (double)pp[K_LON] * cv;
    cost = cost + PENALTY * sums[T_P1];
    cost = cost + PENALTY * sums[T_P2];
    cost = cost + PENALTY * sums[T_P3];
    cost = cost + PENALTY * sums[T_P4];
    if (O > 0) cost = cost + (double)((float)PENALTY * (float)n_hits);
    cost_out[c] = cost;
  }
}

__global__ void poly_sampling_select_kernel(const double* __restrict__ rows,
                                            const double* __restrict__ costs,
                                            double* __restrict__ packed,
                                            double* __restrict__ cost_out,
                                            long long* __restrict__ best_out,
                                            int C, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int& best_s = *reinterpret_cast<int*>(smem_raw);
  if (threadIdx.x == 0) {
    int best = 0;
    double bc = costs[0];
    for (int c = 1; c < C; ++c)
      if (costs[c] < bc) {
        bc = costs[c];
        best = c;
      }
    best_s = best;
    *cost_out = bc;
    *best_out = best;
  }
  __syncthreads();
  const double* src = rows + (size_t)best_s * N_ROWS * N;
  for (int i = threadIdx.x; i < N_ROWS * N; i += blockDim.x) packed[i] = src[i];
}

}  // namespace poly_sampling_k

#ifdef __CUDACC__
extern "C" int poly_sampling_n_params() { return poly_sampling_k::N_PP; }
extern "C" int poly_sampling_max_steps() { return poly_sampling_k::MAX_STEPS; }

// The grid: each candidate's rows (C, 11, N) float64 and cost (C,) float64
// from the start [d, d_d, d_dd, s, s_d, s_dd], the grids di / Ti / tv (C,),
// the step times (N,), the path (n_path, 6), the obstacle hulls (O, K, 2)
// and flags (O,), the packed parameters and the float64 inverses (the
// quintic's 6 x 6, then the quartic's 5 x 5).
extern "C" int poly_sampling_eval(const float* start, const float* di,
                                  const float* Ti, const float* tv,
                                  const float* ts, const float* path,
                                  const float* hulls, const float* valid,
                                  const float* pp, const double* inv,
                                  double* rows, double* costs, int C, int N,
                                  int n_path, int O, int K, void* stream) {
  using namespace poly_sampling_k;
  if (N > MAX_STEPS || N < 2 || C < 1 || n_path < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = eval_smem_bytes(N, O, K);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  poly_sampling_eval_kernel<<<C, 32, smem, (cudaStream_t)stream>>>(
      start, di, Ti, tv, ts, path, hulls, valid, pp, inv, rows, costs, C, N,
      n_path, O, K);
  return (int)cudaGetLastError();
}

// The selection: the winner's rows (11, N), cost and index.
extern "C" int poly_sampling_select(const double* rows, const double* costs,
                                    double* packed, double* cost,
                                    long long* best, int C, int N,
                                    void* stream) {
  poly_sampling_k::poly_sampling_select_kernel<<<1, 256, 16,
                                                 (cudaStream_t)stream>>>(
      rows, costs, packed, cost, best, C, N);
  return (int)cudaGetLastError();
}
#endif

// The Werling candidate grid of the Frenet polynomial sampling planner, for
// Hopper (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/poly_sampling/poly_kernel.py make_poly_sampling_kernel's
// `run` (:76-196).  The reference is poly_sampling.cpp:37-258.
//
// poly_sampling: one launch, a block of 256 threads per (d_end, T, v_end)
// candidate, in four phases between barriers:
//  1. the 11 coefficients on 11 threads, each a 6-term (quintic) or 5-term
//     (quartic) sum in index order of float32 boundary values times the
//     float64 inverses, as the JAX program promotes them; beside them the
//     obstacles' edge normals and self-projections (float32);
//  2. both polynomials and their derivatives (Horner, float64), a warp for
//     each of the 8 (a step a lane), and the terms that need one of them
//     alone; then the reference path at the station (lerp_xs: float64
//     weights, the heading's short angle in float32), a warp each for the
//     cartesian x, the y, the heading and the speed-limit term;
//  3. a thread a (step, obstacle) pair for the separating-axis test of the
//     ego rectangle posed at the step against the obstacle's hull, the hits
//     counted as integers (so their order is free); beside it a thread a
//     step for the segment length (jnp.hypot's form) and the curvature, and
//     the candidate's rows written to scratch;
//  4. the 7 step-term sums on 7 threads, each in step order, then thread 0
//     forms the cost and writes it to scratch.
// Every block then arrives at a counter (a barrier, thread 0's fence, its
// atomic add).  The last block to arrive takes the first minimum of the C
// costs on one warp (a NaN first, the first NaN, as np.argmin; else the
// least cost, the smaller index among equal costs), copies the winner's 11
// rows and writes its cost and index; it puts the counter back to 0, so a
// counter is allocated once and a CUDA graph replays the launch as it is.
// The last block reads the other blocks' rows and costs through L2
// (__ldcg), never through the non-coherent path.
//
// What bounds it: neither bytes nor operations at these sizes (30 x 25
// candidate steps at the JAX bench's scene, 6 x 25 at the demo set): the
// launch, then one candidate's chain: a step's polynomial value, its
// station's division and lookups and one transcendental call, an obstacle
// test, the N-step sums, and the last block's selection.
//
// The operations and their order follow the plain version
// (tpl_tpu_torch/planning/poly_sampling/poly_kernel.py run_reference), but
// for the coefficient solves (6- and 5-term sums in index order, a matrix
// product there) and the math library's last bits, so the two agree to
// rounding, and the winner as an index.  Build with --fmad=false.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace poly_sampling_k {

constexpr int THREADS = 256;   // 8 warps: one for each polynomial value
static_assert(THREADS == 8 * 32, "a warp a polynomial value");
constexpr int MAX_STEPS = 1024;
constexpr int N_ROWS = 11;
constexpr double PENALTY = 10.0e6;
constexpr float PI_F = 3.14159274f;       // float32(pi)
constexpr float TWO_PI_F = 6.28318548f;   // float32(2 pi)
constexpr double PI_D = 3.141592653589793;
constexpr double TWO_PI_D = 6.283185307179586;
constexpr unsigned FULL = 0xffffffffu;

// the packed parameters (poly_kernel.py PP_KEYS)
enum Pp {
  K_J, K_T, TRG_D, K_D, K_V, K_LAT, K_LON, K_OVERTAKE_RIGHT, A_MAX, K_MAX,
  REAR_AXIS_TO_REAR, REAR_AXIS_TO_FRONT, WIDTH_EGO, N_PP
};
// the rows (poly_kernel.py OUT_KEYS)
enum { O_D, O_D_D, O_D_DD, O_S, O_S_D, O_S_DD, O_X, O_Y, O_YAW, O_C, O_DS };
// the per-step terms summed per candidate
enum { T_JP, T_JS, T_JR, T_P1, T_P2, T_P3, T_P4, N_TERMS };
// the block's shared integers: the hits, the last-arrival flag, the winner
enum { F_HITS, F_LAST, F_BEST, N_FLAGS = 4 };
// the profiling instantiation's phases, thread 0's clock64() cycles from
// barrier to barrier summed over the blocks (poly_kernel.py PHASES): the
// coefficients, the steps, the screen and the segments, the sums and the
// cost, the arrival; the selection and the copy (the last block only)
enum Phase { P_COEF, P_STEPS, P_SCREEN, P_SUMS, P_ARRIVE, P_SELECT, N_PHASE };

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

// (c, i) before (bc, bi): a NaN first (the smaller index among NaNs), else
// the smaller cost, the smaller index among equal costs (np.argmin)
__device__ __forceinline__ bool before(double c, int i, double bc, int bi) {
  const bool cn = c != c, bn = bc != bc;
  if (cn || bn) return cn && (!bn || i < bi);
  return c < bc || (c == bc && i < bi);
}

__host__ __device__ inline size_t smem_bytes(int N, int O, int K) {
  // the coefficients, the term sums and per step 9 rows + 7 terms
  // (double), the block's integers, the obstacles' normals and
  // self-projections
  return sizeof(double) * (6 + 5 + N_TERMS + (size_t)N * (9 + N_TERMS)) +
         sizeof(int) * N_FLAGS + sizeof(float) * (size_t)O * K * 4;
}

// thread 0's clock in the profiling instantiation (nothing otherwise)
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

// `rows` (C, 11, N) and `costs` (C,) are the blocks' scratch, which the
// last block reads back (so neither is const __restrict__); `counter` is 0
// at the launch and again at its end.
template <bool PROF>
__global__ void __launch_bounds__(THREADS, 1) poly_sampling_kernel(
    const float* __restrict__ start, const float* __restrict__ di,
    const float* __restrict__ Ti, const float* __restrict__ tv,
    const float* __restrict__ ts, const float* __restrict__ path,
    const float* __restrict__ hulls, const float* __restrict__ valid,
    const float* __restrict__ pp_in, const double* __restrict__ inv,
    double* rows, double* costs, double* __restrict__ packed,
    double* __restrict__ cost_out, long long* __restrict__ best_out,
    int* counter, unsigned long long* __restrict__ prof, int C, int N,
    int n_path, int O, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cl = reinterpret_cast<double*>(smem_raw);    // quintic (6)
  double* cs = cl + 6;                                 // quartic (5)
  double* sums = cs + 5;                               // (N_TERMS)
  double* row = sums + N_TERMS;                        // (9, N)
  double* term = row + 9 * N;                          // (N_TERMS, N)
  int* flag = reinterpret_cast<int*>(term + N_TERMS * N);
  float* nrm = reinterpret_cast<float*>(flag + N_FLAGS);  // (O, K, 2)
  float* po_min = nrm + O * K * 2;                     // (O, K)
  float* po_max = po_min + O * K;

  BlockClock<PROF> clk;
  clk.start();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = blockIdx.x;
  float pp[N_PP];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const float T_end = Ti[c];
  const float d = T_end - 0.0f;        // x1 - x0, the polynomials' span

  if (tid < 6) {
    // PolyQuintic(0, d0, dd0, ddd0, T, d_end, 0, 0): b = [y0, dy0 d,
    // ddy0 (d d), y1, 0 d, 0 (d d)], c = b . inv^T
    const float b5[6] = {start[0], start[1] * d, start[2] * (d * d), di[c],
                         0.0f * d, 0.0f * (d * d)};
    double acc = 0.0;
    for (int k = 0; k < 6; ++k) acc += (double)b5[k] * inv[tid * 6 + k];
    cl[tid] = acc;
  } else if (tid < 11) {
    // PolyQuartic(0, s0, sd0, sdd0, T, v_end, 0): b = [s0, v d, (a d) d,
    // ve d, (0 d) d]
    const int m = tid - 6;
    const float b4[5] = {start[3], start[4] * d, start[5] * d * d, tv[c] * d,
                         0.0f * d * d};
    double acc = 0.0;
    for (int k = 0; k < 5; ++k) acc += (double)b4[k] * inv[36 + m * 5 + k];
    cs[m] = acc;
  }
  if (tid == 0) flag[F_HITS] = 0;
  // the obstacles' edge normals and their self-projections, from warp 1 on
  // (warp 0 solves the coefficients)
  for (int e = (tid + nt - 32) % nt; e < O * K; e += nt) {
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
  clk.stamp(P_COEF);

  // the 8 polynomial values of each step, warp w the w-th (warp-uniform, so
  // no warp runs another's branch), and the terms that need that one alone
  const int warp = tid / 32, lane = tid % 32;
  for (int n = lane; n < N; n += 32) {
    const float u = (ts[n] - 0.0f) / d;
    switch (warp) {
      case 0: {
        const double dv = poly_eval(cl, 5, 0, u, d);
        row[O_D * N + n] = dv;
        term[T_JR * N + n] = dv < 0.0 ? -dv : 0.0;
        term[T_P4 * N + n] = fmax(fabs(dv) - 4.0, 0.0);
        break;
      }
      case 1: row[O_D_D * N + n] = poly_eval(cl, 5, 1, u, d); break;
      case 2: row[O_D_DD * N + n] = poly_eval(cl, 5, 2, u, d); break;
      case 3: {
        const double d_ddd = poly_eval(cl, 5, 3, u, d);
        term[T_JP * N + n] = d_ddd * d_ddd;
        break;
      }
      case 4: row[O_S * N + n] = poly_eval(cs, 4, 0, u, d); break;
      case 5: row[O_S_D * N + n] = poly_eval(cs, 4, 1, u, d); break;
      case 6: {
        const double s_dd = poly_eval(cs, 4, 2, u, d);
        row[O_S_DD * N + n] = s_dd;
        term[T_P3 * N + n] = fmax(fabs(s_dd) - (double)pp[A_MAX], 0.0);
        break;
      }
      default: {
        const double s_ddd = poly_eval(cs, 4, 3, u, d);
        term[T_JS * N + n] = s_ddd * s_ddd;
      }
    }
  }
  __syncthreads();

  // the reference path at the station and the cartesian pose: warps 0-3
  // the x, the y, the heading and the speed-limit term of each step, each
  // with the station's lookups it needs
  const float xs0 = path[3], dxs = path[6 + 3] - path[3];
  for (int n = lane; n < N && warp < 4; n += 32) {
    const double q = (row[O_S * N + n] - (double)xs0) / (double)dxs;
    const double s_d = row[O_S_D * N + n];
    switch (warp) {
      case 0: {
        const double rh = lerp_path(path, n_path, q, 2, true);
        row[O_X * N + n] = lerp_path(path, n_path, q, 0, false) -
                           sin(rh) * row[O_D * N + n];
        break;
      }
      case 1: {
        const double rh = lerp_path(path, n_path, q, 2, true);
        row[O_Y * N + n] = lerp_path(path, n_path, q, 1, false) +
                           cos(rh) * row[O_D * N + n];
        break;
      }
      case 2: {
        const double hf =
            atan(row[O_D_D * N + n] / (s_d == 0.0 ? 1e-9 : s_d));
        row[O_YAW * N + n] = hf + lerp_path(path, n_path, q, 2, true);
        break;
      }
      default:
        term[T_P1 * N + n] =
            fmax(fabs(s_d) - lerp_path(path, n_path, q, 5, false), 0.0);
    }
  }
  __syncthreads();
  clk.stamp(P_STEPS);

  // the segments and the curvature
  double* out = rows + (size_t)c * N_ROWS * N;
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
  // the collision screen: the ego rectangle at step n against obstacle o
  const double x0e = (double)(-pp[REAR_AXIS_TO_REAR]);
  const double x1e = (double)pp[REAR_AXIS_TO_FRONT];
  const double be = (double)(pp[WIDTH_EGO] / 2.0f);
  int nh = 0;
  for (int p = tid; p < N * O; p += nt) {
    const int n = p / O, o = p % O;
    if (valid[o] == 0.0f) continue;
    const double x = row[O_X * N + n], y = row[O_Y * N + n];
    const double yaw = row[O_YAW * N + n];
    const double cy_ = cos(yaw), sy_ = sin(yaw);
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
  if (nh) atomicAdd(flag + F_HITS, nh);
  __syncthreads();
  clk.stamp(P_SCREEN);

  // the step sums, each in step order, then the cost
  if (tid < N_TERMS) {
    double acc = term[tid * N];
    for (int n = 1; n < N; ++n) acc = acc + term[tid * N + n];
    sums[tid] = acc;
  }
  __syncthreads();
  if (tid == 0) {
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
    if (O > 0) cost = cost + (double)((float)PENALTY * (float)flag[F_HITS]);
    costs[c] = cost;
  }
  clk.stamp(P_SUMS);

  // the arrival (as a grid barrier does it): the block's barrier, then
  // thread 0's fence orders the block's rows and cost before its count, and
  // in the last block its second fence the count before the block's reads
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    if (last) {
      *counter = 0;
      __threadfence();
    }
    flag[F_LAST] = last;
  }
  __syncthreads();
  clk.stamp(P_ARRIVE);
  if (!flag[F_LAST]) {
    clk.flush(prof);
    return;
  }

  // the last block: the first minimum of the costs, the winner's rows
  if (tid < 32) {
    double bc = INFINITY;
    int bi = INT_MAX;
    for (int k = tid; k < C; k += 32) {
      const double v = __ldcg(costs + k);
      if (before(v, k, bc, bi)) {
        bc = v;
        bi = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double oc = __shfl_xor_sync(FULL, bc, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (before(oc, oi, bc, bi)) {
        bc = oc;
        bi = oi;
      }
    }
    if (tid == 0) {
      flag[F_BEST] = bi;
      *cost_out = bc;
      *best_out = bi;
    }
  }
  __syncthreads();
  const double* src = rows + (size_t)flag[F_BEST] * N_ROWS * N;
  for (int i = tid; i < N_ROWS * N; i += nt) packed[i] = __ldcg(src + i);
  clk.stamp(P_SELECT);
  clk.flush(prof);
}

}  // namespace poly_sampling_k

#ifdef __CUDACC__
namespace {

template <bool PROF>
int launch(const float* start, const float* di, const float* Ti,
           const float* tv, const float* ts, const float* path,
           const float* hulls, const float* valid, const float* pp,
           const double* inv, double* rows, double* costs, double* packed,
           double* cost, long long* best, int* counter,
           unsigned long long* prof, int C, int N, int n_path, int O, int K,
           void* stream) {
  using namespace poly_sampling_k;
  if (N > MAX_STEPS || N < 2 || C < 1 || n_path < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, O, K);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  poly_sampling_kernel<PROF><<<C, THREADS, smem, (cudaStream_t)stream>>>(
      start, di, Ti, tv, ts, path, hulls, valid, pp, inv, rows, costs,
      packed, cost, best, counter, prof, C, N, n_path, O, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int poly_sampling_n_params() { return poly_sampling_k::N_PP; }
extern "C" int poly_sampling_max_steps() { return poly_sampling_k::MAX_STEPS; }
extern "C" int poly_sampling_n_phases() { return poly_sampling_k::N_PHASE; }

// The grid and its winner in one launch: the winner's rows (11, N) float64
// into `packed`, its cost float64 and index int64, from the start [d, d_d,
// d_dd, s, s_d, s_dd], the grids di / Ti / tv (C,), the step times (N,),
// the path (n_path, 6), the obstacle hulls (O, K, 2) and flags (O,), the
// packed parameters and the float64 inverses (the quintic's 6 x 6, then the
// quartic's 5 x 5); `rows` (C, 11, N) and `costs` (C,) float64 are scratch,
// `counter` one int that is 0 (the launch leaves it 0).
extern "C" int poly_sampling(const float* start, const float* di,
                             const float* Ti, const float* tv,
                             const float* ts, const float* path,
                             const float* hulls, const float* valid,
                             const float* pp, const double* inv, double* rows,
                             double* costs, double* packed, double* cost,
                             long long* best, int* counter, int C, int N,
                             int n_path, int O, int K, void* stream) {
  return launch<false>(start, di, Ti, tv, ts, path, hulls, valid, pp, inv,
                       rows, costs, packed, cost, best, counter, nullptr, C,
                       N, n_path, O, K, stream);
}

// the profiling instantiation: the same results, and per phase
// (poly_sampling_k::Phase) thread 0's cycles added into prof[N_PHASE]
extern "C" int poly_sampling_profile(
    const float* start, const float* di, const float* Ti, const float* tv,
    const float* ts, const float* path, const float* hulls,
    const float* valid, const float* pp, const double* inv, double* rows,
    double* costs, double* packed, double* cost, long long* best,
    int* counter, unsigned long long* prof, int C, int N, int n_path, int O,
    int K, void* stream) {
  return launch<true>(start, di, Ti, tv, ts, path, hulls, valid, pp, inv,
                      rows, costs, packed, cost, best, counter, prof, C, N,
                      n_path, O, K, stream);
}
#endif

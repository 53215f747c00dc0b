// The fused RSTP step's jerk/acc-limited reference profile, float32, in one
// launch of one thread block.
//
// Replaces: the two jax.lax.scan of _rampify_scan
// (tpl_tpu/planning/path_vel_decomp/fused_replan.py:244-299), a backward
// scan over t = H-1 .. 1 and a forward scan, inside the fused step's XLA
// program; there is no Pallas kernel for it.  Plain version:
// tpl_tpu_torch/planning/path_vel_decomp/rstp_rampify.py scan_reference.
//
// What bounds it on an H100: latency.  Every step of both scans depends on
// the one before, so one thread runs them; plain torch issues the same
// ~500 serial steps as some 4,000 one-element launches.  The block stages
// the limits (held at row T-1 from T on, raised to v_min) in shared memory,
// thread 0 scans, and the block writes the (H, 2) profile once.  Each step
// keeps the plain version's operation order, and with --fmad=false and no
// fast math the result matches it bit for bit.  max / min pass NaN as
// torch.maximum / torch.minimum do.
//
// Input: v0, a0, a_min, a_max, j_min, j_max, v_min, step, then lim_v (H).
// Output: (H, 2) rows of [velocity, acceleration].

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "smem_limit.cuh"

namespace rstp_rampify {

constexpr int THREADS = 128;
enum { V0, A0, A_MIN, A_MAX, J_MIN, J_MAX, V_MIN, STEP, N_SCAL };

__device__ __forceinline__ float mx(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float mn(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}

__host__ __device__ inline size_t smem_floats(int H) {
  return (size_t)3 * H;           // lim, backward v, backward a
}

__global__ void __launch_bounds__(THREADS)
rstp_rampify_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int H, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lim = reinterpret_cast<float*>(smem_raw);
  float* bv = lim + H;
  float* ba = bv + H;
  const float* s = in;
  const float* lim_v = in + N_SCAL;
  const int tid = threadIdx.x;

  const float v_min = s[V_MIN];
  for (int t = tid; t < H; t += blockDim.x)
    lim[t] = mx(t < T ? lim_v[t] : lim_v[T - 1], v_min);
  __syncthreads();

  if (tid == 0) {
    const float a_min = s[A_MIN], a_max = s[A_MAX];
    const float j_min = s[J_MIN], j_max = s[J_MAX];
    const float step = s[STEP];
    // backward pass over t = H-1 .. 1; row t keeps the carry before step t
    float cv = lim[H - 1], ca = 0.0f;
    for (int t = H - 1; t > 0; --t) {
      bv[t] = cv;
      ba[t] = ca;
      const float lim_t = lim[t], lim_tm1 = lim[t - 1];
      const float lim_a = mx(a_min, (cv - lim_tm1) / step * cv);
      const bool neg = lim_a < 0.0f;
      ca = neg ? mx(ca + j_min / cv * step, lim_a) : 0.0f;
      cv = neg ? cv : lim_t;
      cv = cv + mn(-ca / cv * step, lim_tm1 - cv);
    }
    // forward pass; the output overwrites the backward rows it has read
    cv = mx(s[V0], v_min);
    ca = s[A0];
    bv[0] = cv;
    ba[0] = ca;
    float lim_a = 0.0f;
    for (int t = 0; t < H; ++t) {
      const float pv_t = bv[t];
      if (t < H - 1) lim_a = mn(a_max, (bv[t + 1] - cv) / step * cv);
      const bool pos = lim_a > 0.0f;
      ca = pos ? mn(ca + j_max / cv * step, lim_a) : 0.0f;
      cv = pos ? cv : pv_t;
      const float next_v = cv + mn(ca / cv * step, lim[t] - cv);
      cv = mn(pv_t, next_v);
      bv[t] = cv;
      ba[t] = ca;
    }
  }
  __syncthreads();
  for (int t = tid; t < H; t += blockDim.x) {
    out[2 * t] = bv[t];
    out[2 * t + 1] = ba[t];
  }
}

}  // namespace rstp_rampify

extern "C" size_t rstp_rampify_smem_bytes(int H) {
  return rstp_rampify::smem_floats(H) * sizeof(float);
}

#ifdef __CUDACC__
extern "C" int rstp_rampify_scan(const float* in, float* out, int H, int T,
                                 void* stream) {
  // the dynamic shared-memory limit is raised once per device and size
  // (smem_limit.cuh), not on every launch
  static smem_limit::Marks marks;
  const size_t smem = rstp_rampify_smem_bytes(H);
  cudaError_t err = smem_limit::ensure(rstp_rampify::rstp_rampify_kernel, smem,
                                      marks);
  if (err != cudaSuccess) return (int)err;
  rstp_rampify::rstp_rampify_kernel<<<1, rstp_rampify::THREADS, smem,
                                      (cudaStream_t)stream>>>(in, out, H, T);
  return (int)cudaGetLastError();
}
#endif

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
// the one before, so one thread runs them (plain torch runs the same ~500
// serial steps as some 4,000 one-element launches), and a step costs what
// sits on the carry's chain: two dependent IEEE divisions, two multiplies
// and four or five adds, maxima and minima (~120 cycles).  The design keeps
// everything else off that chain:
//  - what does not depend on the carry is computed by the whole block
//    before each scan: the limits (held at row T-1 from T on, raised to
//    v_min) and, for every step, the result of its branch that resets the
//    acceleration to zero (backward: lim_a >= 0, forward: lim_a <= 0), whose
//    operands are all known then; such a step costs the scan one division;
//  - the scanning thread loads a step's staged values one step ahead, so no
//    shared-memory load waits on the stores of the step before it;
//  - a zero numerator of the division by `step` (a profile that follows
//    its limit) skips that division: its quotient is the same zero;
//  - max / min are one instruction each (max.NaN / min.NaN pass a NaN as
//    torch.maximum / torch.minimum do);
//  - the forward scan writes each finished row straight to device memory,
//    so nothing follows it.
// Each step keeps the plain version's operations and their order, and with
// --fmad=false and no fast math the result matches it bit for bit.
//
// Input: nine device pointers, v0, a0, a_min, a_max, j_min, j_max, v_min,
// step (one float each) and lim_v (H).  Output: (H, 2) rows of [velocity,
// acceleration].  The PROF = true instantiation also writes thread 0's
// clock64() cycles per phase (enum Phase) and returns the same bits.
//
// The start mode (`start_mode`, entry rstp_rampify_scan_start) is the
// poly chain's rampify_device (tpl_tpu/planning/dyn_prog/
// poly_chain_kernel.py:227-273), ops.profile.rampify_profile with
// v0 = a0 = None: the same two recurrences over the whole horizon (T = H),
// but the forward scan starts from the backward scan's own end state
// (v, -a) instead of (max(v0, v_min), a0), and row 0 of the backward
// profile is that v.  v0 and a0 are not read.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "smem_limit.cuh"

namespace rstp_rampify {

constexpr int THREADS = 128;

// the phases of one scan, in the order rstp_rampify.py PHASES names them
enum Phase { PH_STAGE, PH_BACKWARD, PH_FORWARD_STAGE, PH_FORWARD, N_PHASE };

struct Args {
  const float *v0, *a0, *a_min, *a_max, *j_min, *j_max, *v_min, *step, *lim_v;
};

__device__ __forceinline__ float mx(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : (a > b ? a : b));
#endif
}

__device__ __forceinline__ float mn(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : (a < b ? a : b));
#endif
}

// x / step.  A profile that follows its limit hands the scans a zero
// numerator on most steps, and a zero numerator sends the IEEE division
// down its slow path (a call of some 140 cycles).  Its quotient by a
// positive finite step (`plain_step`) is that zero, sign included, so it is
// returned without the division.
__device__ __forceinline__ float div_step(float x, float step,
                                          bool plain_step) {
  if (x == 0.0f && plain_step) return x;
  return x / step;
}

__host__ __device__ inline size_t smem_floats(int H) {
  // lim, the backward rows v and a, the two staged branch results
  return (size_t)5 * H;
}

template <bool PROF>
__global__ void __launch_bounds__(THREADS)
rstp_rampify_kernel(Args in, float* __restrict__ out,
                    long long* __restrict__ prof, int H, int T,
                    bool start_mode) {
  __shared__ float start_a;   // start mode: the forward scan's first a
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lim = reinterpret_cast<float*>(smem_raw);
  float* bv = lim + H;      // row t: the backward carry before step t
  float* ba = bv + H;
  float* bz = ba + H;       // row t: backward step t's v where lim_a >= 0
  float* fz = bz + H;       // row t: forward step t's v where lim_a <= 0
  const int tid = threadIdx.x;
  long long clk = 0;
  if (PROF && tid == 0) clk = clock64();
  auto stamp = [&](int phase) {
    if (PROF && tid == 0) {
      const long long now = clock64();
      prof[phase] = now - clk;
      clk = now;
    }
  };

  const float v_min = *in.v_min, step = *in.step;
  const bool plain_step = step > 0.0f && step < INFINITY;
  for (int t = tid; t < H; t += blockDim.x)
    lim[t] = mx(t < T ? in.lim_v[t] : in.lim_v[T - 1], v_min);
  __syncthreads();
  // backward step t with the acceleration reset: ca = 0, cv = lim[t]
  for (int t = 1 + tid; t < H; t += blockDim.x) {
    const float cv = lim[t];
    bz[t] = cv + mn(-0.0f / cv * step, lim[t - 1] - cv);
  }
  __syncthreads();
  stamp(PH_STAGE);

  if (tid == 0) {
    const float a_min = *in.a_min, j_min = *in.j_min;
    // backward pass over t = H-1 .. 1; row t keeps the carry before step t
    float cv = lim[H - 1], ca = 0.0f;
    float lim_tm1 = lim[H - 2], reset_v = bz[H - 1];
    for (int t = H - 1; t > 0; --t) {
      // the next step's staged values, a step ahead of their use
      const float next_lim = lim[t > 1 ? t - 2 : 0];
      const float next_reset = bz[t > 1 ? t - 1 : 1];
      bv[t] = cv;
      ba[t] = ca;
      const float d_lim = div_step(cv - lim_tm1, step, plain_step);
      const float lim_a = mx(a_min, d_lim * cv);
      if (lim_a < 0.0f) {
        ca = mx(ca + j_min / cv * step, lim_a);
        cv = cv + mn(-ca / cv * step, lim_tm1 - cv);
      } else {
        ca = 0.0f;
        cv = reset_v;
      }
      lim_tm1 = next_lim;
      reset_v = next_reset;
    }
    if (start_mode) {
      bv[0] = cv;
      start_a = -ca;
    } else {
      bv[0] = mx(*in.v0, v_min);
    }
  }
  __syncthreads();
  stamp(PH_BACKWARD);

  // forward step t with the acceleration reset: ca = 0, cv = bv[t]
  for (int t = tid; t < H; t += blockDim.x) {
    const float pv = bv[t];
    fz[t] = mn(pv, pv + mn(0.0f / pv * step, lim[t] - pv));
  }
  __syncthreads();
  stamp(PH_FORWARD_STAGE);

  if (tid == 0) {
    const float a_max = *in.a_max, j_max = *in.j_max;
    float2* rows = reinterpret_cast<float2*>(out);
    float cv = bv[0], ca = start_mode ? start_a : *in.a0;
    float pv_t = cv, pv_tp1 = bv[1], lim_t = lim[0], reset_v = fz[0];
    float lim_a = 0.0f;
    // step t; the last one keeps the limit of the step before it (its own
    // call, so that the scan's loop carries no test for it)
    auto step_at = [&](int t, bool last) {
      const float next_pv = bv[t + 2 < H ? t + 2 : H - 1];
      const float next_lim = lim[t + 1 < H ? t + 1 : H - 1];
      const float next_reset = fz[t + 1 < H ? t + 1 : H - 1];
      if (!last)
        lim_a = mn(a_max, div_step(pv_tp1 - cv, step, plain_step) * cv);
      if (lim_a > 0.0f) {
        ca = mn(ca + j_max / cv * step, lim_a);
        cv = mn(pv_t, cv + mn(ca / cv * step, lim_t - cv));
      } else {
        ca = 0.0f;
        cv = reset_v;
      }
      rows[t] = make_float2(cv, ca);
      pv_t = pv_tp1;
      pv_tp1 = next_pv;
      lim_t = next_lim;
      reset_v = next_reset;
    };
    for (int t = 0; t < H - 1; ++t) step_at(t, false);
    step_at(H - 1, true);
  }
  stamp(PH_FORWARD);
}

}  // namespace rstp_rampify

extern "C" size_t rstp_rampify_smem_bytes(int H) {
  return rstp_rampify::smem_floats(H) * sizeof(float);
}

extern "C" int rstp_rampify_n_phases() { return rstp_rampify::N_PHASE; }

#ifdef __CUDACC__
namespace rstp_rampify {

template <bool PROF>
int launch(const Args& in, float* out, long long* prof, int H, int T,
           bool start_mode, void* stream) {
  // the dynamic shared-memory limit is raised once per device and size
  // (smem_limit.cuh), not on every launch
  static smem_limit::Marks marks;
  const size_t smem = rstp_rampify_smem_bytes(H);
  cudaError_t err = smem_limit::ensure(rstp_rampify_kernel<PROF>, smem, marks);
  if (err != cudaSuccess) return (int)err;
  rstp_rampify_kernel<PROF><<<1, THREADS, smem, (cudaStream_t)stream>>>(
      in, out, prof, H, T, start_mode);
  return (int)cudaGetLastError();
}

}  // namespace rstp_rampify

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// allocates nothing and does not synchronise.  `in` holds the nine input
// pointers in the order of rstp_rampify::Args.
extern "C" int rstp_rampify_scan(const float* const* in, float* out, int H,
                                 int T, void* stream) {
  const rstp_rampify::Args a = {in[0], in[1], in[2], in[3], in[4],
                                in[5], in[6], in[7], in[8]};
  return rstp_rampify::launch<false>(a, out, nullptr, H, T, false, stream);
}

// The start mode over the whole horizon (T = H); `in` as above, its v0 and
// a0 not read.
extern "C" int rstp_rampify_scan_start(const float* const* in, float* out,
                                       int H, void* stream) {
  const rstp_rampify::Args a = {in[0], in[1], in[2], in[3], in[4],
                                in[5], in[6], in[7], in[8]};
  return rstp_rampify::launch<false>(a, out, nullptr, H, H, true, stream);
}

// The same with the phase clock: `prof` receives N_PHASE cycle counts.
extern "C" int rstp_rampify_profile(const float* const* in, float* out,
                                    long long* prof, int H, int T,
                                    void* stream) {
  const rstp_rampify::Args a = {in[0], in[1], in[2], in[3], in[4],
                                in[5], in[6], in[7], in[8]};
  return rstp_rampify::launch<true>(a, out, prof, H, T, false, stream);
}
#endif

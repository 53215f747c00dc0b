// Dependent-chain latencies of the operations the scan kernels are made of,
// measured on the card: one thread runs N_OPS dependent operations of each
// type between two clock64() reads.  The cycles per operation feed
// chain_ms, the critical-path bound of ilqr_tracking_mpc.cu, ilqr_rstp.cu
// and rstp_rampify.cu (tpl_tpu_torch/_latency.py).  Replaces no TPU kernel.
// A second kernel counts the arguments at which sincos() and sin(), cos()
// differ (sincos_check).
//
// Two more probes run four independent add chains side by side: their
// cycles per instruction are the rate at which one warp starts independent
// work, the other limit of a kernel whose critical path sits on one warp.
//
// Output: cycles[N_PROBE] (the whole chain's clock64() difference per probe,
// in the order of enum Probe) and sink[N_PROBE] (each chain's last value,
// so that no chain is optimised away).  Built like the kernels: no fast
// math, --fmad=false.

#include <cuda_runtime.h>
#include <math.h>

namespace latency_probe {

constexpr int N_OPS = 4096;
constexpr int N_SMEM = 256;

// the order of tpl_tpu_torch/_latency.py PROBES
enum Probe {
  F32_ADD, F32_MUL, F32_DIV, F32_SIN, F32_COS, F32_ATAN, F32_FMOD,
  F64_ADD, F64_MUL, F64_DIV, F64_SIN, F64_COS, F64_TAN, F64_FMOD,
  SMEM_LOAD, F32_RATE, F64_RATE, N_PROBE
};

// one chain: x <- op(x, c), N_OPS times
#define CHAIN(id, T, x0, expr)                                   \
  {                                                              \
    T x = (T)(x0);                                               \
    const long long t0 = clock64();                              \
    _Pragma("unroll 16") for (int i = 0; i < n; ++i) x = (expr); \
    const long long t1 = clock64();                              \
    cycles[id] = t1 - t0;                                        \
    sink[id] = (double)x;                                        \
  }

__global__ void latency_probe_kernel(const double* __restrict__ seeds,
                                     long long* __restrict__ cycles,
                                     double* __restrict__ sink, int n) {
  __shared__ int next[N_SMEM];
  for (int i = 0; i < N_SMEM; ++i) next[i] = (i + 1) % N_SMEM;
  __syncthreads();
  // operands from memory, so that nothing folds at compile time
  const float cf = (float)seeds[0];       // 1 + 2^-20
  const double cd = seeds[0];
  const float af = (float)seeds[1];       // 2^-20
  const double ad = seeds[1];

  CHAIN(F32_ADD, float, 1.0f, x + af)
  CHAIN(F32_MUL, float, 1.0f, x * cf)
  CHAIN(F32_DIV, float, 1.0f, x / cf)
  CHAIN(F32_SIN, float, 1.0f, sinf(x))
  CHAIN(F32_COS, float, 1.0f, cosf(x))
  CHAIN(F32_ATAN, float, 1.0f, atanf(x))
  // the float32 instantiation's angle distance, like F64_FMOD below
  CHAIN(F32_FMOD, float, 1.0f, fmodf(x + cf, 6.2831855f))
  CHAIN(F64_ADD, double, 1.0, x + ad)
  CHAIN(F64_MUL, double, 1.0, x * cd)
  CHAIN(F64_DIV, double, 1.0, x / cd)
  CHAIN(F64_SIN, double, 1.0, sin(x))
  CHAIN(F64_COS, double, 1.0, cos(x))
  // tan(x) - x keeps the argument small (its own chain would run away);
  // the extra subtraction is taken off on the host
  CHAIN(F64_TAN, double, 0.5, tan(x) - x)
  // the floored-mod idiom of the tracking-MPC's angle distance, kept in
  // range by the added constant, which is taken off on the host
  CHAIN(F64_FMOD, double, 1.0, fmod(x + cd, 6.283185307179586))
  {
    int x = (int)seeds[2];                // 0
    const long long t0 = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) x = next[x];
    const long long t1 = clock64();
    cycles[SMEM_LOAD] = t1 - t0;
    sink[SMEM_LOAD] = (double)x;
  }
  // four independent chains: n / 4 rounds of 4 instructions
#define RATE(id, T, c)                                           \
  {                                                              \
    T x0 = (T)1, x1 = (T)2, x2 = (T)3, x3 = (T)4;                \
    const long long t0 = clock64();                              \
    _Pragma("unroll 4") for (int i = 0; i < n / 4; ++i) {        \
      x0 = x0 + (c);                                             \
      x1 = x1 + (c);                                             \
      x2 = x2 + (c);                                             \
      x3 = x3 + (c);                                             \
    }                                                            \
    const long long t1 = clock64();                              \
    cycles[id] = t1 - t0;                                        \
    sink[id] = (double)((x0 + x1) + (x2 + x3));                  \
  }
  RATE(F32_RATE, float, af)
  RATE(F64_RATE, double, ad)
}

// Arguments lo + i * step, i < n, at which sincos() and the pair sin(),
// cos() differ in any bit: the tracking-MPC kernel takes both of an angle
// in one sincos() call and relies on the count being zero.
__global__ void sincos_check_kernel(double lo, double step, int n,
                                    unsigned long long* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double x = lo + i * step;
  double s, c;
  sincos(x, &s, &c);
  if (__double_as_longlong(s) != __double_as_longlong(sin(x))
      || __double_as_longlong(c) != __double_as_longlong(cos(x)))
    atomicAdd(count, 1ull);
}

}  // namespace latency_probe

extern "C" int latency_probe_n_ops() { return latency_probe::N_OPS; }

#ifdef __CUDACC__
extern "C" int latency_probe_run(const double* seeds, long long* cycles,
                                 double* sink, void* stream) {
  latency_probe::latency_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      seeds, cycles, sink, latency_probe::N_OPS);
  return (int)cudaGetLastError();
}

extern "C" int sincos_check(double lo, double step, int n,
                            unsigned long long* count, void* stream) {
  latency_probe::sincos_check_kernel<<<(n + 255) / 256, 256, 0,
                                       (cudaStream_t)stream>>>(lo, step, n,
                                                               count);
  return (int)cudaGetLastError();
}
#endif

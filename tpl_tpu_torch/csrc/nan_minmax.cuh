// The NaN-passing minimum and maximum of a term.  torch.clamp,
// torch.maximum, torch.minimum and jnp.maximum / jnp.minimum keep a NaN
// operand, where fminf / fmaxf / fmin / fmax return the other one; on two
// numbers these give fminf / fmaxf's (fmin / fmax's) bits.  A clamp that
// forms an index keeps fminf / fmaxf, so that a NaN coordinate never becomes
// an address.  Under nvcc the float forms are the min.NaN / max.NaN
// instructions; the double forms, and the host stand-ins of the CPU
// rehearsal, test for the NaN.

#ifndef TPL_TPU_TORCH_NAN_MINMAX_CUH_
#define TPL_TPU_TORCH_NAN_MINMAX_CUH_

#include <cuda_runtime.h>
#include <math.h>

namespace nan_minmax {

__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : fminf(a, b));
#endif
}

__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : fmaxf(a, b));
#endif
}

__device__ __forceinline__ double min_nan(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

__device__ __forceinline__ double max_nan(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

}  // namespace nan_minmax

#endif  // TPL_TPU_TORCH_NAN_MINMAX_CUH_

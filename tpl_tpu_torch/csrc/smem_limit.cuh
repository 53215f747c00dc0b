// Raises a kernel's dynamic shared-memory limit once per device and size
// instead of on every launch.  cudaFuncSetAttribute applies to the current
// device, so the high-water marks are kept per device; a device beyond
// MAX_DEVICES is simply set on every launch.

#ifndef TPL_TPU_TORCH_SMEM_LIMIT_CUH_
#define TPL_TPU_TORCH_SMEM_LIMIT_CUH_

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __CUDACC__
namespace smem_limit {

constexpr int MAX_DEVICES = 16;

// the largest limit set so far for one kernel function, by device
struct Marks {
  size_t set[MAX_DEVICES] = {};
};

// makes `smem` bytes of dynamic shared memory available to `kernel` on the
// current device; returns the CUDA error code
template <class K>
inline cudaError_t ensure(K kernel, size_t smem, Marks& marks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < MAX_DEVICES;
  if (tracked && smem <= marks.set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && tracked) marks.set[dev] = smem;
  return err;
}

// loads `kernel`'s code onto the current device and raises its dynamic
// shared-memory limit to the most a block may use (the device's opt-in
// limit less the kernel's static shared memory), so that its first launch
// pays for neither; returns the CUDA error code
template <class K>
inline cudaError_t prepare(K kernel, Marks& marks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return ensure(kernel, (size_t)optin - attr.sharedSizeBytes, marks);
}

}  // namespace smem_limit
#endif  // __CUDACC__

#endif  // TPL_TPU_TORCH_SMEM_LIMIT_CUH_

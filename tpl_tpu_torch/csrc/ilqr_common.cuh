// Shared device helpers of the two iLQR kernels (ilqr_tracking_mpc.cu,
// ilqr_rstp.cu): the phase clock of their profiling instantiations and the
// one lane-exchange helper every warp-level exchange goes through (a CPU
// stand-in of the CUDA runtime supplies __shfl_sync / __syncwarp /
// __syncthreads / clock64 to run the kernel bodies on host threads).

#ifndef TPL_TPU_TORCH_ILQR_COMMON_CUH_
#define TPL_TPU_TORCH_ILQR_COMMON_CUH_

#include <cuda_runtime.h>

namespace ilqr_common {

constexpr int NA = 8;                    // line-search candidates
constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// the phases of one solve, in the order tpl_tpu_torch/optim/ilqr.py PHASES
// names them
enum Phase {
  PH_LOAD,        // packed input -> shared memory
  PH_INIT,        // initial rollout and its cost
  PH_LAM,         // multiplier update
  PH_DERIV,       // derivatives of every active step
  PH_RICCATI,     // backward pass
  PH_ROLLOUT,     // the 8 line-search rollouts
  PH_STEP_COST,   // per-step costs of the 8 candidates
  PH_COST_SUM,    // ordered cost sums
  PH_PICK,        // pick, mu schedule, copy of the accepted candidate
  PH_STORE,       // shared memory -> packed output
  N_PHASE
};

// Thread 0 accumulates clock64() differences per phase; the PROF = false
// instantiation carries no code and no registers for it.
template <bool PROF>
struct PhaseClock {
  long long last;
  long long acc[N_PHASE];

  __device__ __forceinline__ void start() {
    if constexpr (PROF) {
      if (threadIdx.x == 0) {
        for (int i = 0; i < N_PHASE; ++i) acc[i] = 0;
        last = clock64();
      }
    }
  }

  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (PROF) {
      if (threadIdx.x == 0) {
        const long long now = clock64();
        acc[phase] += now - last;
        last = now;
      }
    }
  }

  __device__ __forceinline__ void store(long long* out) const {
    if constexpr (PROF) {
      if (threadIdx.x == 0)
        for (int i = 0; i < N_PHASE; ++i) out[i] = acc[i];
    }
  }
};

// the value lane `src` of the calling warp holds (every lane of the warp
// calls it)
template <typename T>
__device__ __forceinline__ T lane_get(T v, int src) {
  return __shfl_sync(FULL_MASK, v, src);
}

}  // namespace ilqr_common

#endif  // TPL_TPU_TORCH_ILQR_COMMON_CUH_

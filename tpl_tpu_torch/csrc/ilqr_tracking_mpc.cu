// One full augmented-Lagrangian iLQR update of the spatial-progress
// tracking MPC (trajectory_tracking_mpc: nx=7, nu=2, nc=4) in one launch:
// one thread block of 8 warps per solve, and a grid of B blocks for a batch
// of B scenarios (ilqr_tracking_mpc_batched, one scenario per block, each
// with its own packed input, mu_step and result; no block waits for
// another).  The body (ilqr_tracking_mpc_body.cuh) is written over a type
// `real` and compiled twice: float64 (namespace ilqr_mpc: the tracking
// controller's solve and the batch) and float32 (namespace ilqr_mpc_f32:
// the batch at the precision the JAX package's bench runs it in).
//
// Replaces: the XLA programs the JAX package compiles from
// tpl_tpu/optim/ilqr.py:126 (make_update_fn, for the host CPU) and
// tpl_tpu/optim/batched.py:30 (make_batched_update_fn); there is no Pallas
// kernel for either.  Plain versions: tpl_tpu_torch/optim/ilqr.py
// make_update_fn, through tpl_tpu_torch/optim/ilqr_tracking_mpc.py
// update_reference, and tpl_tpu_torch/optim/batched.py.
//
// What bounds it on an H100: the latency of its dependent chain, not bytes
// (20 KB in and out) or operations (~6 MFLOP for 20 iterations, under a
// microsecond at the float64 peak).  Per iteration the algorithm fixes a
// chain of 60 Riccati steps, then 60 HEUN rollout steps of two dynamics
// evaluations each (divisions, a table lookup, sin / cos / tan in float64),
// then an ordered cost sum; chain_ms in
// tpl_tpu_torch/optim/ilqr_tracking_mpc.py prices that chain with the
// card's measured operation latencies (1.13 ms for 20 iterations at H=60).
// Whatever sits on one warp is bound a second time: a warp starts about one
// instruction every two cycles (csrc/latency_probe.cu), so the serial phases
// cost their instruction count, not only their dependent depth.  The design
// keeps everything that is not on the chain off it, gives the lanes of a
// warp the same instruction on different operands wherever the chain
// allows it, and keeps the whole solve in one block with every array in
// shared memory (one block per solve, which is what lets the batch map one
// scenario to one block):
//
// - derivatives: forward-mode numbers whose set of active variables is a
//   compile-time mask, so every structurally zero gradient and Hessian entry
//   costs nothing and no number leaves the registers.  Warps 0-1 take the
//   augmented cost's gradient and Hessian of step t (second order, each
//   term added into the step's block in shared memory in the plain order),
//   warps 2-3 the dynamics' Jacobian (first order), side by side.  Each
//   entry is the dense expression with its exact-zero terms left out, which
//   is the same value;
// - Riccati backward pass: warp 0 alone, 4 __syncwarp() per step and no
//   block barrier inside the t-loop.  The 72 + 67 dot products of 7 are
//   described once per lane as offsets and strides (struct Dot), so every
//   lane runs the same branch-free code, each dot product in ascending-k
//   order; the nu = 2 solve is formed by every lane, the value update by the
//   lane that owns the entry;
// - line search: warp c owns candidate alpha = 10^-c.  All its lanes step
//   the rollout in lock step on the same values; where a step needs the same
//   function of several arguments, different lanes take them in one call
//   and hand the results round by lane_get(): the two sines and three
//   cosines of an evaluation (one sincos call instead of five calls),
//   and the yaw rates of both HEUN evaluations (one tan and two divisions
//   instead of two and four; they depend on (v, delta) alone, whose rates
//   are known before the first evaluation).  The warp then takes its
//   candidate's 60 step costs over its lanes and lane 0 sums them in step
//   order, with no block barrier in between;
// - the angle distance between neighbouring reference headings (a floored
//   mod) depends on the table alone and is tabulated once per launch;
// - the pick, the mu schedule and the termination test are computed by
//   every thread from the 8 sums, so an iteration has 4 block barriers.
//
// On an NVIDIA H100 80GB HBM3 (700 W, SM 1980 MHz) an iteration at H=60
// takes 139 us (derivatives 6, Riccati 36, rollouts 94, costs and pick 3)
// and the 20-iteration solve 2.81 ms; the design before it (one lane per
// rollout, five block barriers per Riccati step, dense second-order
// numbers on 60 threads) took 246 us and 5.01 ms, with identical results
// (chip_smoke.py --parent-csrc holds two versions against each other).
//
// Every sum runs in a fixed order, so the result is deterministic.  Table
// lookups keep the genopt-parity derivative rule: slope v1 - v0 between the
// clamped floor / ceil indices, no curvature in the query.  Built without
// fast math and with --fmad=false.  Input and output layouts: see
// tpl_tpu_torch/optim/ilqr_tracking_mpc.py (input_layout, unpack_outputs).
// The PROF = true instantiation also returns thread 0's clock64() cycles per
// phase; its results are bit-equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ilqr_common.cuh"
#include "smem_limit.cuh"

#define ILQR_MPC_NS ilqr_mpc
#define ILQR_MPC_REAL double
#include "ilqr_tracking_mpc_body.cuh"
#undef ILQR_MPC_NS
#undef ILQR_MPC_REAL

#define ILQR_MPC_NS ilqr_mpc_f32
#define ILQR_MPC_REAL float
#include "ilqr_tracking_mpc_body.cuh"
#undef ILQR_MPC_NS
#undef ILQR_MPC_REAL

// dynamic shared memory of one block, float64 (f32 == 0) or float32
extern "C" size_t ilqr_tracking_mpc_smem_bytes(int H, int n_ref, int f32) {
  return f32 ? ilqr_mpc_f32::carve(nullptr, H, n_ref, nullptr)
             : ilqr_mpc::carve(nullptr, H, n_ref, nullptr);
}

#ifdef __CUDACC__
template <class real, bool PROF>
static auto kernel_of() {
  if constexpr (sizeof(real) == sizeof(float))
    return ilqr_mpc_f32::ilqr_tracking_mpc_kernel<PROF>;
  else
    return ilqr_mpc::ilqr_tracking_mpc_kernel<PROF>;
}

// The dynamic shared-memory limit is raised once per kernel function
// (precision, profiling or not), device and size (smem_limit.cuh), not on
// every launch; the marks belong to the kernel function, whichever entry
// launches it.
template <class real, bool PROF>
static int launch(int blocks, const real* in, real* out, long long* prof,
                  const int* mu_steps, int H, int n_ref, int T, int max_it,
                  int max_lg, int mu_step, int integrator, void* stream) {
  static smem_limit::Marks marks;
  auto kernel = kernel_of<real, PROF>();
  const size_t smem = ilqr_tracking_mpc_smem_bytes(
      H, n_ref, sizeof(real) == sizeof(float));
  cudaError_t err = smem_limit::ensure(kernel, smem, marks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, ilqr_common::THREADS, smem, (cudaStream_t)stream>>>(
      in, out, prof, mu_steps, H, n_ref, T, max_it, max_lg, mu_step,
      integrator);
  return (int)cudaGetLastError();
}

extern "C" int ilqr_tracking_mpc(const double* in, double* out, int H,
                                 int n_ref, int T, int max_it, int max_lg,
                                 int mu_step, int integrator, void* stream) {
  return launch<double, false>(1, in, out, nullptr, nullptr, H, n_ref, T,
                               max_it, max_lg, mu_step, integrator, stream);
}

// the profiling instantiation: the same solve, and thread 0's clock64()
// cycles per phase (ilqr_common::Phase) into prof[N_PHASE]; one block
extern "C" int ilqr_tracking_mpc_profile(const double* in, double* out,
                                         long long* prof, int H, int n_ref,
                                         int T, int max_it, int max_lg,
                                         int mu_step, int integrator,
                                         void* stream) {
  return launch<double, true>(1, in, out, prof, nullptr, H, n_ref, T, max_it,
                              max_lg, mu_step, integrator, stream);
}

// A batch of B scenarios, one block each: `in` holds B packed inputs and
// `out` B packed results one after the other (float64, or float32 when f32
// is set), mu_steps[b] is scenario b's starting mu_step.
extern "C" int ilqr_tracking_mpc_batched(const void* in, void* out,
                                         const int* mu_steps, int B, int H,
                                         int n_ref, int T, int max_it,
                                         int max_lg, int integrator, int f32,
                                         void* stream) {
  if (B <= 0 || mu_steps == nullptr) return (int)cudaErrorInvalidValue;
  if (f32)
    return launch<float, false>(B, (const float*)in, (float*)out, nullptr,
                                mu_steps, H, n_ref, T, max_it, max_lg, 0,
                                integrator, stream);
  return launch<double, false>(B, (const double*)in, (double*)out, nullptr,
                               mu_steps, H, n_ref, T, max_it, max_lg, 0,
                               integrator, stream);
}

template <class real>
static int blocks_per_sm(int H, int n_ref) {
  auto kernel = kernel_of<real, false>();
  const size_t smem = ilqr_tracking_mpc_smem_bytes(
      H, n_ref, sizeof(real) == sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, ilqr_common::THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// blocks of the batched kernel that one SM holds at a time (the occupancy
// calculator's answer for THREADS threads and the solve's shared memory),
// or a negative CUDA error code
extern "C" int ilqr_tracking_mpc_blocks_per_sm(int H, int n_ref, int f32) {
  return f32 ? blocks_per_sm<float>(H, n_ref)
             : blocks_per_sm<double>(H, n_ref);
}
#endif

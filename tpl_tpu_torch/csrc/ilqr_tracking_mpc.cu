// One full augmented-Lagrangian iLQR update of the spatial-progress
// tracking MPC (trajectory_tracking_mpc: nx=7, nu=2, nc=4) in one launch:
// one thread block of 8 warps per solve (ilqr_tracking_mpc, the tracking
// controller's solve every tick, designed for the latency of one solve),
// and for a batch of B scenarios a persistent kernel with a warp per
// scenario (ilqr_tracking_mpc_batched, designed for solves per second; see
// "the batched kernel" in the body).  The body (ilqr_tracking_mpc_body.cuh)
// is written over a type `real` and compiled twice: float64 (namespace
// ilqr_mpc: the controller's solve and the batch) and float32 (namespace
// ilqr_mpc_f32: the batch at the precision the JAX package's bench runs it
// in).
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
// shared memory:
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
// The batch (ilqr_tracking_mpc_batched) is paid per solve.  Each scenario is
// the chain above; B of them take as long as the scenarios resident at once
// let them, and the one-block-per-scenario design held one float64 solve
// per SM (130,544 B of shared memory), its other seven warps mostly waiting
// on warp 0's Riccati pass.  The batched kernel puts a scenario on a warp
// in a slot of 23,832 B (float64, H=60: compact derivative blocks for 16
// steps at a time, two candidate buffers that share their room with the
// backward pass's scratch) beside one copy of the tables a block, so an SM
// holds eight (registers cap it there); the occupancy calculator picks the
// slots a block (ilqr_tracking_mpc_batched_resident).  The line search
// rolls two candidates at a time (float32: four) and stops with the first
// improving one, so a search that succeeds with alpha = 1 or 0.1 takes one
// rollout's time, not eight rollouts' work.  A batch small enough that
// every scenario can have a block of its own at once (at most
// ilqr_tracking_mpc_batched_team scenarios per SM) would leave most warps
// idle that way: it takes the team geometry, a block of four warps a
// scenario (float32: two) that keep the single solve's dense derivative
// blocks, take them side by side and roll all eight candidates in one
// round, with the same bits.
//
// Every sum runs in a fixed order, so the result is deterministic.  Table
// lookups keep the genopt-parity derivative rule: slope v1 - v0 between the
// clamped floor / ceil indices, no curvature in the query.  Built without
// fast math and with --fmad=false.  Input and output layouts: see
// tpl_tpu_torch/optim/ilqr_tracking_mpc.py (input_layout, unpack_outputs).
// The PROF = true instantiations also return clock64() cycles per phase
// (the single solve's thread 0; the batch's warp on scenario 0); their
// results are bit-equal.

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

// the H100's dynamic shared memory a block can opt into
constexpr size_t SMEM_OPTIN = 232448;

// dynamic shared memory of one block, float64 (f32 == 0) or float32
extern "C" size_t ilqr_tracking_mpc_smem_bytes(int H, int n_ref, int f32) {
  return f32 ? ilqr_mpc_f32::carve(nullptr, H, n_ref, nullptr)
             : ilqr_mpc::carve(nullptr, H, n_ref, nullptr);
}

// the batch's shared memory: a block's shared part (what == 0) or one
// slot, a scenario's region (what == 1), in bytes
extern "C" size_t ilqr_tracking_mpc_batched_bytes(int H, int n_ref, int f32,
                                                 int what) {
  if (f32)
    return what ? ilqr_mpc_f32::batch_slot_reals(H) * sizeof(float)
                : ilqr_mpc_f32::batch_shared_reals(H, n_ref) * sizeof(float);
  return what ? ilqr_mpc::batch_slot_reals(H) * sizeof(double)
              : ilqr_mpc::batch_shared_reals(H, n_ref) * sizeof(double);
}

// dynamic shared memory of a block of the team geometry (one scenario)
extern "C" size_t ilqr_tracking_mpc_team_bytes(int H, int n_ref, int f32) {
  return f32 ? ilqr_mpc_f32::team_smem_bytes(H, n_ref)
             : ilqr_mpc::team_smem_bytes(H, n_ref);
}

// the most slots a block of the batched kernel can have (shared memory and
// MAX_SLOTS)
extern "C" int ilqr_tracking_mpc_batched_max_slots(int H, int n_ref,
                                                   int f32) {
  const size_t shared = ilqr_tracking_mpc_batched_bytes(H, n_ref, f32, 0);
  const size_t slot = ilqr_tracking_mpc_batched_bytes(H, n_ref, f32, 1);
  if (shared + slot > SMEM_OPTIN) return 0;
  const size_t n = (SMEM_OPTIN - shared) / slot;
  return n < (size_t)ilqr_mpc::MAX_SLOTS ? (int)n : ilqr_mpc::MAX_SLOTS;
}

// The grid of a batch of B on `sms` SMs, when a block of `slots` scenarios
// is the size at which an SM holds the most (`per_sm` such blocks): a batch
// that fills fewer than every SM's first block spreads over the SMs, a
// block per SM with ceil(B / sms) slots; a larger one runs at most the
// resident blocks, whose warps take the scenarios in turn.
extern "C" void ilqr_tracking_mpc_batched_grid(int B, int sms, int slots,
                                               int per_sm, int* block_slots,
                                               int* grid) {
  const int spread = (B + sms - 1) / sms;
  const int s = spread < slots ? spread : slots;
  const int blocks = (B + s - 1) / s;
  *block_slots = s;
  *grid = s < slots || blocks < sms * per_sm ? blocks : sms * per_sm;
}

#ifdef __CUDACC__
template <class real, bool PROF>
static auto kernel_of() {
  if constexpr (sizeof(real) == sizeof(float))
    return ilqr_mpc_f32::ilqr_tracking_mpc_kernel<PROF>;
  else
    return ilqr_mpc::ilqr_tracking_mpc_kernel<PROF>;
}

template <class real, bool PROF>
static auto batched_kernel_of() {
  if constexpr (sizeof(real) == sizeof(float))
    return ilqr_mpc_f32::ilqr_tracking_mpc_batched_kernel<PROF>;
  else
    return ilqr_mpc::ilqr_tracking_mpc_batched_kernel<PROF>;
}

template <class real, bool PROF>
static auto team_kernel_of() {
  if constexpr (sizeof(real) == sizeof(float))
    return ilqr_mpc_f32::ilqr_tracking_mpc_team_kernel<PROF>;
  else
    return ilqr_mpc::ilqr_tracking_mpc_team_kernel<PROF>;
}

template <class real>
constexpr int team_warps() {
  return sizeof(real) == sizeof(float) ? ilqr_mpc_f32::TEAM : ilqr_mpc::TEAM;
}

template <class real>
static size_t batched_smem(int H, int n_ref, int slots) {
  if constexpr (sizeof(real) == sizeof(float))
    return ilqr_mpc_f32::batch_smem_bytes(H, n_ref, slots);
  else
    return ilqr_mpc::batch_smem_bytes(H, n_ref, slots);
}

// The dynamic shared-memory limit is raised once per kernel function
// (precision, profiling or not), device and size (smem_limit.cuh), not on
// every launch.
template <bool PROF>
static int launch(const double* in, double* out, long long* prof, int H,
                  int n_ref, int T, int max_it, int max_lg, int mu_step,
                  int integrator, void* stream) {
  static smem_limit::Marks marks;
  auto kernel = kernel_of<double, PROF>();
  const size_t smem = ilqr_tracking_mpc_smem_bytes(H, n_ref, 0);
  cudaError_t err = smem_limit::ensure(kernel, smem, marks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, ilqr_common::THREADS, smem, (cudaStream_t)stream>>>(
      in, out, prof, H, n_ref, T, max_it, max_lg, mu_step, integrator);
  return (int)cudaGetLastError();
}

extern "C" int ilqr_tracking_mpc(const double* in, double* out, int H,
                                 int n_ref, int T, int max_it, int max_lg,
                                 int mu_step, int integrator, void* stream) {
  return launch<false>(in, out, nullptr, H, n_ref, T, max_it, max_lg,
                       mu_step, integrator, stream);
}

// the profiling instantiation: the same solve, and thread 0's clock64()
// cycles per phase (ilqr_common::Phase) into prof[N_PHASE]; one block
extern "C" int ilqr_tracking_mpc_profile(const double* in, double* out,
                                         long long* prof, int H, int n_ref,
                                         int T, int max_it, int max_lg,
                                         int mu_step, int integrator,
                                         void* stream) {
  return launch<true>(in, out, prof, H, n_ref, T, max_it, max_lg, mu_step,
                      integrator, stream);
}

// The batch's geometry on the current device: the slots a block whose SM
// holds the most scenarios (the occupancy calculator over 1 .. max_slots
// warps and their shared memory; a tie takes the larger block), how many
// such blocks an SM holds, and how many blocks of the team geometry (a
// block of TEAM warps a scenario) an SM holds (0: its shared memory does
// not fit).  Kept per device and shape.
struct Geometry {
  int dev = -1, H = 0, n_ref = 0, slots = 0, per_sm = 0, sms = 0, team = 0;
};

template <class real>
static cudaError_t geometry(int H, int n_ref, Geometry* g) {
  constexpr int f32 = sizeof(real) == sizeof(float);
  static Geometry cache[smem_limit::MAX_DEVICES];
  static smem_limit::Marks marks, prof_marks;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Geometry* c = dev >= 0 && dev < smem_limit::MAX_DEVICES ? &cache[dev]
                                                          : nullptr;
  if (c && c->dev == dev && c->H == H && c->n_ref == n_ref) {
    *g = *c;
    return cudaSuccess;
  }
  const int max_slots = ilqr_tracking_mpc_batched_max_slots(H, n_ref, f32);
  if (max_slots < 1) return cudaErrorInvalidValue;
  auto kernel = batched_kernel_of<real, false>();
  const size_t most = batched_smem<real>(H, n_ref, max_slots);
  err = smem_limit::ensure(kernel, most, marks);
  if (err == cudaSuccess)
    err = smem_limit::ensure(batched_kernel_of<real, true>(), most,
                             prof_marks);
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Geometry best;
  best.dev = dev;
  best.H = H;
  best.n_ref = n_ref;
  best.sms = sms;
  for (int s = 1; s <= max_slots; ++s) {
    const size_t smem = batched_smem<real>(H, n_ref, s);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, s * ilqr_common::WARP, smem);
    if (err != cudaSuccess) return err;
    if (blocks > 0 && s * blocks >= best.slots * best.per_sm) {
      best.slots = s;
      best.per_sm = blocks;
    }
  }
  if (best.slots == 0) return cudaErrorInvalidConfiguration;
  const size_t team_smem = ilqr_tracking_mpc_team_bytes(H, n_ref, f32);
  if (team_smem <= SMEM_OPTIN) {
    static smem_limit::Marks team_marks, team_prof_marks;
    auto team = team_kernel_of<real, false>();
    err = smem_limit::ensure(team, team_smem, team_marks);
    if (err == cudaSuccess)
      err = smem_limit::ensure(team_kernel_of<real, true>(), team_smem,
                               team_prof_marks);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &best.team, team, team_warps<real>() * ilqr_common::WARP,
          team_smem);
    if (err != cudaSuccess) return err;
  }
  if (c) *c = best;
  *g = best;
  return cudaSuccess;
}

template <class real, bool PROF>
static int launch_batched(const void* shared, const void* rows, void* out,
                          const int* mu_steps, int* work, long long* prof,
                          int B, int H, int n_ref, int T, int max_it,
                          int max_lg, int integrator, void* stream) {
  if (B <= 0 || mu_steps == nullptr || work == nullptr)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  cudaError_t err = geometry<real>(H, n_ref, &g);
  if (err != cudaSuccess) return (int)err;
  auto st = (cudaStream_t)stream;
  err = cudaMemsetAsync(work, 0, sizeof(int), st);
  constexpr int n_prof = (sizeof(real) == sizeof(float)
                              ? ilqr_mpc_f32::N_BPHASE
                              : ilqr_mpc::N_BPHASE) + ilqr_common::NA;
  if (err == cudaSuccess && PROF)
    err = cudaMemsetAsync(prof, 0, sizeof(long long) * n_prof, st);
  if (err != cudaSuccess) return (int)err;
  if (B <= g.sms * g.team) {      // every scenario a team at once
    team_kernel_of<real, PROF>()<<<B, team_warps<real>() * ilqr_common::WARP,
                                   ilqr_tracking_mpc_team_bytes(
                                       H, n_ref, sizeof(real) == 4),
                                   st>>>(
        (const real*)shared, (const real*)rows, (real*)out, mu_steps, prof, B,
        H, n_ref, T, max_it, max_lg, integrator);
    return (int)cudaGetLastError();
  }
  int slots = 0, grid = 0;
  ilqr_tracking_mpc_batched_grid(B, g.sms, g.slots, g.per_sm, &slots, &grid);
  const size_t smem = batched_smem<real>(H, n_ref, slots);
  batched_kernel_of<real, PROF>()<<<grid, slots * ilqr_common::WARP, smem,
                                    st>>>(
      (const real*)shared, (const real*)rows, (real*)out, mu_steps, work,
      prof, B, H, n_ref, T, max_it, max_lg, integrator);
  return (int)cudaGetLastError();
}

// A batch of B scenarios: `shared` the part every scenario shares, `rows`
// B rows, `out` B packed results one after the other (float64, or float32
// when f32 is set), mu_steps[b] scenario b's starting mu_step; `work` one
// int of scratch (zeroed here: the scenarios are taken through it).
extern "C" int ilqr_tracking_mpc_batched(const void* shared, const void* rows,
                                         void* out, const int* mu_steps,
                                         int* work, int B, int H, int n_ref,
                                         int T, int max_it, int max_lg,
                                         int integrator, int f32,
                                         void* stream) {
  return f32 ? launch_batched<float, false>(shared, rows, out, mu_steps, work,
                                            nullptr, B, H, n_ref, T, max_it,
                                            max_lg, integrator, stream)
             : launch_batched<double, false>(shared, rows, out, mu_steps,
                                             work, nullptr, B, H, n_ref, T,
                                             max_it, max_lg, integrator,
                                             stream);
}

// the profiling instantiation of the batch: the same results, the cycles of
// scenario 0's phases (ilqr_mpc::BatchPhase) in prof[0 .. N_BPHASE) and in
// prof[N_BPHASE + k] the line searches of the batch that rolled k + 1
// candidates (prof is zeroed here)
extern "C" int ilqr_tracking_mpc_batched_profile(
    const void* shared, const void* rows, void* out, const int* mu_steps,
    int* work, long long* prof, int B, int H, int n_ref, int T, int max_it,
    int max_lg, int integrator, int f32, void* stream) {
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
  return f32 ? launch_batched<float, true>(shared, rows, out, mu_steps, work,
                                           prof, B, H, n_ref, T, max_it,
                                           max_lg, integrator, stream)
             : launch_batched<double, true>(shared, rows, out, mu_steps, work,
                                            prof, B, H, n_ref, T, max_it,
                                            max_lg, integrator, stream);
}

// scenarios one SM holds at a time (slots a block x blocks an SM, the
// occupancy calculator's answer on the current device), the slots into
// *slots, or a negative CUDA error code
extern "C" int ilqr_tracking_mpc_batched_resident(int H, int n_ref, int f32,
                                                  int* slots) {
  Geometry g;
  const cudaError_t err = f32 ? geometry<float>(H, n_ref, &g)
                              : geometry<double>(H, n_ref, &g);
  if (err != cudaSuccess) return -(int)err;
  if (slots) *slots = g.slots;
  return g.slots * g.per_sm;
}

// scenarios one SM holds at a time in the team geometry (blocks of TEAM
// warps, the occupancy calculator's answer), 0 where its shared memory does
// not fit, or a negative CUDA error code: a batch of B <= this x the SMs
// takes the team geometry
extern "C" int ilqr_tracking_mpc_batched_team(int H, int n_ref, int f32) {
  Geometry g;
  const cudaError_t err = f32 ? geometry<float>(H, n_ref, &g)
                              : geometry<double>(H, n_ref, &g);
  return err != cudaSuccess ? -(int)err : g.team;
}
#endif

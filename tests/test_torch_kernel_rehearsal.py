"""A CPU rehearsal of the hand-written kernels' bodies.

There is no CUDA compiler and no card where these tests run, but the kernel
bodies are plain C++ once the CUDA runtime's few names are supplied.  The
fixture writes a stand-in ``cuda_runtime.h`` (``__syncthreads`` as a
``std::barrier`` over 256 ``std::thread``s, ``__syncwarp`` and
``__shfl_sync`` / ``__ballot_sync`` as a per-warp barrier and exchange,
``__ffs`` as a count of trailing zeros, ``clock64`` as a
counter, ``float2`` / ``float4``, a ``blockIdx`` and ``gridDim`` per
thread), compiles the
kernel sources of ``csrc/`` with ``g++ -std=c++20 -ffp-contract=off``
(their launchers sit under ``#ifdef __CUDACC__``; the asynchronous copy and
the NaN-passing max / min instructions have plain stand-ins under ``#ifndef
__CUDA_ARCH__``) and runs the bodies on host threads, the blocks of a grid
one after the other:

- the float64 tracking-MPC kernel on the ``_mpc_setup`` inputs and on a
  warm-started two-round solve,
- its batched launch on a grid of 4 blocks (one scenario per block): every
  block bit-equal to the single-block body on that scenario's row, and the
  batch against the plain float64 batched update
  (``tpl_tpu_torch/optim/batched.py``) at the same 1e-12; the float32
  instantiation of the same body on the same grid against the plain float32
  batched update at the float32 tolerance of
  tests/test_torch_kernel_cuda.py (x, lam atol 2e-2, traj_costs rtol
  1e-5, u 2e-2 on the scenarios whose mu_step and iteration count agree
  and 1e-1 elsewhere: where a float32 solve stops, and whether its last
  step is accepted, is decided by rounding),
- the time-indexed tracking-MPC kernel (``ilqr_tracking_mpc_time.cu``) on
  the seeded cases of ``scenes.mpc_time_case``: cold on a straight
  reference at UTM magnitude and on a curved one, warm-started for two
  multiplier rounds, and on a reference that ends inside the horizon,
- the RSTP kernel's template instantiated in double on a lateral and a
  velocity problem at H = 250,

each against the plain float64 ``make_update_fn`` at 1e-12 (atol + rtol;
the two keep the same operation order and differ only in how the
derivatives are formed and in libm's last bits), with equal ``mu_step`` and
iteration counts (float32 is not rehearsed for these: its stopping
iteration is decided by rounding, see tests/test_torch_kernel_cuda.py
RSTP_X_ATOL);

- the rampify scan against ``scan_reference`` (a NaN limit and ``v_min`` =
  0 among the cases) and its profiling instantiation,
- the DP action-min against ``action_min_reference`` on the card tests'
  three grids and at other tile heights,
- the fused backward slice against ``backward_slice_reference`` on every
  backward slice of a seeded scene,

each **bit for bit** in float32: these kernels keep the plain versions'
operations and their order; and the graph DP planner's directional field
(cell for cell, on a stretch of the JAX test scene and seeded occupancy),
its edge evaluation (bit for bit on both levels of three small graphs) and
its propagation (every selection, propagated cost and the trajectory, also
on seeded graphs with ties, NaN costs and edgeless nodes).  Grids and
graphs are kept small: every block costs barriers of 256 host threads,
which crawl when the machine is busy.

    python -m pytest tests/test_torch_kernel_rehearsal.py -q
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import tpl_tpu_torch
from tpl_tpu_torch import _build
from tpl_tpu_torch.optim import batched, ilqr, ilqr_rstp
from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm
from tpl_tpu_torch.optim import ilqr_tracking_mpc_time as itt
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as tllk
from tpl_tpu_torch.ops import splines
from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
from tpl_tpu_torch.planning.dyn_prog import lon_kernel as tlk
from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as plk
from tpl_tpu_torch.planning.dyn_prog import dp_environment as dpe
from tpl_tpu_torch.planning.dyn_prog import poly_planner_kernel as ppk
from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify
from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
from tpl_tpu_torch.planning.poly_sampling import poly_kernel as pok
from tpl_tpu_torch.planning.poly_sampling import poly_sampling_planner as psp

from tpl_tpu_torch import scenes
from tpl_tpu_torch.scenes import (dp_poly_buffers, dp_poly_env,
                                  dp_poly_propagation_case, dp_random_occ,
                                  idm_args, idm_hairpin_scene, idm_scene,
                                  idm_through_states,
                                  lon_nodes, lon_scene, poly_lat_scene,
                                  poly_scene)

ATOL = 1e-12
RTOL = 1e-12        # multipliers reach 1e2 and more (weight 1e4)
# the batched kernel's own new cases against the plain batched update:
# chip_smoke.py's BATCH_ATOL / BATCH_RTOL (each scenario is also held bit for
# bit to the single-block body, which is the check of the kernel)
BATCH_TOL = 1e-9
MPC_H = 60
RSTP_H = 250
RSTP_N_REF = 512

STUB = r"""
// a stand-in of the CUDA runtime for running kernel bodies on host threads
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct Dim3 { unsigned x, y, z; };
inline thread_local Dim3 threadIdx{0, 0, 0};
inline thread_local Dim3 blockIdx{0, 0, 0};
inline thread_local Dim3 gridDim{1, 1, 1};
inline Dim3 blockDim{256, 1, 1};      // set by the harness for a launch

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

namespace rehearsal {
constexpr int MAX_THREADS = 512, WARP = 32;
inline std::barrier<>* block_barrier = nullptr;   // the launch's block
inline std::barrier<> warp_barrier[MAX_THREADS / WARP] = {
    std::barrier<>(WARP), std::barrier<>(WARP), std::barrier<>(WARP),
    std::barrier<>(WARP), std::barrier<>(WARP), std::barrier<>(WARP),
    std::barrier<>(WARP), std::barrier<>(WARP), std::barrier<>(WARP),
    std::barrier<>(WARP), std::barrier<>(WARP), std::barrier<>(WARP),
    std::barrier<>(WARP), std::barrier<>(WARP), std::barrier<>(WARP),
    std::barrier<>(WARP)};
inline unsigned char exchange[MAX_THREADS / WARP][WARP][16];
}  // namespace rehearsal

inline void __syncthreads() { rehearsal::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  rehearsal::warp_barrier[threadIdx.x / 32].arrive_and_wait();
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  static_assert(sizeof(T) <= 16, "exchange slot");
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(rehearsal::exchange[w][lane], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r,
              rehearsal::exchange[w][(lane & ~(width - 1)) + (src & (width - 1))],
              sizeof(T));
  __syncwarp();
  return r;
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
  return __shfl_sync(mask, v, (int)(threadIdx.x % 32) ^ lane_mask);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned v = pred ? 1u : 0u;
  std::memcpy(rehearsal::exchange[w][lane], &v, sizeof(v));
  __syncwarp();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    unsigned b;
    std::memcpy(&b, rehearsal::exchange[w][i], sizeof(b));
    r |= b << i;
  }
  __syncwarp();
  return r;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline long long clock64() {
  static thread_local long long t = 0;
  return ++t;
}
"""

HARNESS = r"""
#include <thread>
#include <vector>
#include "ilqr_tracking_mpc.cu"
#include "ilqr_tracking_mpc_time.cu"
#include "ilqr_rstp.cu"
#include "rstp_rampify.cu"
#include "latlon_action_min.cu"
#include "lon_dp.cu"
#include "poly_lat.cu"
#include "idm_rollout.cu"
#include "idm_evaluate.cu"
#include "poly_sampling.cu"
#include "dir_dist_map.cu"
#include "poly_planner.cu"

// the kernels' dynamic shared memory (an extern array declared inside a
// function belongs to the function's namespace)
namespace ilqr_mpc { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_mpc_f32 { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_mpc_time { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_rstp { alignas(16) unsigned char smem_raw[262144]; }
namespace rstp_rampify { alignas(16) unsigned char smem_raw[65536]; }
namespace latlon_am { alignas(16) unsigned char smem_raw[262144]; }
namespace lon_dp { alignas(16) unsigned char smem_raw[4096]; }
namespace poly_lat { alignas(16) unsigned char smem_raw[65536]; }
namespace idm_rollout_k { alignas(16) unsigned char smem_raw[262144]; }
namespace idm_evaluate_k { alignas(16) unsigned char smem_raw[262144]; }
namespace poly_sampling_k { alignas(16) unsigned char smem_raw[65536]; }
namespace dir_dist { alignas(16) unsigned char smem_raw[65536]; }

// A grid of gx x gy blocks of `threads` threads (256 unless given): every
// host thread runs its thread of each block in turn (the blocks share the
// one shared-memory array, so they run one after the other, kept apart by
// a block barrier).
template <class F>
static void run_grid(unsigned gx, unsigned gy, F body,
                     unsigned threads = 256) {
  std::barrier<> block(threads);
  rehearsal::block_barrier = &block;
  blockDim = {threads, 1, 1};
  std::vector<std::thread> pool;
  for (unsigned i = 0; i < threads; ++i)
    pool.emplace_back([=] {
      threadIdx.x = i;
      gridDim = {gx, gy, 1};
      for (unsigned by = 0; by < gy; ++by)
        for (unsigned bx = 0; bx < gx; ++bx) {
          blockIdx.x = bx;
          blockIdx.y = by;
          body();
          __syncthreads();
        }
    });
  for (auto& t : pool) t.join();
}

template <class F>
static void run_block(F body) { run_grid(1, 1, body); }

extern "C" void rehearse_rampify(const float* scalars, const float* lim_v,
                                 float* out, long long* prof, int H, int T) {
  using namespace rstp_rampify;
  const Args in = {scalars, scalars + 1, scalars + 2, scalars + 3,
                   scalars + 4, scalars + 5, scalars + 6, scalars + 7, lim_v};
  run_block([=] {
    if (prof)
      rstp_rampify_kernel<true>(in, out, prof, H, T, false);
    else
      rstp_rampify_kernel<false>(in, out, nullptr, H, T, false);
  });
}

// the start mode (poly chain's rampify_device) over the whole horizon
extern "C" void rehearse_rampify_start(const float* scalars,
                                       const float* lim_v, float* out, int H) {
  using namespace rstp_rampify;
  const Args in = {scalars, scalars + 1, scalars + 2, scalars + 3,
                   scalars + 4, scalars + 5, scalars + 6, scalars + 7, lim_v};
  run_block([=] { rstp_rampify_kernel<false>(in, out, nullptr, H, H, true); });
}

extern "C" void rehearse_lon_backward(const float* nodes_next, const float* pp,
                                      const float* path,
                                      const float* dist_path, float* out,
                                      int S, int V, int A, int P, int t_idx,
                                      int is_last) {
  using namespace lon_dp;
  run_grid((S * V * A + THREADS - 1) / THREADS, 1, [=] {
    lon_backward_kernel(reinterpret_cast<const float4*>(nodes_next), pp, path,
                        dist_path, reinterpret_cast<float4*>(out), S, V, A, P,
                        t_idx, is_last != 0);
  });
}

extern "C" void rehearse_lon_forward(const float* nodes, const float* pp,
                                     const float* path, const float* dist_path,
                                     const float* states, float* out, int T,
                                     int S, int V, int A, int P, int n_rows,
                                     int mode) {
  using namespace lon_dp;
  run_block([=] {
    lon_forward_kernel(reinterpret_cast<const float4*>(nodes), pp, path,
                       dist_path, states, out, T, S, V, A, P, n_rows, mode);
  });
}

extern "C" void rehearse_poly_lat_sweep(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start, const double* inv,
    float* cd, double* tc, int LD, int SD, int S, int TE, int SE, int LE,
    int n_ref) {
  using namespace poly_lat;
  run_grid(LD * SD, 1, [=] {
    poly_lat_sweep_kernel(occ, ref_line, ref_step, pp, env, start, inv, cd, tc,
                          LD, SD, S, TE, SE, LE, n_ref);
  });
}

extern "C" void rehearse_poly_lat_select(const float* cd, const double* tc,
                                         const float* length_veh,
                                         long long* best, float* cost, int LD,
                                         int SD) {
  run_block([=] {
    poly_lat::poly_lat_select_kernel(cd, tc, length_veh, best, cost, LD, SD);
  });
}

// the IDM rollout on a grid of C / 8 blocks (a warp per candidate) or,
// split, of C / 4 (two warps per candidate); objs holds the ten object
// arrays in idm_kernel.OBJ_KEYS order
extern "C" void rehearse_idm_rollout(
    const float* init_ref, const float* init_con, const float* l_trgs,
    const float* d_stops, const float* dt_replan, const float* ref_line,
    const float* ref_step, const float* const* objs, const float* pp,
    float* out_ref, float* out_con, int C, int T, int NR, int O, int P,
    int K, int split) {
  using namespace idm_rollout_k;
  const Objs ob = {objs[0], objs[1], objs[2], objs[3], objs[4],
                   objs[5], objs[6], objs[7], objs[8], objs[9]};
  const int cands = split ? WARPS / 2 : WARPS;
  run_grid((C + cands - 1) / cands, 1, [=] {
    if (split)
      idm_rollout_kernel<true>(init_ref, init_con, l_trgs, d_stops,
                               dt_replan, ref_line, ref_step, ob, pp, out_ref,
                               out_con, C, T, NR, O, P, K);
    else
      idm_rollout_kernel<false>(init_ref, init_con, l_trgs, d_stops,
                                dt_replan, ref_line, ref_step, ob, pp,
                                out_ref, out_con, C, T, NR, O, P, K);
  });
}

// the packed parameters' keys as the two IDM kernels index them
extern "C" const char* rehearse_idm_param_keys() { return idm::PARAM_KEYS; }

// the IDM evaluation on the launcher's grid for `slots` resident blocks
// (persistent blocks walking batches of candidates)
extern "C" void rehearse_idm_evaluate(
    const float* refs, const float* states, const float* l_trgs,
    const float* const* objs, const float* ref_line, const float* ref_step,
    const float* pp, const float* l_trg_global, float* out, int C, int T,
    int NR, int O, int P, int K, int slots) {
  using namespace idm_evaluate_k;
  int cands = 0, grid = 0;
  idm_evaluate_grid(C, slots, max_cands(T, O, P), &cands, &grid);
  run_grid(grid, 1, [=] {
    idm_evaluate_kernel(refs, states, l_trgs, objs[0], objs[1], objs[3],
                        objs[4], objs[5], objs[7], objs[8], ref_line,
                        ref_step, pp, l_trg_global, out, C, T, NR, O, P, K,
                        cands);
  });
}

// the poly-sampling grid (a block per candidate) then its selection
extern "C" void rehearse_poly_sampling(
    const float* start, const float* di, const float* Ti, const float* tv,
    const float* ts, const float* path, const float* hulls,
    const float* valid, const float* pp, const double* inv, double* rows,
    double* costs, double* packed, double* cost, long long* best, int C,
    int N, int n_path, int O, int K) {
  using namespace poly_sampling_k;
  run_grid(C, 1, [=] {
    poly_sampling_eval_kernel(start, di, Ti, tv, ts, path, hulls, valid, pp,
                              inv, rows, costs, C, N, n_path, O, K);
  });
  run_block([=] {
    poly_sampling_select_kernel(rows, costs, packed, cost, best, C, N);
  });
}

// the directional distance field: a grid of S / S_TILE x T blocks
extern "C" void rehearse_dir_dist(const float* occ, const float* ray,
                                  float s_min, float s_step, float l_min,
                                  float l_step, float step, float* out, int T,
                                  int S, int L, int D, int R) {
  using namespace dir_dist;
  run_grid((S + S_TILE - 1) / S_TILE, T, [=] {
    dir_dist_kernel(occ, ray, s_min, s_step, l_min, l_step, step, out, S, L,
                    D, R);
  });
}

// one level's edge evaluation, a thread per edge; consts as the launcher's
extern "C" void rehearse_poly_eval(const float* start_pts,
                                   const int* edge_starts,
                                   const float* end_specs,
                                   const float* dir_dist, const float* ref_line,
                                   float* out, const float* consts, int E,
                                   int is_last, int R, int T, int S, int L,
                                   int D, int n_ref) {
  using namespace poly_planner_k;
  EvalParams p;
  std::memcpy(p.ev, consts, sizeof(p.ev));
  std::memcpy(p.m4, consts + N_EV, sizeof(p.m4));
  std::memcpy(p.h5, consts + N_EV + 25, sizeof(p.h5));
  run_grid((E + THREADS - 1) / THREADS, 1, [=] {
    eval_edges_kernel(start_pts, edge_starts, end_specs, dir_dist, ref_line,
                      out, p, E, is_last, R, T, S, L, D, n_ref);
  });
}

// the K propagation launches, the last level first; offs as the launcher's
extern "C" void rehearse_poly_propagate(const float* pts, double* node_cost,
                                        int* best, const int* seg,
                                        double* traj, const int* offs, int K) {
  using namespace poly_planner_k;
  Levels lv;
  std::memcpy(lv.node_off, offs, sizeof(lv.node_off));
  std::memcpy(lv.seg_off, offs + MAX_LEVELS + 2, sizeof(lv.seg_off));
  for (int k = K - 1; k >= 0; --k) {
    const int n = lv.node_off[k + 1] - lv.node_off[k];
    run_grid(n > 0 ? (n + WARPS - 1) / WARPS : 1, 1, [=] {
      propagate_kernel(pts, node_cost, best, seg, traj, lv, K, k);
    });
  }
}

static latlon_am::Tables tables_of(const void* const* t) {
  return latlon_am::Tables{
      (const int*)t[0], (const int*)t[1], (const int*)t[2],
      (const float*)t[3], (const float*)t[4], (const float*)t[5],
      (const float*)t[6], (const float*)t[7], (const float*)t[8],
      (const float*)t[9], (const float*)t[10]};
}

extern "C" void rehearse_action_min(
    const float* nodes_next, const float* state_cost,
    const float* state_constr, const float* d_fwd, const void* const* tables,
    float* out, int S, int DS, int L, int ts_rows) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid((S + ts_rows - 1) / ts_rows, DS, [=] {
    action_min_kernel<FEW_THREADS>(
        reinterpret_cast<const float4*>(nodes_next), state_cost, state_constr,
        d_fwd, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg, tb.qdds, tb.qdl,
        tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
        reinterpret_cast<float4*>(out), S, DS, L, ts_rows);
  });
}

extern "C" void rehearse_backward_slice(
    const float* nodes_next, const float* dist_t, const float* ref_line,
    const float* ref_step, const float* slice_consts,
    const void* const* tables, float* out, int S, int DS, int L, int n_ref,
    int slice, int ts_rows) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid((S + ts_rows - 1) / ts_rows, DS, [=] {
    backward_slice_kernel<FEW_THREADS>(
        reinterpret_cast<const float4*>(nodes_next), dist_t, ref_line,
        ref_step, slice_consts, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg, tb.qdds,
        tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
        reinterpret_cast<float4*>(out), S, DS, L, n_ref, slice, ts_rows);
  });
}

extern "C" void rehearse_mpc(const double* in, double* out, long long* prof,
                             int H, int n_ref, int T, int max_it, int max_lg,
                             int mu_step, int integrator) {
  run_block([=] {
    if (prof)
      ilqr_mpc::ilqr_tracking_mpc_kernel<true>(in, out, prof, H, n_ref, T,
                                               max_it, max_lg, mu_step,
                                               integrator);
    else
      ilqr_mpc::ilqr_tracking_mpc_kernel<false>(in, out, nullptr, H, n_ref,
                                                T, max_it, max_lg, mu_step,
                                                integrator);
  });
}

extern "C" void rehearse_mpc_time(const double* in, double* out, int H,
                                  int n_ref, int T, int max_it, int max_lg,
                                  int mu_step, int integrator) {
  run_block([=] {
    ilqr_mpc_time::ilqr_tracking_mpc_time_kernel(in, out, H, n_ref, T, max_it,
                                                 max_lg, mu_step, integrator);
  });
}

// the batched kernel on the launcher's grid for `sms` SMs of `per_sm`
// blocks of the largest block (ilqr_tracking_mpc_batched_grid), its warps
// taking the scenarios through the work counter; prof (may be null) as the
// profiling launcher's, zeroed by the caller; returns the slots a block
extern "C" int rehearse_mpc_batched(const void* shared, const void* rows,
                                    void* out, const int* mu_steps,
                                    long long* prof, int B, int H, int n_ref,
                                    int T, int max_it, int max_lg,
                                    int integrator, int f32, int sms,
                                    int per_sm) {
  int slots = 0, grid = 0, work = 0;
  ilqr_tracking_mpc_batched_grid(
      B, sms, ilqr_tracking_mpc_batched_max_slots(H, n_ref, f32), per_sm,
      &slots, &grid);
  int* w = &work;
  run_grid(grid, 1, [=] {
    if (f32 && prof)
      ilqr_mpc_f32::ilqr_tracking_mpc_batched_kernel<true>(
          (const float*)shared, (const float*)rows, (float*)out, mu_steps, w,
          prof, B, H, n_ref, T, max_it, max_lg, integrator);
    else if (f32)
      ilqr_mpc_f32::ilqr_tracking_mpc_batched_kernel<false>(
          (const float*)shared, (const float*)rows, (float*)out, mu_steps, w,
          nullptr, B, H, n_ref, T, max_it, max_lg, integrator);
    else if (prof)
      ilqr_mpc::ilqr_tracking_mpc_batched_kernel<true>(
          (const double*)shared, (const double*)rows, (double*)out, mu_steps,
          w, prof, B, H, n_ref, T, max_it, max_lg, integrator);
    else
      ilqr_mpc::ilqr_tracking_mpc_batched_kernel<false>(
          (const double*)shared, (const double*)rows, (double*)out, mu_steps,
          w, nullptr, B, H, n_ref, T, max_it, max_lg, integrator);
  }, slots * 32);
  return slots;
}

// the team geometry: a block of TEAM warps a scenario, a grid of B blocks
extern "C" void rehearse_mpc_team(const void* shared, const void* rows,
                                  void* out, const int* mu_steps,
                                  long long* prof, int B, int H, int n_ref,
                                  int T, int max_it, int max_lg,
                                  int integrator, int f32) {
  run_grid(B, 1, [=] {
    if (f32 && prof)
      ilqr_mpc_f32::ilqr_tracking_mpc_team_kernel<true>(
          (const float*)shared, (const float*)rows, (float*)out, mu_steps,
          prof, B, H, n_ref, T, max_it, max_lg, integrator);
    else if (f32)
      ilqr_mpc_f32::ilqr_tracking_mpc_team_kernel<false>(
          (const float*)shared, (const float*)rows, (float*)out, mu_steps,
          nullptr, B, H, n_ref, T, max_it, max_lg, integrator);
    else if (prof)
      ilqr_mpc::ilqr_tracking_mpc_team_kernel<true>(
          (const double*)shared, (const double*)rows, (double*)out, mu_steps,
          prof, B, H, n_ref, T, max_it, max_lg, integrator);
    else
      ilqr_mpc::ilqr_tracking_mpc_team_kernel<false>(
          (const double*)shared, (const double*)rows, (double*)out, mu_steps,
          nullptr, B, H, n_ref, T, max_it, max_lg, integrator);
  }, (f32 ? ilqr_mpc_f32::TEAM : ilqr_mpc::TEAM) * 32);
}

extern "C" void rehearse_rstp(int problem, const double* in, double* out,
                              int H, int n_ref, int T, int max_it,
                              int max_lg) {
  using namespace ilqr_rstp;
  double* smd = reinterpret_cast<double*>(smem_raw);
  run_block([=] {
    if (problem == 0)
      Solve<Lateral<double>, double>::run<false>(smd, in, out, nullptr, H,
                                                 n_ref, T, max_it, max_lg);
    else
      Solve<Velocity<double>, double>::run<false>(smd, in, out, nullptr, H,
                                                  n_ref, T, max_it, max_lg);
  });
}

extern "C" size_t rehearse_rstp_smem(int problem, int H, int n_ref) {
  using namespace ilqr_rstp;
  return problem == 0
      ? Solve<Lateral<double>, double>::carve(nullptr, H, n_ref, nullptr)
      : Solve<Velocity<double>, double>::carve(nullptr, H, n_ref, nullptr);
}
"""


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    """The two kernel bodies compiled for the host, as a ctypes library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies for the host")
    tmp = tmp_path_factory.mktemp("rehearsal")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "rehearsal.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-pthread", "-x", "c++", "-I", str(tmp), "-I", _build.CSRC,
           str(tmp / "harness.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.rehearse_mpc.restype = None
    lib.rehearse_mpc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.rehearse_mpc_time.restype = None
    lib.rehearse_mpc_time.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    lib.ilqr_tracking_mpc_time_smem_bytes.restype = ctypes.c_size_t
    lib.ilqr_tracking_mpc_time_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.rehearse_mpc_batched.restype = ctypes.c_int
    lib.rehearse_mpc_batched.argtypes = ([ctypes.c_void_p] * 5
                                         + [ctypes.c_int] * 10)
    lib.rehearse_mpc_team.restype = None
    lib.rehearse_mpc_team.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 8)
    lib.ilqr_tracking_mpc_team_bytes.restype = ctypes.c_size_t
    lib.ilqr_tracking_mpc_team_bytes.argtypes = [ctypes.c_int] * 3
    lib.ilqr_tracking_mpc_smem_bytes.restype = ctypes.c_size_t
    lib.ilqr_tracking_mpc_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ilqr_tracking_mpc_batched_bytes.restype = ctypes.c_size_t
    lib.ilqr_tracking_mpc_batched_bytes.argtypes = [ctypes.c_int] * 4
    lib.ilqr_tracking_mpc_batched_max_slots.restype = ctypes.c_int
    lib.ilqr_tracking_mpc_batched_max_slots.argtypes = [ctypes.c_int] * 3
    lib.rehearse_rstp.restype = None
    lib.rehearse_rstp.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                                  + [ctypes.c_int] * 5)
    lib.rehearse_rstp_smem.restype = ctypes.c_size_t
    lib.rehearse_rstp_smem.argtypes = [ctypes.c_int] * 3
    lib.rehearse_rampify.restype = None
    lib.rehearse_rampify.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.rehearse_rampify_start.restype = None
    lib.rehearse_rampify_start.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.rehearse_lon_backward.restype = None
    lib.rehearse_lon_backward.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 6)
    lib.rehearse_lon_forward.restype = None
    lib.rehearse_lon_forward.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 7)
    lib.rehearse_poly_lat_sweep.restype = None
    lib.rehearse_poly_lat_sweep.argtypes = ([ctypes.c_void_p] * 9
                                            + [ctypes.c_int] * 7)
    lib.rehearse_poly_lat_select.restype = None
    lib.rehearse_poly_lat_select.argtypes = ([ctypes.c_void_p] * 5
                                             + [ctypes.c_int] * 2)
    lib.rehearse_idm_rollout.restype = None
    lib.rehearse_idm_rollout.argtypes = ([ctypes.c_void_p] * 11
                                         + [ctypes.c_int] * 7)
    lib.idm_rollout_split.restype = ctypes.c_int
    lib.idm_rollout_split.argtypes = [ctypes.c_int]
    lib.rehearse_idm_evaluate.restype = None
    lib.rehearse_idm_evaluate.argtypes = ([ctypes.c_void_p] * 9
                                          + [ctypes.c_int] * 7)
    lib.idm_evaluate_grid.restype = None
    lib.idm_evaluate_grid.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.rehearse_poly_sampling.restype = None
    lib.rehearse_poly_sampling.argtypes = ([ctypes.c_void_p] * 15
                                           + [ctypes.c_int] * 5)
    lib.rehearse_action_min.restype = None
    lib.rehearse_action_min.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 4)
    lib.rehearse_backward_slice.restype = None
    lib.rehearse_backward_slice.argtypes = ([ctypes.c_void_p] * 7
                                            + [ctypes.c_int] * 6)
    lib.rehearse_dir_dist.restype = None
    lib.rehearse_dir_dist.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_float] * 5
                                      + [ctypes.c_void_p] + [ctypes.c_int] * 5)
    lib.rehearse_poly_eval.restype = None
    lib.rehearse_poly_eval.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 8)
    lib.rehearse_poly_propagate.restype = None
    lib.rehearse_poly_propagate.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int])
    lib.rstp_rampify_smem_bytes.restype = ctypes.c_size_t
    lib.rstp_rampify_smem_bytes.argtypes = [ctypes.c_int]
    lib.latlon_action_min_tile_rows.restype = ctypes.c_int
    lib.latlon_action_min_tile_rows.argtypes = [ctypes.c_int]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------
# the tracking-MPC kernel body

def mpc_params(rng=None):
    """The ``__graft_entry__._mpc_setup`` reference course and weights
    (with a seeded perturbation of the course when ``rng`` is given)."""
    ss = np.arange(128) * 0.5
    ref_y = 2.0 * np.sin(ss * 0.1)
    if rng is not None:
        ref_y = ref_y + np.cumsum(rng.normal(0.0, 0.02, 128))
    phi = np.arctan(np.gradient(ref_y, ss))
    return {"pd": 10.0, "pv": 5.0, "pdelta": 0.0, "min_pdelta_dot": 0.1,
            "pdelta_dot": 0.0, "min_p_phi_dot": 0.0, "p_phi_dot": 0.0,
            "p_phi": 0.01, "p_phi_ref_dot_diff": 0.01, "pa": 2.0,
            "pj": 0.5, "l": 3.165, "v_ch": 32.0, "ref_x": ss, "ref_y": ref_y,
            "ref_phi": phi, "ref_k": np.gradient(phi, ss),
            "ref_v": np.full(128, 8.0), "ref_step": 0.5, "max_delta": 0.7,
            "max_acc": 3.0, "min_acc": -3.0, "a_offset": 0.0}


def mpc_case(case):
    rng = np.random.default_rng(len(case))
    H = MPC_H
    x0 = [0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0]
    T, it, lg, mu = H, 20, 1, 0
    u, lam = np.zeros((H, 2)), np.zeros((H, 4))
    params = mpc_params()
    if case == "setup8":
        it = 8
    elif case == "warm":
        params = mpc_params(rng)
        x0 = [0.3, 1.4, 0.1, 0.05, 7.0, 0.2, 0.5]
        u = rng.normal(0.0, 0.3, (H, 2))
        mu = 2
    elif case == "lg2_T45":
        x0 = [0.3, -1.5, -0.1, 0.65, 9.0, 0.0, 2.9]
        u = rng.normal(0.0, 0.3, (H, 2))
        lam = rng.uniform(0.0, 1e-3, (H, 4))
        T, lg, mu = 45, 2, 1
    x = np.zeros((H + 1, 7))
    x[0] = x0
    inputs = dict(
        x=x, u=u, lam=lam,
        u_lims=np.tile(np.array([[[-3.0, 1.5], [-1.0, 1.0]]]), (H, 1, 1)),
        bw_lim=np.stack([np.full(4, 1e4), np.full(4, 1e30)], -1),
        cfg_f=np.array([0.05, 1e-6]))
    return itm.pack_inputs(inputs, params), (H, 128, T, it, lg, mu, ilqr.HEUN)


@pytest.mark.parametrize("case", ["setup8", "setup20", "warm", "lg2_T45"])
def test_mpc_kernel_body_matches_plain(bodies, case):
    host, args = mpc_case(case)
    H = args[0]
    out = np.zeros(ilqr.layout(itm.output_layout(H))[1])
    bodies.rehearse_mpc(_ptr(host), _ptr(out), None, *args)
    want = itm.update_reference(torch.from_numpy(host), *args).numpy()
    got, ref = itm.unpack_outputs(out, H), itm.unpack_outputs(want, H)
    for k in ("x", "u", "lam"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["traj_costs"], ref["traj_costs"],
                               rtol=1e-12)
    assert got["mu_step"] == ref["mu_step"]
    assert got["iterations"] == ref["iterations"]
    assert np.all(np.isfinite(got["x"]))


def test_mpc_profiling_body_is_bit_equal(bodies):
    """The profiling instantiation returns the same bits and a count for
    every phase."""
    host, args = mpc_case("setup8")
    n = ilqr.layout(itm.output_layout(args[0]))[1]
    out, prof_out = np.zeros(n), np.zeros(n)
    prof = np.zeros(len(ilqr.PHASES), np.int64)
    bodies.rehearse_mpc(_ptr(host), _ptr(out), None, *args)
    bodies.rehearse_mpc(_ptr(host), _ptr(prof_out), _ptr(prof), *args)
    assert np.array_equal(out, prof_out)
    assert np.all(prof > 0)


# ---------------------------------------------------------------------
# the time-indexed tracking-MPC kernel body


@pytest.mark.parametrize("kind", scenes.MPC_TIME_KINDS)
def test_mpc_time_kernel_body_matches_plain(bodies, kind):
    """A cold solve on a straight reference at UTM magnitude (centred) and
    on a curved one, a warm-started two-round solve, and a reference that
    ends inside the horizon, against the plain float64 update at 1e-12 with
    equal mu_step and iteration counts."""
    host, args = scenes.mpc_time_case(kind)
    H, n_ref = args[:2]
    assert bodies.ilqr_tracking_mpc_time_smem_bytes(H, n_ref) <= 227 * 1024
    out = np.zeros(ilqr.layout(itt.output_layout(H))[1])
    bodies.rehearse_mpc_time(_ptr(host), _ptr(out), *args)
    want = itt.update_reference(torch.from_numpy(host), *args).numpy()
    got, ref = itt.unpack_outputs(out, H), itt.unpack_outputs(want, H)
    for k in ("x", "u", "lam"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["traj_costs"], ref["traj_costs"],
                               rtol=1e-12)
    assert got["mu_step"] == ref["mu_step"]
    assert got["iterations"] == ref["iterations"]
    assert np.all(np.isfinite(got["x"]))
    if kind == "warm":
        assert np.any(got["lam"] > 0.0)


def mpc_batch(dtype, B=4, T=MPC_H, iterations=8, warm=True):
    """A seeded batch in the batched update's layout (CPU tensors): the
    ``_mpc_setup`` course and limits, starts spread as the bench spreads
    them and wider, warm controls, multipliers and mu_steps."""
    rng = np.random.default_rng(B + T)
    H = MPC_H
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
    x0 = (np.array([0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0])[:, None]
          + 0.01 * np.arange(B)[None, :]
          + rng.normal(0.0, 0.3, (7, B))
          * np.array([1, 1, 0.2, 0.1, 3, 0, 0.5])[:, None])
    u, lam = np.zeros((H, 2, B)), np.zeros((H, 4, B))
    mu = np.zeros(B, np.int32)
    if warm:
        u[..., 1:] = rng.normal(0.0, 0.3, (H, 2, B - 1))
        lam[..., 1:] = rng.uniform(0.0, 1e-3, (H, 4, B - 1))
        mu[1:] = rng.integers(0, 4, B - 1)
    x = np.zeros((H + 1, 7, B))
    x[0] = x0
    params = {k: t(v) for k, v in mpc_params().items()}
    cfg = dict(u_min=t(np.tile([-3.0, -1.0], (H, 1))),
               u_max=t(np.tile([1.5, 1.0], (H, 1))),
               barrier_weight=t(np.full(4, 1e4)),
               lg_mult_limit=t(np.full(4, 1e30)), dt=t(0.05),
               min_rel_cost_change=t(1e-6), T=T, max_iterations=iterations,
               max_lg_iterations=1)
    return (t(x), t(u), t(lam), torch.from_numpy(mu), t(x0)), params, cfg


def rehearse_batch(bodies, state, params, cfg, dtype, sms=2, prof=None):
    """The batched kernel on the launcher's grid for ``sms`` SMs of one
    block each, its warps taking the scenarios through the work counter;
    returns the packed ``(shared, rows)``, the packed result, the unpacked
    result and the slots a block."""
    x, u, lam, mu, x0 = state
    shared, rows = itm.pack_inputs_batched(x, u, lam, x0, params, cfg, dtype)
    B = rows.shape[0]
    assert rows.is_contiguous() and rows.dtype == shared.dtype == dtype
    n_out = ilqr.layout(itm.output_layout(MPC_H))[1]
    out = np.full((B, n_out), np.nan, rows.numpy().dtype)
    f32 = int(dtype == torch.float32)
    assert bodies.ilqr_tracking_mpc_batched_max_slots(MPC_H, 128, f32) >= 1
    slots = bodies.rehearse_mpc_batched(
        _ptr(shared.numpy()), _ptr(rows.numpy()), _ptr(out),
        _ptr(mu.numpy()), None if prof is None else _ptr(prof), B, MPC_H,
        128, cfg["T"], cfg["max_iterations"], 1, ilqr.HEUN, f32, sms, 1)
    return ((shared, rows), out,
            itm.unpack_outputs_batched(torch.from_numpy(out), MPC_H), slots)


def rehearse_team(bodies, packed, mu, cfg, prof=None):
    """The team geometry's kernel (a block of TEAM warps a scenario) on the
    packed batch: the packed result."""
    shared, rows = packed
    B = rows.shape[0]
    n_out = ilqr.layout(itm.output_layout(MPC_H))[1]
    out = np.full((B, n_out), np.nan, rows.numpy().dtype)
    bodies.rehearse_mpc_team(
        _ptr(shared.numpy()), _ptr(rows.numpy()), _ptr(out), _ptr(mu.numpy()),
        None if prof is None else _ptr(prof), B, MPC_H, 128, cfg["T"],
        cfg["max_iterations"], 1, ilqr.HEUN, int(rows.dtype == torch.float32))
    return out


def single_bodies(bodies, packed, mu, cfg):
    """The single-block body on every scenario's row of the batch
    (``rows_of_batch``): the (B, n_out) results."""
    rows = itm.rows_of_batch(*packed, MPC_H, 128).numpy()
    out = np.zeros((rows.shape[0], ilqr.layout(itm.output_layout(MPC_H))[1]))
    for b, row in enumerate(rows):
        bodies.rehearse_mpc(_ptr(row.copy()), _ptr(out[b]), None, MPC_H, 128,
                            cfg["T"], cfg["max_iterations"], 1, int(mu[b]),
                            ilqr.HEUN)
    return out


def plain_batch(state, params, cfg, dtype, per_instance=()):
    B = state[0].shape[-1]
    upd = batched.make_batched_update_fn(
        problems.trajectory_tracking_mpc(128)[0], MPC_H, B, ilqr.HEUN, dtype,
        per_instance=per_instance)
    return upd.reference(*state, params, cfg, iterations=True, rolled=True)


def assert_plain_f64(got, want, tol=ATOL):
    for name, g, w in zip(("x", "u", "lam"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), want[4].numpy(), rtol=tol)
    assert torch.equal(got[3], want[3]) and torch.equal(got[5], want[5])


@pytest.mark.parametrize("T,warm", [(MPC_H, True), (45, True),
                                    (MPC_H, False)])
def test_mpc_batched_body_float64(bodies, T, warm):
    """Each scenario of the batch returns the bits of the single-block body
    on its row, and the batch agrees with the plain batched update."""
    state, params, cfg = mpc_batch(torch.float64, T=T, warm=warm)
    packed, out, got, _ = rehearse_batch(bodies, state, params, cfg,
                                         torch.float64)
    B = out.shape[0]
    # row b of the split layout is scenario b's pack_inputs
    rows = itm.rows_of_batch(*packed, MPC_H, 128)
    x, u, lam, mu, x0 = state
    for b in (0, B - 1):
        row = itm.pack_inputs(
            dict(x=x[..., b].numpy(), u=u[..., b].numpy(),
                 lam=lam[..., b].numpy(),
                 u_lims=np.stack([cfg["u_min"].numpy(),
                                  cfg["u_max"].numpy()], -1),
                 bw_lim=np.stack([cfg["barrier_weight"].numpy(),
                                  cfg["lg_mult_limit"].numpy()], -1),
                 cfg_f=np.array([0.05, 1e-6])),
            {k: v.numpy() for k, v in params.items()})
        np.testing.assert_array_equal(rows[b].numpy(), row)
    single = single_bodies(bodies, packed, mu, cfg)
    for b in range(B):
        assert np.array_equal(out[b], single[b]), f"scenario {b}"
    want = plain_batch(state, params, cfg, torch.float64)
    assert_plain_f64(got, want)
    if warm:
        assert len(set(got[5].tolist())) > 1      # they stop at different
    assert np.all(np.isfinite(got[0].numpy()))    # iteration counts


@pytest.mark.parametrize("B,sms", [(1, 1), (5, 2), (9, 2)])
def test_mpc_batched_warps_take_the_scenarios_in_turn(bodies, B, sms):
    """Fewer warps than scenarios (B = 5 and 9 on a block of 3 and 5
    slots): every scenario is solved once, bit-equal to the single-block
    body on its row, whichever warp took it, and the batch agrees with the
    plain batched update to BATCH_TOL (a scenario of the B = 9 batch carries
    libm's last bits to 5e-12 over its iterations)."""
    state, params, cfg = mpc_batch(torch.float64, B=B)
    packed, out, got, slots = rehearse_batch(bodies, state, params, cfg,
                                             torch.float64, sms=sms)
    assert slots == -(-B // sms) and (B == 1 or B % slots)
    single = single_bodies(bodies, packed, state[3], cfg)
    for b in range(B):
        assert np.array_equal(out[b], single[b]), f"scenario {b}"
    assert_plain_f64(got, plain_batch(state, params, cfg, torch.float64),
                     BATCH_TOL)


def test_mpc_batched_search_without_improvement(bodies):
    """Scenario 1 weighs nothing (its cost is its multiplier terms), so
    after its first search no candidate improves: the search rolls all
    eight and mu_step climbs to 7.  With no relative-change stop every solve
    runs its 12 iterations.  The profiling instantiation returns the same
    bits, scenario 0's phases and the line searches by candidates rolled,
    which the plain version's count matches."""
    state, params, cfg = mpc_batch(torch.float64, B=3, iterations=12)
    cfg = dict(cfg, min_rel_cost_change=torch.tensor(0.0, dtype=torch.float64))
    weights = ("pd", "pv", "min_pdelta_dot", "p_phi", "p_phi_ref_dot_diff",
               "pa", "pj")
    for k in weights:
        params[k] = params[k] * torch.tensor([1.0, 0.0, 1.0],
                                             dtype=torch.float64)
    packed, out, got, _ = rehearse_batch(bodies, state, params, cfg,
                                         torch.float64)
    n = len(itm.batch_phases(torch.float64))
    prof = np.zeros(n + 8, np.int64)
    _, prof_out, _, _ = rehearse_batch(bodies, state, params, cfg,
                                       torch.float64, prof=prof)
    assert np.array_equal(out, prof_out)
    assert np.all(prof[:n][[0, 1, 2, 3, 4, 5, 6, n - 2, n - 1]] > 0)
    hist = prof[n:]
    want = plain_batch(state, params, cfg, torch.float64, weights)
    assert_plain_f64(got, want, BATCH_TOL)
    assert np.all(got[5].numpy() == 12)
    assert hist.sum() == 3 * 12 and hist[7] >= 11
    assert int((hist * np.arange(1, 9)).sum()) == int(want[6].sum())
    assert int(want[6][1]) >= 8 * 11 and int(got[3][1]) == 7
    single = single_bodies(bodies, packed, state[3], cfg)
    assert np.array_equal(out, single)


@pytest.mark.parametrize("T,warm", [(MPC_H, True), (45, True),
                                    (MPC_H, False)])
def test_mpc_team_body_float64(bodies, T, warm):
    """The team geometry (a block of four warps a scenario, every candidate
    in one round) returns, scenario for scenario, the bits of the
    warp-per-scenario kernel and of the single-block body on its row."""
    state, params, cfg = mpc_batch(torch.float64, T=T, warm=warm)
    packed, out, _, _ = rehearse_batch(bodies, state, params, cfg,
                                       torch.float64)
    team = rehearse_team(bodies, packed, state[3], cfg)
    assert np.array_equal(team, out)
    assert np.array_equal(team, single_bodies(bodies, packed, state[3], cfg))
    assert bodies.ilqr_tracking_mpc_team_bytes(MPC_H, 128, 0) <= 232448


def test_mpc_team_search_without_improvement(bodies):
    """The batch of test_mpc_batched_search_without_improvement in the team
    geometry: the same bits as the warp-per-scenario kernel, its profiling
    instantiation the same bits, the same line searches by the candidate
    taken, and no expansion phase."""
    state, params, cfg = mpc_batch(torch.float64, B=3, iterations=12)
    cfg = dict(cfg, min_rel_cost_change=torch.tensor(0.0, dtype=torch.float64))
    for k in ("pd", "pv", "min_pdelta_dot", "p_phi", "p_phi_ref_dot_diff",
              "pa", "pj"):
        params[k] = params[k] * torch.tensor([1.0, 0.0, 1.0],
                                             dtype=torch.float64)
    n = len(itm.batch_phases(torch.float64))
    prof = np.zeros(n + 8, np.int64)
    packed, out, got, _ = rehearse_batch(bodies, state, params, cfg,
                                         torch.float64, prof=prof)
    team_prof = np.zeros(n + 8, np.int64)
    team = rehearse_team(bodies, packed, state[3], cfg, team_prof)
    assert np.array_equal(team, out)
    assert np.array_equal(rehearse_team(bodies, packed, state[3], cfg), out)
    assert np.array_equal(team_prof[n:], prof[n:])
    assert team_prof[n + 7] >= 11 and int(got[3][1]) == 7
    # the single solve's dense blocks: no expansion
    assert np.all(team_prof[:n][[0, 1, 2, 3, 5, 6, n - 2, n - 1]] > 0)
    assert team_prof[4] == 0


def test_mpc_team_body_float32(bodies):
    """The float32 team geometry (two warps a scenario) returns the bits of
    the float32 warp-per-scenario kernel, scenario for scenario."""
    state, params, cfg = mpc_batch(torch.float32, B=5)
    packed, out, _, _ = rehearse_batch(bodies, state, params, cfg,
                                       torch.float32)
    team = rehearse_team(bodies, packed, state[3], cfg)
    assert team.dtype == np.float32 and np.all(np.isfinite(team))
    assert np.array_equal(team, out)


def test_mpc_batched_body_float32(bodies):
    """The float32 instantiation of the batched kernel against the plain
    float32 batched update, and near the float64 result."""
    state, params, cfg = mpc_batch(torch.float32)
    _, out, got, _ = rehearse_batch(bodies, state, params, cfg, torch.float32)
    assert out.dtype == np.float32
    B = out.shape[0]
    prob = problems.trajectory_tracking_mpc(128)[0]
    want = batched.make_batched_update_fn(
        prob, MPC_H, B, ilqr.HEUN, torch.float32)(
            *state, params, cfg, iterations=True)
    state64, params64, cfg64 = mpc_batch(torch.float64)
    ref64 = batched.make_batched_update_fn(
        prob, MPC_H, B, ilqr.HEUN, torch.float64)(*state64, params64, cfg64)
    for ref in (want, ref64):
        for name, g, w in (("x", got[0], ref[0]), ("lam", got[2], ref[2])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=2e-2, err_msg=name)
        np.testing.assert_allclose(got[4].numpy(), ref[4].numpy(), rtol=1e-5)
    # u where kernel and plain took the same decisions; where the last
    # step's acceptance (a cost change of a rounding) went the other way, a
    # jerk moves by about 2e-2
    same = ((got[3] == want[3]) & (got[5] == want[5])).numpy()
    du = (got[1] - want[1]).abs().amax((0, 1)).numpy()
    assert same.sum() >= B // 2
    assert du[same].max() <= 2e-2 and du.max() <= 1e-1
    its = got[5].numpy()
    assert np.all((1 <= its) & (its <= cfg["max_iterations"]))
    assert np.all(np.isfinite(out))


# ---------------------------------------------------------------------
# the RSTP kernel body, instantiated in double

def rstp_case(name, T, warm, seed):
    """A float64 lateral / velocity profile problem at n_ref = 512 (the
    configurations of tests/test_torch_kernel_cuda.py rstp_solver): packed
    input, launch arguments."""
    rng = np.random.default_rng(seed)
    H, n = RSTP_H, RSTP_N_REF
    spec = ilqr_rstp.PROBLEMS[name]
    nc = spec["nc"]
    params = {"ref_step": 0.5}
    x = np.zeros((H + 1, 2))
    if name == "lateral_profile":
        it, lg_limit = 5, 0.0
        lower = np.full(n, -2.0)
        lower[40:60] = 1.0
        params.update(
            k_ref=0.01 * np.sin(np.arange(n) * 0.1)
            + rng.normal(0.0, 0.002, n),
            d_offset=np.zeros(n), d_lower_constr=lower,
            d_upper_constr=np.full(n, 2.0), w_d=0.01, w_v_d=1.0, w_a_d=200.0,
            w_k=1.0)
        x[0] = [rng.normal(0.0, 0.5), 0.0]
    else:
        it, lg_limit = 20, 0.1
        v_ref = np.full(n, 10.0)
        v_ref[60:] = 3.0
        t_min = np.zeros(n)
        t_min[80] = 12.0
        params.update(
            ref_v=v_ref, ref_k=0.02 * np.sin(np.arange(n) * 0.05),
            ref_t_min=t_min, ref_t_max=np.full(n, 1e10),
            ref_t_offset=np.ones(n), ref_v_weight=np.ones(n), p_v=1.0,
            p_a=2.0, max_a_total=3.0)
        x[0] = [rng.uniform(0.5, 9.0), 0.0]
    u, lam, mu = np.zeros((H, 1)), np.zeros((H, nc)), 0
    if warm:
        u[:T, 0] = rng.normal(0.0, 0.3, T)
        lam[:T] = (rng.uniform(0.0, 0.05, (T, nc))
                   * (rng.uniform(size=(T, nc)) < 0.3))
        mu = int(rng.integers(0, 4))
    arrays = dict(
        x=x, u=u, lam=lam,
        u_lims=np.tile(np.array([[[-2.5, 2.5]]]), (H, 1, 1)),
        bw_lim=np.stack([np.full(nc, 1000.0), np.full(nc, lg_limit)], -1),
        cfg_f=np.array([0.5, 1e-6]), alphas=ilqr.ALPHAS,
        scalars=[params[k] for k in spec["scalars"]],
        tables=np.stack([params[k] for k in spec["tables"]]),
        mu_step=[float(mu)])
    host = np.concatenate([
        np.asarray(arrays[k], np.float64).reshape(-1)
        for k, _ in ilqr_rstp.input_layout(name, H, n)])
    return host, params, (H, n, T, it, 1), mu


def rstp_plain(name, host, args, mu):
    """The plain float64 ``make_update_fn`` on the packed float64 input."""
    H, n_ref, T, it, lg = args
    spec = ilqr_rstp.PROBLEMS[name]
    prob, _ = getattr(problems, name)(ref_capacity=n_ref)
    update = ilqr.make_update_fn(prob, H, ilqr.EULER, dtype=torch.float64)
    v = ilqr.unpack(torch.from_numpy(host),
                    ilqr.layout(ilqr_rstp.input_layout(name, H, n_ref))[0])
    params = {k: v["scalars"][i] for i, k in enumerate(spec["scalars"])}
    params.update({k: v["tables"][i] for i, k in enumerate(spec["tables"])})
    cfg = ilqr.packed_cfg(v["u_lims"], v["bw_lim"], v["cfg_f"], T, it, lg)
    state = ilqr.SolverState(v["x"], v["u"], v["lam"], mu)
    new, info = update(state, v["x"][0], params, cfg)
    return dict(x=new.x.numpy(), u=new.u.numpy(), lam=new.lam.numpy(),
                mu_step=new.mu_step, traj_costs=float(info["traj_costs"]),
                iterations=info["iterations"])


@pytest.mark.parametrize("name,T,warm", [
    ("lateral_profile", 250, False), ("lateral_profile", 200, True),
    ("velocity_profile_space", 250, False),
    ("velocity_profile_space", 200, True)])
def test_rstp_kernel_body_in_double_matches_plain(bodies, name, T, warm):
    host, _, args, mu = rstp_case(name, T, warm, seed=T + warm)
    H, n_ref = args[:2]
    pid = ilqr_rstp.PROBLEMS[name]["id"]
    assert bodies.rehearse_rstp_smem(pid, H, n_ref) <= 262144
    out = np.zeros(ilqr.layout(ilqr_rstp.output_layout(name, H))[1])
    bodies.rehearse_rstp(pid, _ptr(host), _ptr(out), *args)
    got = ilqr_rstp.unpack_outputs(name, out, H)
    ref = rstp_plain(name, host, args, mu)
    for k in ("x", "u", "lam"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["traj_costs"], ref["traj_costs"],
                               rtol=1e-12)
    assert got["mu_step"] == ref["mu_step"]
    assert got["iterations"] == ref["iterations"]
    assert 1 <= got["iterations"] <= args[3]
    assert np.all(np.isfinite(got["x"]))


# ---------------------------------------------------------------------
# the rampify scan and the DP action-min, float32, bit for bit

def rampify_case(H, T, seed, nan_at=None, v_min=1.0):
    """Seeded scan inputs (the limits of ``tpl_tpu_torch.scenes.
    rampify_args``): the 8 scalars in the kernel's order, the limits, T."""
    rng = np.random.default_rng(seed)
    lim = np.maximum(1.0, 10.0 + np.cumsum(rng.normal(0.0, 1.0, H)))
    lim[H // 6:H // 6 + 5] = 2.0
    if nan_at is not None:
        lim[nan_at] = np.nan
    v0, a0 = rng.uniform(0.0, 12.0), rng.normal(0.0, 0.5)
    # v0, a0, a_min, a_max, j_min, j_max, v_min, step
    scal = np.array([v0, a0, -2.5, 2.5, -1.5, 1.5, v_min, 0.5], np.float32)
    return scal, lim.astype(np.float32), T


def rampify_plain(scal, lim, T):
    t = [torch.tensor(v) for v in scal]
    v0, a0, a_min, a_max, j_min, j_max, v_min, step = t
    return rstp_rampify.scan_reference(v0, a0, torch.from_numpy(lim), T,
                                       a_min, a_max, j_min, j_max, v_min,
                                       step).numpy()


@pytest.mark.parametrize("H,T,nan_at,v_min", [
    (250, 250, None, 1.0), (250, 180, None, 1.0), (64, 64, None, 1.0),
    (2, 1, None, 1.0), (250, 250, 100, 1.0), (64, 40, None, 0.0)])
def test_rampify_kernel_body_matches_plain_bit_for_bit(bodies, H, T, nan_at,
                                                       v_min):
    scal, lim, T = rampify_case(H, T, H + T, nan_at, v_min)
    assert bodies.rstp_rampify_smem_bytes(H) <= 65536
    out = np.full((H, 2), -7.0, np.float32)
    bodies.rehearse_rampify(_ptr(scal), _ptr(lim), _ptr(out), None, H, T)
    want = rampify_plain(scal, lim, T)
    # the same float32 operations in the same order; NaN rows count as equal
    np.testing.assert_array_equal(out, want)
    assert np.array_equal(np.isnan(out), np.isnan(want))
    if nan_at is None:
        assert np.all(np.isfinite(out))
    else:
        assert np.any(np.isnan(out))


def test_rampify_profiling_body_is_bit_equal(bodies):
    scal, lim, T = rampify_case(250, 200, 3)
    out, prof_out = (np.zeros((250, 2), np.float32) for _ in range(2))
    prof = np.zeros(len(rstp_rampify.PHASES), np.int64)
    bodies.rehearse_rampify(_ptr(scal), _ptr(lim), _ptr(out), None, 250, T)
    bodies.rehearse_rampify(_ptr(scal), _ptr(lim), _ptr(prof_out), _ptr(prof),
                            250, T)
    assert np.array_equal(out, prof_out)
    assert np.all(prof > 0)


def _table_ptrs(tables):
    return (ctypes.c_void_p * len(lam.TABLE_KEYS))(*tables.ptrs)


def action_min_case(S, DS, L, seed):
    """Seeded slice inputs as tests/test_torch_kernel_cuda.py makes them
    (next nodes with tabulated dds / dl, state maps, forward distances) and
    the action tables of the default params on that grid."""
    rng = np.random.default_rng(seed)
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=4, s_steps=S, ds_steps=DS, l_steps=L), "cpu")
    pp = tllk.unpack_pp(torch.from_numpy(tllk.LatLonParams().packed()))
    tables = solve.action_tables(pp)
    nodes = np.stack([rng.uniform(0, 1e4, (S, DS, L)),
                      rng.uniform(0, 5, (S, DS, L))
                      * (rng.uniform(size=(S, DS, L)) < 0.2),
                      rng.choice(tables["dds_vals"].numpy(), (S, DS, L)),
                      rng.choice(tables["dl_vals"].numpy(), (S, DS, L))], -1)
    arrays = (nodes, rng.uniform(0, 1e3, (S, DS, L)),
              rng.uniform(0, 2, (S, DS, L)),
              rng.uniform(-5, 60, (S, L, lam.NB)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays], tables


@pytest.mark.parametrize("S,DS,L,ts_rows", [
    (201, 37, 21, 0), (61, 9, 11, 0), (37, 5, 3, 0), (61, 9, 11, 5),
    (37, 5, 3, 16)])
def test_action_min_kernel_body_matches_plain_bit_for_bit(bodies, S, DS, L,
                                                          ts_rows):
    """The tiled kernel on the card-test grids (S not a multiple of the
    tile, shifts past both edges), at the default tile and two others."""
    args, tables = action_min_case(S, DS, L, S)
    ts_rows = ts_rows or bodies.latlon_action_min_tile_rows(L)
    assert 1 <= ts_rows and ts_rows * L <= 256
    out = np.full((S, DS, L, 4), -7.0, np.float32)
    bodies.rehearse_action_min(*[_ptr(a.numpy()) for a in args],
                               _table_ptrs(tables), _ptr(out), S, DS, L,
                               ts_rows)
    want = lam.action_min_reference(*args, tables).numpy()
    assert np.array_equal(out, want)
    # shifts reach past both s edges on every grid
    ks = tables["ks"].numpy()
    assert ks.max() > 0 and S - 1 + ks.max() > S - 1


def slice_case(S, DS, L, T, seed, params=None):
    """A seeded scene for whole backward slices: a distance-ahead map with a
    leader, a parked car and closed road edges (the scene of chip_smoke.py's
    kernel phase, scaled to the grid), a reference line whose speed limit
    and lane bounds vary, and the solver on that grid."""
    rng = np.random.default_rng(seed)
    spec = dict(t_steps=T, s_steps=S, ds_steps=DS, l_steps=L)
    solve, _ = tllk.make_latlon_solver(spec, "cpu")
    p = tllk.LatLonParams()
    for k, v in (params or {}).items():
        setattr(p, k, v)
    dist = np.full((T, S, L, 2), 10000.0, np.float32)
    dist[..., 0] = 10000.0 + (S - np.arange(S))[None, :, None]
    mid = L // 2
    for t in range(T):
        lead = min(S - 1, S // 6 + (S // 25 + 1) * t)
        dist[t, :lead, max(mid - 2, 0):mid + 3, 0] = (
            lead - np.arange(lead))[:, None]
        park = (3 * S) // 5
        dist[t, :park, 1:max(2, L // 4), 0] = np.minimum(
            dist[t, :park, 1:max(2, L // 4), 0],
            (park - np.arange(park))[:, None])
    dist[:, :, [0, L - 1], 0] = 0.0
    dist[..., 0] += rng.uniform(0, 0.5, (T, S, L)).astype(np.float32)
    n_ref = 2 * S + 40
    rl = np.zeros((n_ref, 8), np.float32)
    rl[:, 0] = np.arange(n_ref) * 0.5
    rl[:, 4] = 14.0 - 6.0 * (np.arange(n_ref) > n_ref // 2)
    rl[:, 5] = 4.0 - 1.5 * (np.arange(n_ref) % 50 > 30)
    rl[:, 6] = 4.0 - 2.0 * (np.arange(n_ref) % 70 > 50)
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, 0.5, p.packed())
    return solve, dist_x, rl_t, step_t, pp


@pytest.mark.parametrize("S,DS,L,T,params", [
    (201, 37, 21, 4, None), (61, 9, 11, 6, None), (37, 5, 3, 5, None),
    (61, 9, 11, 5, dict(w_lat_dist=2.0, l_trg=1.5, t_st_min=2.5, s_st=20.0,
                        t_st_max=1.5, d_lat_comf=1.0))])
def test_backward_slice_kernel_body_matches_plain_bit_for_bit(bodies, S, DS,
                                                              L, T, params):
    """The fused slice kernel against ``backward_slice_reference``
    (``slice_inputs`` + ``action_min_reference``) on every backward slice of
    a seeded scene, chained through the plain version."""
    solve, dist_x, rl, step, pp = slice_case(S, DS, L, T, S + T, params)
    tables = solve.action_tables(pp)
    ts_rows = bodies.latlon_action_min_tile_rows(L)
    nxt = solve.final_slice(dist_x, rl, step, pp)
    searched = 0
    for i in range(T - 2, 0, -1):
        want = solve.backward_slice_reference(nxt, i, dist_x, rl, step, pp,
                                              tables)
        out = np.full((S, DS, L, 4), -7.0, np.float32)
        bodies.rehearse_backward_slice(
            _ptr(nxt.numpy()), _ptr(dist_x[i].numpy()), _ptr(rl.numpy()),
            _ptr(step.reshape(1).numpy()), _ptr(tables.slice_consts.numpy()),
            _table_ptrs(tables), _ptr(out), S, DS, L, rl.shape[0], i, ts_rows)
        assert np.array_equal(out, want.numpy()), f"slice {i}"
        nxt = want
        cost, _, d_fwd = solve.slice_inputs(i, dist_x, rl, step, pp)
        searched += int((d_fwd < 1000.0).sum())
    # the scene's obstacles reach the forward distances
    assert searched > 0


# ---------------------------------------------------------------------
# the poly chain's kernels: the rampify start mode, the lon DP backward
# slice and forward / reeval pass bit for bit in float32; the lateral sweep
# (float64, sums in another order than the plain version's library calls)
# at 1e-12 and its selection exactly

@pytest.mark.parametrize("H,seed,v_min", [(200, 1, 1.0), (200, 2, 0.5),
                                          (37, 3, 1.0), (2, 4, 1.0)])
def test_rampify_start_mode_body_matches_plain_bit_for_bit(bodies, H, seed,
                                                           v_min):
    scal, lim, _ = rampify_case(H, H, seed, v_min=v_min)
    lim[H // 3] = 0.0        # a stop cell (clipped up to v_min)
    out = np.full((H, 2), -7.0, np.float32)
    bodies.rehearse_rampify_start(_ptr(scal), _ptr(lim), _ptr(out), H)
    t = [torch.tensor(v) for v in scal]
    want = rstp_rampify.scan_start_reference(torch.from_numpy(lim), *t[2:])
    np.testing.assert_array_equal(out, want.numpy())
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("S,V,A,P,T", [(41, 13, 5, 90, 5), (23, 7, 20, 40, 4)])
def test_lon_dp_kernel_bodies_match_plain_bit_for_bit(bodies, S, V, A, P, T):
    """Every backward slice (the final one included), the forward pass and
    the reeval pass against the plain versions."""
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    for i in range(T - 1, 0, -1):
        nxt = nodes[min(i + 1, T - 1)].numpy()
        out = np.full((S, V, A, 4), -7.0, np.float32)
        bodies.rehearse_lon_backward(_ptr(nxt), _ptr(pp), _ptr(path),
                                     _ptr(dist), _ptr(out), S, V, A, P, i,
                                     int(i == T - 1))
        np.testing.assert_array_equal(out, nodes[i].numpy(),
                                      err_msg=f"slice {i}")
    # the constraint channel is in play: some nodes are infeasible
    assert (nodes[1:T - 1, ..., 1] > 0).any()

    args = (torch.from_numpy(pp), torch.from_numpy(path),
            torch.from_numpy(dist))
    want = tlk.forward_reference(nodes, *args, torch.from_numpy(x0)).numpy()
    out = np.full((T, 7), -7.0, np.float32)
    bodies.rehearse_lon_forward(_ptr(nodes.numpy()), _ptr(pp), _ptr(path),
                                _ptr(dist), _ptr(x0), _ptr(out), T, S, V, A,
                                P, T, 0)
    np.testing.assert_array_equal(out, want)

    traj = want.copy()
    traj[:, tlk.LC_J] += np.float32(0.1)
    traj = np.concatenate([traj, traj[-2:]])     # more rows than slices
    want_r = tlk.reeval_reference(nodes, *args, torch.from_numpy(traj)).numpy()
    out_r = np.full_like(traj, -7.0)
    bodies.rehearse_lon_forward(_ptr(nodes.numpy()), _ptr(pp), _ptr(path),
                                _ptr(dist), _ptr(traj), _ptr(out_r), T, S, V,
                                A, P, len(traj), 1)
    np.testing.assert_array_equal(out_r, want_r)


@pytest.mark.parametrize("LD,SD,S", [(21, 13, 61), (1, 20, 41), (6, 4, 201)])
def test_poly_lat_sweep_body_matches_plain(bodies, LD, SD, S):
    occ, rl, step, pp, env, start = poly_lat_scene(LD, SD, S, LD + SD + S)
    cd = np.full((LD, SD), -7.0, np.float32)
    tc = np.full((LD, SD), -7.0, np.float64)
    inv = np.ascontiguousarray(splines._HERMITE_INV[5])
    step_a = np.array([step], np.float32)
    bodies.rehearse_poly_lat_sweep(_ptr(occ), _ptr(rl), _ptr(step_a), _ptr(pp),
                                   _ptr(env), _ptr(start), _ptr(inv), _ptr(cd),
                                   _ptr(tc), LD, SD, S, *occ.shape, len(rl))
    T = torch.from_numpy
    want_cd, want_tc = plk.evaluate_reference(
        T(occ), T(rl), T(step_a), T(pp), T(env), T(start), LD, SD, S)
    np.testing.assert_array_equal(cd, want_cd.numpy())
    np.testing.assert_allclose(tc, want_tc.numpy(), rtol=1e-12, atol=0)
    # the scene's obstacles and limits reach the outputs
    assert (cd < 1000.0).any() and (tc >= 1e6).any() or LD == 1


def test_poly_lat_select_body_matches_plain(bodies):
    rng = np.random.default_rng(0)
    for LD, SD in ((21, 13), (1, 20), (4, 3)):
        for trial in range(10):
            cd = rng.uniform(0.0, 60.0, (LD, SD)).astype(np.float32)
            cd[rng.random((LD, SD)) < 0.3] = 1000.0
            tc = rng.uniform(0.0, 100.0, (LD, SD))
            tc[rng.random((LD, SD)) < 0.2] = 1e7
            lv = np.array([2.0], np.float32)
            best = np.zeros(1, np.int64)
            cost = np.zeros(1, np.float32)
            bodies.rehearse_poly_lat_select(_ptr(cd), _ptr(tc), _ptr(lv),
                                            _ptr(best), _ptr(cost), LD, SD)
            want_b, want_c = plk.select_reference(
                torch.from_numpy(cd), torch.from_numpy(tc),
                torch.from_numpy(lv), LD, SD)
            assert int(best[0]) == int(want_b), (LD, SD, trial)
            assert cost[0] == float(want_c)


# ---------------------------------------------------------------------
# the rollout planners' kernel bodies: the operations of the plain
# versions, but sin / cos / atan / tanh / pow come from the host's libm
# here and from torch's vectorised kernels there, and a 30-step closed loop
# carries an ulp forward; so these hold to the JAX package's own
# lanes-vs-vmap tolerance (tests/test_idm_kernel.py: rtol = atol = 1e-5).
IDM_RTOL = IDM_ATOL = 1e-5


def _idm_obj_ptrs(objs):
    arrs = [np.ascontiguousarray(objs[k].numpy()) for k in idk.OBJ_KEYS]
    return (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs]), arrs


def test_idm_param_keys_match_pp_keys(bodies):
    """The order of the packed parameters that both IDM kernels index
    (csrc/idm_common.cuh) is idm_kernel.PP_KEYS."""
    bodies.rehearse_idm_param_keys.restype = ctypes.c_char_p
    keys = bodies.rehearse_idm_param_keys().decode()
    assert keys.split(",")[:-1] == list(idk.PP_KEYS)


def _idm_rollout_run(bodies, rl, objs, a, C, T, split=None):
    """The rollout body on the launcher's grid (``split`` None: the
    launcher's choice for C, ``idm_rollout_split``): (ref_states,
    states)."""
    if split is None:
        split = bodies.idm_rollout_split(C)
    optrs, keep = _idm_obj_ptrs(a[7])
    out_r = np.full((C, T, 10), -7.0, np.float32)
    out_c = np.full((C, T, 9), -7.0, np.float32)
    n = [np.ascontiguousarray(x.numpy()) for x in a[:7] + (a[8],)]
    bodies.rehearse_idm_rollout(*[_ptr(x) for x in n[:7]], optrs, _ptr(n[7]),
                                _ptr(out_r), _ptr(out_c), C, T, len(rl),
                                *objs["hull_preds"].shape[:3], split)
    return out_r, out_c


def _idm_rollout_body(bodies, T, C, **scene):
    rl, objs, pp, init_ref, init_con = idm_scene(**scene)
    l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(np.float32)
    a = idm_args(rl, objs, pp, init_ref, init_con, l_trgs, d_stops, "cpu")
    want = idk.rollout_reference(*a[:4], a[4][0], a[5], a[6][0], a[7], a[8],
                                 T)
    out_r, out_c = _idm_rollout_run(bodies, rl, objs, a, C, T)
    np.testing.assert_allclose(out_r, want[0].numpy(), rtol=IDM_RTOL,
                               atol=IDM_ATOL)
    np.testing.assert_allclose(out_c, want[1].numpy(), rtol=IDM_RTOL,
                               atol=IDM_ATOL)
    return want


@pytest.mark.parametrize("stop_cell,T,C", [(True, 30, 48), (False, 20, 16)])
def test_idm_rollout_body_matches_plain(bodies, stop_cell, T, C):
    """The stop cell, candidates to +-5 m (off-road excursions) and a stop
    distance on every third candidate, as tests/test_idm_kernel.py."""
    want = _idm_rollout_body(bodies, T, C, stop_cell=stop_cell)
    # the scene's leaders, stop cell and road edges reach the states
    assert (want[0][..., idk.R_DR] < 100.0).any()
    assert float(want[1][..., idk.V_V].min()) < 4.0


def test_idm_rollout_body_oncoming_matches_plain(bodies):
    """An oncoming car: it changes the rollouts of the candidates that
    steer toward its lane (a leader of negative speed) and of no other."""
    T, C = 40, 24
    want = _idm_rollout_body(bodies, T, C, oncoming=True)
    a = idm_args(*idm_scene(), np.linspace(-5, 5, C),
                 np.where(np.arange(C) % 3 == 0, 30.0, 1e6), "cpu")
    without = idk.rollout_reference(*a[:4], a[4][0], a[5], a[6][0], a[7],
                                    a[8], T)[1]
    changed = (want[1] != without).flatten(1).any(1)
    assert changed.any() and not changed.all()


@pytest.mark.parametrize("case", ["collider", "rollout", "oncoming"])
def test_idm_evaluate_body_matches_plain(bodies, case):
    """The parked collider with trajectories driven through it (the
    collision screen must hit), a rollout of the stop-cell scene, and a
    rollout (T = 100) of an oncoming car (the interaction screen's hull
    tests must run and hit)."""
    rl, objs, pp, init_ref, init_con = idm_scene(
        stop_cell=case == "rollout", collider=case == "collider",
        oncoming=case == "oncoming")
    if case == "collider":
        C, T = 64, 20
        refs, cons = idm_through_states(C, T)
        l_trgs = np.linspace(-3, 3, C).astype(np.float32)
    else:
        C, T = 24, 30 if case == "rollout" else 100
        l_trgs = np.linspace(-5, 5, C).astype(np.float32)
        a = idm_args(rl, objs, pp, init_ref, init_con, l_trgs,
                     np.full(C, 1e6, np.float32), "cpu")
        r, c = idk.rollout_reference(*a[:4], a[4][0], a[5], a[6][0], a[7],
                                     a[8], T)
        refs, cons = r.numpy(), c.numpy()
    a = idm_args(rl, objs, pp, init_ref, init_con, l_trgs, l_trgs, "cpu")
    lg = torch.zeros((), dtype=torch.float32)
    want = idk.evaluate_reference(torch.from_numpy(refs),
                                  torch.from_numpy(cons), a[2], a[7], a[5],
                                  a[6][0], a[8], lg).numpy()
    optrs, keep = _idm_obj_ptrs(a[7])
    out = np.full((5, C), -7.0, np.float32)
    lg_a = np.zeros(1, np.float32)
    n = [np.ascontiguousarray(x.numpy()) for x in (a[2], a[5], a[6], a[8])]
    bodies.rehearse_idm_evaluate(_ptr(refs), _ptr(cons), _ptr(n[0]), optrs,
                                 _ptr(n[1]), _ptr(n[2]), _ptr(n[3]),
                                 _ptr(lg_a), _ptr(out), C, T, len(rl),
                                 *objs["hull_preds"].shape[:3], 2)
    np.testing.assert_array_equal(out[4], want[4])        # invalid
    np.testing.assert_allclose(out, want, rtol=IDM_RTOL, atol=IDM_ATOL)
    if case == "collider":
        assert want[4].any() and (want[3] > 0).any()
    if case == "oncoming":
        assert idk.evaluate_work(torch.from_numpy(cons), a[7], a[8])[1] > 0
        assert (want[2] > 0).any() and (want[3] > 0).any()


def _idm_hairpin_case(C, T):
    """The hairpin scene from station 28 m: in 30 steps the candidates pass
    the narrowing and enter the half circle, where both legs are near."""
    rl, objs, pp, init_ref, init_con = idm_hairpin_scene(start_s=28.0)
    l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(np.float32)
    return rl, objs, idm_args(rl, objs, pp, init_ref, init_con, l_trgs,
                              d_stops, "cpu")


def test_idm_rollout_body_hairpin_matches_plain(bodies):
    """The exact pruned stop and projection searches on the hairpin scene
    (the far leg's chunks cannot be excluded, the narrowing sends
    candidates off the road) against the plain version at 1e-5."""
    C, T = 16, 30
    rl, objs, a = _idm_hairpin_case(C, T)
    want = idk.rollout_reference(*a[:4], a[4][0], a[5], a[6][0], a[7], a[8],
                                 T)
    out_r, out_c = _idm_rollout_run(bodies, rl, objs, a, C, T)
    np.testing.assert_allclose(out_r, want[0].numpy(), rtol=IDM_RTOL,
                               atol=IDM_ATOL)
    np.testing.assert_allclose(out_c, want[1].numpy(), rtol=IDM_RTOL,
                               atol=IDM_ATOL)
    # the candidates reach the half circle, and some are off the road in
    # the narrowing (cells 60-89: stations 30-45 m, |l| beyond 1.2 m)
    assert float(want[1][:, -1, idk.V_S].max()) > 40.0
    s, l = want[0][..., idk.R_S], want[0][..., idk.R_L]
    assert bool(((s >= 30.0) & (s < 45.0) & (l.abs() > 1.2)).any())


@pytest.mark.parametrize("scene", ["hairpin", "oncoming"])
def test_idm_rollout_body_split_is_bit_equal(bodies, scene):
    """Two warps a candidate (the launcher's choice up to
    SPLIT_MAX_C candidates) and one warp a candidate (above it) give the
    same bits: the two halves of a step exchange values, they compute
    nothing another way."""
    C, T = 12, 30
    if scene == "hairpin":
        rl, objs, a = _idm_hairpin_case(C, T)
    else:
        rl, objs, pp, init_ref, init_con = idm_scene(oncoming=True)
        l_trgs = np.linspace(-5, 5, C).astype(np.float32)
        a = idm_args(rl, objs, pp, init_ref, init_con, l_trgs,
                     np.full(C, 1e6, np.float32), "cpu")
    assert bodies.idm_rollout_split(C) == 1
    assert bodies.idm_rollout_split(513) == 0
    split = _idm_rollout_run(bodies, rl, objs, a, C, T, split=1)
    whole = _idm_rollout_run(bodies, rl, objs, a, C, T, split=0)
    for x, y in zip(split, whole):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize("slots", [1, 3])
def test_idm_evaluate_body_hairpin_matches_plain(bodies, slots):
    """The evaluation of the hairpin rollout: the path gate, the shared
    (step, object) table and the per-warp sums against the plain version,
    on one resident block (every batch on it) and on three (batches of 6,
    one block a batch)."""
    C, T = 16, 30
    rl, objs, a = _idm_hairpin_case(C, T)
    refs, cons = (x.numpy() for x in idk.rollout_reference(
        *a[:4], a[4][0], a[5], a[6][0], a[7], a[8], T))
    lg = torch.zeros((), dtype=torch.float32)
    want = idk.evaluate_reference(torch.from_numpy(refs),
                                  torch.from_numpy(cons), a[2], a[7], a[5],
                                  a[6][0], a[8], lg).numpy()
    cands, grid = ctypes.c_int(), ctypes.c_int()
    bodies.idm_evaluate_grid(C, slots, 16, ctypes.byref(cands),
                             ctypes.byref(grid))
    assert (cands.value, grid.value) == ((16, 1) if slots == 1 else (6, 3))
    optrs, keep = _idm_obj_ptrs(a[7])
    out = np.full((5, C), -7.0, np.float32)
    lg_a = np.zeros(1, np.float32)
    n = [np.ascontiguousarray(x.numpy()) for x in (a[2], a[5], a[6], a[8])]
    bodies.rehearse_idm_evaluate(_ptr(refs), _ptr(cons), _ptr(n[0]), optrs,
                                 _ptr(n[1]), _ptr(n[2]), _ptr(n[3]),
                                 _ptr(lg_a), _ptr(out), C, T, len(rl),
                                 *objs["hull_preds"].shape[:3], slots)
    np.testing.assert_array_equal(out[4], want[4])
    np.testing.assert_allclose(out, want, rtol=IDM_RTOL, atol=IDM_ATOL)
    n_coll, n_inter, n_proj = idk.evaluate_work(torch.from_numpy(cons), a[7],
                                                a[8], projections=True)
    assert n_coll > 0 and 0 < n_proj < C * T * objs["pred_t"].shape[0]


@pytest.mark.parametrize("scene", ["obstacles", "free", "bench"])
def test_poly_sampling_body_matches_plain(bodies, scene):
    """The grid and the selection: the plain version's winner, its rows
    to 1e-9 (float64 rows; the coefficient solves sum in another order)."""
    start, path, obs, pp = poly_scene(obstacles=scene == "obstacles",
                                      bench=scene == "bench")
    a = psp.device_inputs(start, path, obs, pp, "cpu")
    want_p, want_c, want_b = pok.run_reference(*a)
    n = [np.ascontiguousarray(x.numpy()) for x in a]
    C, N = a[1].shape[0], a[4].shape[0]
    O, K = a[6].shape[:2]
    inv = np.ascontiguousarray(pok._inverses("cpu").numpy())
    rows = np.zeros((C, 11, N))
    costs = np.zeros(C)
    packed = np.zeros((11, N))
    cost = np.zeros(1)
    best = np.zeros(1, np.int64)
    bodies.rehearse_poly_sampling(*[_ptr(x) for x in n], _ptr(inv),
                                  _ptr(rows), _ptr(costs), _ptr(packed),
                                  _ptr(cost), _ptr(best), C, N, len(path), O,
                                  K)
    assert int(best[0]) == int(want_b)
    np.testing.assert_allclose(packed, want_p.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(cost[0], float(want_c), rtol=1e-12)
    if scene != "free":
        assert (costs >= pok.PENALTY).any()


# ---------------------------------------------------------------------
# the graph DP planner's kernels: the directional field cell for cell, the
# edge evaluation's end points bit for bit (the same operations in the same
# order), the propagation's selections and trajectory exactly

def _dir_field(bodies, occ, R):
    p = dpe.DpEnvParams()
    f32 = np.float32
    ray, step = dpe.ray_table(p.dir_min, p.dir_max, p.dir_steps,
                              p.s_step_size, p.l_step_size)
    scal = [float(f32(x)) for x in (p.s_min, p.s_step_size, p.l_min,
                                    p.l_step_size)]
    occ = np.ascontiguousarray(occ, np.float32)
    want = dpe.dir_dist_reference(torch.from_numpy(occ), ray, *scal, step, R)
    T, S, L = occ.shape
    D = ray.shape[0]
    out = np.zeros((T, S, L, D), np.float32)
    bodies.rehearse_dir_dist(_ptr(occ), _ptr(np.ascontiguousarray(
        ray.numpy())), *scal, step, _ptr(out), T, S, L, D, R)
    return out, want.numpy()


@pytest.mark.parametrize("case,R", [("obstacle", 72), ("random", 72),
                                    ("random", 40)])
def test_dir_dist_body_matches_plain_cell_for_cell(bodies, case, R):
    """On two time slices of 41 stations (a grid of 11 x 2 blocks: the
    host threads' barriers are slow when the machine is busy): the test
    scene's stretch around the obstacle and seeded occupancy."""
    tpl_tpu_torch.use_device("cpu")
    occ = (dp_poly_env(True).get_occ_map()[:2, 40:81] if case == "obstacle"
           else dp_random_occ(3, T=2, S=41))
    got, want = _dir_field(bodies, occ, R)
    np.testing.assert_array_equal(got, want)
    # some rays meet nothing, some block at once, some in between
    assert (want == dpe.FREE_DIST).any() and (want == 0.0).any()
    assert ((want > 0.0) & (want < dpe.FREE_DIST)).any()


def _rehearse_eval(bodies, start_pts, starts, specs, is_last, ev, dd, rl,
                   n_int):
    m4, h5 = ppk.inverses_f32()
    consts = np.concatenate([ev, m4.ravel(), h5.ravel()]).astype(np.float32)
    E = len(starts)
    out = np.zeros((E, 8), np.float32)
    T, S, L, D = dd.shape
    bodies.rehearse_poly_eval(
        _ptr(start_pts), _ptr(starts), _ptr(specs), _ptr(dd), _ptr(rl),
        _ptr(out), _ptr(consts), E, int(is_last), n_int, T, S, L, D, len(rl))
    return out


def _rehearse_propagate(bodies, pts, seg, node_off, seg_off):
    K = len(node_off) - 2
    N = node_off[-1]
    offs = np.zeros(2 * ppk.MAX_LEVELS + 3, np.int32)
    offs[:K + 2] = node_off
    offs[ppk.MAX_LEVELS + 2:ppk.MAX_LEVELS + 3 + K] = seg_off
    node_cost = np.zeros(N)
    best = np.zeros(N, np.int32)
    traj = np.zeros((K + 1, 8))
    bodies.rehearse_poly_propagate(
        _ptr(np.ascontiguousarray(pts, np.float32)), _ptr(node_cost),
        _ptr(best), _ptr(np.ascontiguousarray(seg, np.int32)), _ptr(traj),
        _ptr(offs), K)
    return node_cost, best, traj


@pytest.mark.parametrize("key", [(2, 4), (5, 1), (7, 8)])
def test_poly_planner_bodies_match_plain(bodies, key):
    """Both levels' edge evaluation on the obstacle scene, then the
    propagation on those end points: every end point bit for bit, every
    selection and the trajectory exactly, on a graph of 6 s x 8 ds x 9 l
    (the demo widths' graphs are checked on the card)."""
    tpl_tpu_torch.use_device("cpu")
    env = dp_poly_env(True)
    dd = env.update_dir_dist_map()
    p = ppk.DpPolyParams()
    p.t_steps, p.ds_steps, p.l_steps = 6, 8, 9
    node_steps, edge_steps = ppk.build_eval_graph(p, *key)
    ev = ppk.eval_params(p, env.params, np.float32(env.ref_step))
    rl = env.grid.ref_line
    init = np.zeros(8, np.float32)
    init[ppk.PP_DS] = p.ds_min + key[0] * p.ds_step_size + 0.3
    init[ppk.PP_L] = p.l_min + key[1] * p.l_step_size - 0.1
    level = [torch.from_numpy(init[None])]
    n_int = p.n_int_steps()
    K = len(edge_steps)
    for k in range(K):
        starts = torch.from_numpy(edge_steps[k])
        specs = torch.from_numpy(node_steps[k + 1].astype(np.float32))
        want = ppk.eval_edges_reference(level[k], starts, specs, k == K - 1,
                                        ev, dd, rl, n_int)
        got = _rehearse_eval(bodies, level[k].numpy(), starts.numpy(),
                             specs.numpy(), k == K - 1, ev, dd.numpy(),
                             rl.numpy(), n_int)
        np.testing.assert_array_equal(got, want.numpy())
        level.append(want)
    pts = torch.cat(level)
    node_off, seg, seg_off = ppk.graph_layout([len(x) for x in level],
                                              edge_steps)
    N = node_off[-1]
    node_cost = torch.zeros(N, dtype=torch.float64)
    best = torch.zeros(N, dtype=torch.int32)
    traj = torch.zeros((K + 1, 8), dtype=torch.float64)
    ppk.propagate_reference(pts, node_cost, best, torch.from_numpy(seg),
                            node_off, seg_off, traj)
    g_cost, g_best, g_traj = _rehearse_propagate(bodies, pts.numpy(), seg,
                                                 node_off, seg_off)
    inner = node_off[K]
    np.testing.assert_array_equal(g_best[:inner], best.numpy()[:inner])
    np.testing.assert_array_equal(g_cost[:inner], node_cost.numpy()[:inner])
    np.testing.assert_array_equal(g_traj, traj.numpy())
    assert np.all(np.diff(g_traj[:, ppk.PP_T]) > 0)


@pytest.mark.parametrize("seed,ties,nan", [(0, True, True), (1, True, False),
                                           (2, False, True)])
def test_poly_propagate_body_matches_plain(bodies, seed, ties, nan):
    """Seeded graphs with equal least costs in a node's range, NaN costs
    and nodes without edges: the same selections, costs and trajectory."""
    node_pts, edge_steps = dp_poly_propagation_case(seed, ties=ties, nan=nan)
    pts, node_cost, best, seg, node_off, seg_off, traj = dp_poly_buffers(
        node_pts, edge_steps, "cpu")
    ppk.propagate_reference(pts, node_cost, best, seg, node_off, seg_off,
                            traj)
    g_cost, g_best, g_traj = _rehearse_propagate(bodies, pts.numpy(),
                                                 seg.numpy(), node_off,
                                                 seg_off)
    inner = node_off[-2]
    np.testing.assert_array_equal(g_best[:inner], best.numpy()[:inner])
    np.testing.assert_array_equal(g_cost[:inner], node_cost.numpy()[:inner])
    np.testing.assert_array_equal(g_traj, traj.numpy())
    # the case has what it is for: nodes without edges (+inf) and, with
    # ``nan``, a NaN propagated cost
    assert np.isinf(node_cost.numpy()[1:inner]).any()
    assert np.isnan(node_cost.numpy()[:inner]).any() == nan

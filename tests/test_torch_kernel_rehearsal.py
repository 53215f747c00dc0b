"""A CPU rehearsal of the hand-written kernels' bodies.

There is no CUDA compiler and no card where these tests run, but the kernel
bodies are plain C++ once the CUDA runtime's few names are supplied.  The
fixture writes a stand-in ``cuda_runtime.h`` (``__syncthreads`` as a
``std::barrier`` over 256 ``std::thread``s, ``__syncwarp`` and
``__shfl_sync`` / ``__ballot_sync`` as a per-warp barrier and exchange,
``__reduce_min_sync`` / ``__reduce_max_sync`` as a per-warp exchange,
``__ffs`` / ``__clz`` as counts of
trailing / leading zeros, ``clock64`` as a
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
  multiplier rounds, and on a reference that ends inside the horizon
  (its profiling instantiation bit-equal on each),
- the RSTP kernel's template instantiated in double on a lateral and a
  velocity problem at H = 250,
- the generic AL-iLQR body (``csrc/ilqr_generic.cu``) in double on the
  three native problems without a kernel of their own at H = 250
  (tests/test_torch_ilqr_generic.py holds it and the structs the sympy
  front end prints on more cases, and against JAX),

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
  backward slice of a seeded scene, and over a batch of scenarios
  (``scenes.dp_batch_scenes``; persistent blocks of the launcher's threads
  walking the work items, as many blocks as items or fewer, in seeded
  orders; its profiling instantiation) against each scenario's
  one-scenario run and the plain version,
- the lon DP's backward slice (a block a v and a tile of s rows, on the
  launcher's grid) on ``scenes.LON_EDGE``'s grids at tiles that do not
  divide S,

each **bit for bit** in float32: these kernels keep the plain versions'
operations and their order; and the graph DP planner's directional field
(cell for cell, on a stretch of the JAX test scene, seeded occupancy and
occupancy that changes over t at T = 1, 10 and 40; its profiling
instantiation bit-equal), its edge evaluation (bit for bit on both levels
of three small graphs and on a level near the horizon; its profiling
instantiation bit-equal, with the steps it takes) and its one-launch
propagation (every selection, propagated cost and the trajectory, also on
seeded graphs of 1, 2 and 3 levels with ties, NaN costs and edgeless
nodes, the blocks in seeded orders, so that the last block to arrive is
not always the last index; its profiling instantiation bit-equal); and the
one-launch poly-sampling grid against the plain version and, every
candidate's rows and cost bit for bit, against the earlier two-launch body
(a copy of it in the harness), at C = 1, 6 and 30, with NaN costs and
ties (where that body's selection picks another winner); the NaN rule of
the lon DP's backward slice and forward pass, the action-min and the fused
slice on next slices with a NaN row, against the plain versions and
against 2dd76fb's bodies (``PARENTS``), which dropped the NaN and agree on
every node without one; a NaN in a value input (the path distance map,
the path's v_max, a DP distance cell, a lane bound), which the repaired
terms keep as the plain versions do, against the plain versions and
92bf3da's bodies (also in ``PARENTS``), which dropped it; the two-warp lon
forward pass and the redesigned lateral sweep against 2dd76fb's bodies and
their profiling instantiations; the sweep and its selection in one launch
(the last block to arrive selects, on a warp's lanes or on one thread)
with its blocks in seeded orders against the plain versions and 92bf3da's
two launches bit for bit, and the last block's selection on given maps
with NaN and tied values.  Grids and
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
from tpl_tpu_torch.scenes import (dp_moving_occ, dp_poly_buffers,
                                  dp_poly_env, dp_poly_near_horizon,
                                  dp_poly_propagation_case, dp_random_occ,
                                  idm_args, idm_hairpin_scene, idm_scene,
                                  idm_through_states,
                                  lon_nodes, lon_scene, lon_shifted_start,
                                  poly_lat_scene,
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
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
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
struct alignas(8) int2 { int x, y; };
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
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(rehearsal::exchange[w][lane], &v, sizeof(v));
  __syncwarp();
  unsigned r = v;
  for (int i = 0; i < 32; ++i) {
    unsigned b;
    std::memcpy(&b, rehearsal::exchange[w][i], sizeof(b));
    r = b < r ? b : r;
  }
  __syncwarp();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(rehearsal::exchange[w][lane], &v, sizeof(v));
  __syncwarp();
  unsigned r = v;
  for (int i = 0; i < 32; ++i) {
    unsigned b;
    std::memcpy(&b, rehearsal::exchange[w][i], sizeof(b));
    r = b > r ? b : r;
  }
  __syncwarp();
  return r;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > old && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <typename T>
inline T __ldcg(const T* p) { return *p; }
inline long long clock64() {
  static thread_local long long t = 0;
  return ++t;
}
"""

PARENTS = r"""
// The bodies of 2dd76fb that this tree changed, over the tree's helpers:
// the lon DP's backward slice and forward pass and the DP action-min's
// selection with its two kernels (which dropped a NaN in their
// lexicographic minimum), and the lateral sweep before its redesign.  The
// NaN tests show the nodes whose result holds no NaN bit-equal to these,
// and the sweep and forward tests every result.
#pragma once

namespace lon_dp_parent {
using namespace lon_dp;

// a block: one v (blockIdx.x) and the s rows s0 .. s0 + tile - 1
// (blockIdx.y), every a; `box_cap` floats of shared memory for its box
__global__ void __launch_bounds__(MAX_THREADS, 2)
lon_backward_kernel(const float4* __restrict__ nodes_next,
                    const float* __restrict__ pp_in,
                    const float* __restrict__ path,
                    const float* __restrict__ dist_path,
                    float4* __restrict__ out, int S, int V, int A, int P,
                    int t_idx, bool is_last, int tile, int box_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* res = reinterpret_cast<float4*>(smem_raw);      // (tile, A)
  float* box = reinterpret_cast<float*>(res + tile * A);
  Coord* tab = reinterpret_cast<Coord*>(box + (box_cap + 3) / 4 * 4);
  float* vmax = reinterpret_cast<float*>(tab + A * NB);   // (P,)
  float* s_val = vmax + P;
  float* s_vmax = s_val + tile;
  float* s_slack = s_vmax + tile;
  int* part = reinterpret_cast<int*>(s_slack + tile);     // (warps, 4)

  float pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const int tid = threadIdx.x;
  const int i_v = blockIdx.x;
  const int s0 = blockIdx.y * tile;
  const int n_s = mini(tile, S - s0);
  const float v = axis_point(pp[V_MIN], pp[V_MAX], i_v, V - 1);
  const float pss = pp[PATH_STEP_SIZE];
  const float dt = pp[DT];

  int bs0 = 0, rs = 0, plane = 0;
  bool fits = true;
  if (!is_last) {
    // the (a, jerk) table and each warp's extremes of its row shifts and v
    // rows, then the block's
    const float s_step_x = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
    int k_lo = 0x7fffffff, k_hi = -0x7fffffff - 1;
    int y_lo = 0x7fffffff, y_hi = -0x7fffffff - 1;
    for (int e = tid; e < A * NB; e += blockDim.x) {
      const int i_a = e / NB, jb = e - i_a * NB;
      const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
      const float j = axis_point(pp[J_MIN], pp[J_MAX], jb, NB - 1);
      const Next n = next_state(0.0f, v, a, j, dt);
      Coord c;
      c.s_change = n.s_change;
      c.vn = n.vn;
      c.f_c = n.s_change / s_step_x;
      const float k_c = floorf(c.f_c);
      c.ax_c = c.f_c - k_c;
      const float y = clampf((n.vn - pp[V_MIN]) / (pp[V_MAX] - pp[V_MIN])
                             * (float)(V - 1), 0.0f, (float)(V - 1));
      const float z = clampf((n.an - pp[A_MIN]) / (pp[A_MAX] - pp[A_MIN])
                             * (float)(A - 1), 0.0f, (float)(A - 1));
      const float y0f = floorf(y), z0f = floorf(z);
      const float wy0 = 1.0f - (y - y0f);
      const float wz0 = 1.0f - (z - z0f);
      const int y0 = (int)y0f, z0 = (int)z0f;
      c.o[0] = y0;
      c.o[1] = mini(y0 + 1, V - 1);
      c.o[2] = z0;
      c.o[3] = mini(z0 + 1, A - 1);
      c.w00 = wy0 * wz0;
      c.w01 = wy0 * (1.0f - wz0);
      c.w10 = (1.0f - wy0) * wz0;
      c.w11 = (1.0f - wy0) * (1.0f - wz0);
      c.k = (int)k_c;
      c.al = a_limits(pp, n.an);
      c.j = j;
      tab[e] = c;
      k_lo = mini(k_lo, c.k);
      k_hi = k_hi > c.k ? k_hi : c.k;
      y_lo = mini(y_lo, c.o[0]);
      y_hi = y_hi > c.o[1] ? y_hi : c.o[1];
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2) {
      k_lo = mini(k_lo, __shfl_xor_sync(0xffffffffu, k_lo, o));
      const int kh = __shfl_xor_sync(0xffffffffu, k_hi, o);
      k_hi = k_hi > kh ? k_hi : kh;
      y_lo = mini(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, o));
      const int yh = __shfl_xor_sync(0xffffffffu, y_hi, o);
      y_hi = y_hi > yh ? y_hi : yh;
    }
    if ((tid & (WARP - 1)) == 0) {
      int* w = part + 4 * (tid / WARP);
      w[0] = k_lo;
      w[1] = k_hi;
      w[2] = y_lo;
      w[3] = y_hi;
    }
    __syncthreads();
    for (int w = 0; w < (int)(blockDim.x / WARP); ++w) {
      k_lo = mini(k_lo, part[4 * w]);
      k_hi = k_hi > part[4 * w + 1] ? k_hi : part[4 * w + 1];
      y_lo = mini(y_lo, part[4 * w + 2]);
      y_hi = y_hi > part[4 * w + 3] ? y_hi : part[4 * w + 3];
    }

    // the box: the rows every (s, jerk) of the tile reads (clamped as the
    // lookup clamps them) x the v rows y_lo .. y_hi x every a, one plane
    // per channel (cost, constraint, jerk); the copies run while the s
    // rows below are formed
    bs0 = clampi(s0 + k_lo, 0, S - 1);
    const int bs1 = clampi(s0 + n_s - 1 + k_hi + 1, 0, S - 1);
    const int row_len = (y_hi - y_lo + 1) * A;
    rs = row_stride(row_len);
    plane = (bs1 - bs0 + 1) * rs;
    fits = 3 * plane <= box_cap;
    if (fits)
      for (int q = tid; q < (bs1 - bs0 + 1) * row_len; q += blockDim.x) {
        const int r = q / row_len, c = q - r * row_len;
        const float* src = reinterpret_cast<const float*>(
            nodes_next + ((bs0 + r) * V + y_lo) * A + c);
        float* dst = box + r * rs + c;
        copy4_async(dst, src);
        copy4_async(dst + plane, src + 1);
        copy4_async(dst + 2 * plane, src + 2);
      }
    // the table's corners as offsets in a box row
    for (int e = tid; e < A * NB; e += blockDim.x) {
      int* o = tab[e].o;
      const int y0 = (o[0] - y_lo) * A, y1 = (o[1] - y_lo) * A;
      const int z0 = o[2], z1 = o[3];
      o[0] = y0 + z0;
      o[1] = y0 + z1;
      o[2] = y1 + z0;
      o[3] = y1 + z1;
    }
  }
  // the path's v_max column; the tile's s rows: grid value, v_max there and
  // the distance map's slack
  if (!is_last)
    for (int q = tid; q < P; q += blockDim.x)
      vmax[q] = path[q * N_PC + PC_VMAX];
  for (int r = tid; r < n_s; r += blockDim.x) {
    const float s = axis_point(pp[S_MIN], pp[S_MAX], s0 + r, S - 1);
    s_val[r] = s;
    s_vmax[r] = interp_col(path, PC_VMAX, s, pss, P);
    s_slack[r] = s_dist_at(dist_path, pp, t_idx,
                           interp_col(path, PC_S, s, pss, P), S);
  }
  copies_wait();
  __syncthreads();

  // a thread per (s, a) of the tile, neighbouring s on neighbouring lanes
  // (their table entries are one, their box rows neighbours)
  for (int item = tid; item < n_s * A; item += blockDim.x) {
    const int i_a = item / n_s, r = item - i_a * n_s;
    const int i_s = s0 + r;
    const float s = s_val[r];
    const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
    const float s_dist = s_slack[r];
    const StateTerms st = state_terms(pp, s, v, a, s_dist, s_vmax[r]);
    float4& o = res[r * A + i_a];
    if (is_last) {
      o = make_float4(st.cost, 0.0f, 0.0f, 0.0f);
      continue;
    }
    if (!fits) {
      o = make_float4(NAN, NAN, NAN, NAN);
      continue;
    }
    float cost[NB], constr[NB];
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const Coord& c = tab[i_a * NB + jb];
      Next n;
      n.s_change = c.s_change;
      n.vn = c.vn;
      n.sn = s + c.s_change;
      const int rows[2] = {clampi(i_s + c.k, 0, S - 1) - bs0,
                           clampi(i_s + c.k + 1, 0, S - 1) - bs0};
      const float ax_row = (float)i_s + c.f_c >= (float)(S - 1) ? 0.0f
                                                               : c.ax_c;
      float b[2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* base = box + rows[q] * rs;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* p = base + ch * plane;
          b[q][ch] = ((p[c.o[0]] * c.w00 + p[c.o[1]] * c.w01)
                      + p[c.o[2]] * c.w10)
                     + p[c.o[3]] * c.w11;
        }
      }
      float nn[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        nn[q] = b[0][q] * (1.0f - ax_row) + b[1][q] * ax_row;
      action_terms(pp, st, nn, c.j, dt, n, s_dist,
                   interp_staged(vmax, n.sn, pss, P), c.al, &cost[jb],
                   &constr[jb]);
    }
    float cmin = constr[0];
#pragma unroll
    for (int jb = 1; jb < NB; ++jb) cmin = fminf(cmin, constr[jb]);
    float best = INFINITY;
    int jbest = 0;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const float cj = constr[jb] <= cmin ? cost[jb] : INFINITY;
      if (cj < best) {
        best = cj;
        jbest = jb;
      }
    }
    o = make_float4(best, cmin,
                    axis_point(pp[J_MIN], pp[J_MAX], jbest, NB - 1), 0.0f);
  }
  __syncthreads();

  // the tile's nodes, a row of A at a time
  for (int q = tid; q < n_s * A; q += blockDim.x) {
    const int r = q / A;
    out[((s0 + r) * V + i_v) * A + (q - r * A)] = res[q];
  }
}

// the 8-corner value lookup of the forward pass (trilerp), channels 0..2
__device__ __forceinline__ void trilerp(const float4* __restrict__ nodes,
                                        const float* pp, int S, int V, int A,
                                        float s, float v, float a,
                                        float (&res)[3]) {
  int i0[3], i1[3];
  float fr[3];
  const float q[3] = {s, v, a};
  const float lo[3] = {pp[S_MIN], pp[V_MIN], pp[A_MIN]};
  const float hi[3] = {pp[S_MAX], pp[V_MAX], pp[A_MAX]};
  const int n[3] = {S, V, A};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = clampf((q[d] - lo[d]) / (hi[d] - lo[d]) * (float)(n[d] - 1),
                           0.0f, (float)(n[d] - 1));
    const float c0 = floorf(c);
    i0[d] = (int)c0;
    i1[d] = mini(i0[d] + 1, n[d] - 1);
    fr[d] = c - c0;
  }
  auto at = [&](int x, int y, int z) {
    return load4(nodes + (x * V + y) * A + z);
  };
  const float ax = fr[0], ay = fr[1], az = fr[2];
  const float4 n000 = at(i0[0], i0[1], i0[2]), n100 = at(i1[0], i0[1], i0[2]);
  const float4 n010 = at(i0[0], i1[1], i0[2]), n110 = at(i1[0], i1[1], i0[2]);
  const float4 n001 = at(i0[0], i0[1], i1[2]), n101 = at(i1[0], i0[1], i1[2]);
  const float4 n011 = at(i0[0], i1[1], i1[2]), n111 = at(i1[0], i1[1], i1[2]);
  const float v000[3] = {n000.x, n000.y, n000.z}, v100[3] = {n100.x, n100.y, n100.z};
  const float v010[3] = {n010.x, n010.y, n010.z}, v110[3] = {n110.x, n110.y, n110.z};
  const float v001[3] = {n001.x, n001.y, n001.z}, v101[3] = {n101.x, n101.y, n101.z};
  const float v011[3] = {n011.x, n011.y, n011.z}, v111[3] = {n111.x, n111.y, n111.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = v000[c] * (1.0f - ax) + v100[c] * ax;
    const float c10 = v010[c] * (1.0f - ax) + v110[c] * ax;
    const float c01 = v001[c] * (1.0f - ax) + v101[c] * ax;
    const float c11 = v011[c] * (1.0f - ax) + v111[c] * ax;
    const float c0 = c00 * (1.0f - ay) + c10 * ay;
    const float c1 = c01 * (1.0f - ay) + c11 * ay;
    res[c] = c0 * (1.0f - az) + c1 * az;
  }
}

struct Scored {
  StateTerms st;
  float cost, constr;
};

// one action (jerk j) of the state tp with the next slice `nodes_next`
__device__ __forceinline__ Scored score(const float* tp, float j,
                                        const float4* __restrict__ nodes_next,
                                        int t_idx,
                                        const float* __restrict__ dist_path,
                                        const float* __restrict__ path,
                                        const float* pp, float dt, int S,
                                        int V, int A, int P) {
  const float s = tp[LC_S], v = tp[LC_V], a = tp[LC_A];
  const float pss = pp[PATH_STEP_SIZE];
  const float v_max = interp_col(path, PC_VMAX, s, pss, P);
  const float s_dist = s_dist_at(dist_path, pp, t_idx,
                                 interp_col(path, PC_S, s, pss, P), S);
  Scored r;
  r.st = state_terms(pp, s, v, a, s_dist, v_max);
  const Next n = next_state(s, v, a, j, dt);
  float nn[3];
  trilerp(nodes_next, pp, S, V, A, n.sn, n.vn, n.an, nn);
  action_terms(pp, r.st, nn, j, dt, n, s_dist,
               interp_col(path, PC_VMAX, n.sn, pss, P), a_limits(pp, n.an),
               &r.cost, &r.constr);
  return r;
}

__global__ void __launch_bounds__(WARP)
lon_forward_kernel(const float4* __restrict__ nodes,
                   const float* __restrict__ pp_in,
                   const float* __restrict__ path,
                   const float* __restrict__ dist_path,
                   const float* __restrict__ states, float* __restrict__ out,
                   int T, int S, int V, int A, int P, int n_rows, int mode) {
  // shared: the parameters, the state, each action's cost and constraint
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pp = reinterpret_cast<float*>(smem_raw);
  float* tp = pp + N_PP;
  float* a_cost = tp + N_LC;
  float* a_constr = a_cost + NF;
  float* a_state_cost = a_constr + NF;
  const int lane = threadIdx.x;
  if (lane >= WARP) return;
  for (int k = lane; k < N_PP; k += WARP) pp[k] = pp_in[k];
  const size_t slice = (size_t)S * V * A;
  __syncwarp();

  if (mode == 1) {
    // reeval: every row with its own jerk, rows on the lanes
    for (int r = lane; r < n_rows; r += WARP) {
      float row[N_LC];
      for (int c = 0; c < N_LC; ++c) row[c] = states[r * N_LC + c];
      const float dt_i = r == 0 ? pp[DT_START] : pp[DT];
      const int t_idx = t_index(row[LC_T], pp, T);
      const Scored sc = score(row, row[LC_J], nodes + mini(r + 1, T - 1) * slice,
                              t_idx, dist_path, path, pp, dt_i, S, V, A, P);
      // one action: cmin is its constraint, the cost survives unless NaN
      const float cost = sc.constr <= sc.constr ? sc.cost : INFINITY;
      finish_row(row, pp, T, sc.st.cost, cost, sc.constr, row[LC_J],
                 out + r * N_LC);
    }
    return;
  }

  if (lane < N_LC) tp[lane] = states[lane];
  __syncwarp();
  for (int i = 0; i < T; ++i) {
    const float dt_i = i == 0 ? pp[DT_START] : pp[DT];
    const int t_idx = t_index(tp[LC_T], pp, T);
    const float4* nodes_next = nodes + mini(i + 1, T - 1) * slice;
    for (int k = lane; k < NF; k += WARP) {
      const float j = axis_point(pp[J_MIN], pp[J_MAX], k, NF - 1);
      const Scored sc = score(tp, j, nodes_next, t_idx, dist_path, path, pp,
                              dt_i, S, V, A, P);
      a_cost[k] = sc.cost;
      a_constr[k] = sc.constr;
      if (k == 0) *a_state_cost = sc.st.cost;
    }
    __syncwarp();
    if (lane == 0) {
      float cmin = a_constr[0];
      for (int k = 1; k < NF; ++k) cmin = fminf(cmin, a_constr[k]);
      float best = INFINITY;
      int kbest = 0;
      for (int k = 0; k < NF; ++k) {
        const float c = a_constr[k] <= cmin ? a_cost[k] : INFINITY;
        if (c < best) {
          best = c;
          kbest = k;
        }
      }
      float row[N_LC];
      finish_row(tp, pp, T, *a_state_cost, best, cmin,
                 axis_point(pp[J_MIN], pp[J_MAX], kbest, NF - 1), row);
      for (int c = 0; c < N_LC; ++c) out[i * N_LC + c] = row[c];
      // the next state
      const float s = row[LC_S], v = row[LC_V], a = row[LC_A], j = row[LC_J];
      const float dt2 = dt_i * dt_i;
      tp[LC_T] = row[LC_T] + dt_i;
      tp[LC_S] = fmaxf(s, s + v * dt_i + 0.5f * a * dt2
                       + j * (dt_i * (dt_i * dt_i)) * (1.0f / 6.0f));
      tp[LC_V] = fmaxf(v + a * dt_i + 0.5f * j * dt2, 0.0f);
      tp[LC_A] = a + j * dt_i;
      tp[LC_J] = j;
      tp[LC_COST] = 0.0f;
      tp[LC_CONSTR] = 0.0f;
    }
    __syncwarp();
  }
}
}  // namespace lon_dp_parent

namespace latlon_am_parent {
using namespace latlon_am;

// The lexicographic (constraint, cost) minimum over the 7 x 7 actions of one
// cell, dl outer and dds inner (the XLA flattening order of the argmin),
// first minimum winning.  my_rows: the staged rows of the cell's s, entry
// (j, lt) at my_rows[j * tile + lt]; dfwd: the cell's 7 forward distances.
__device__ __forceinline__ Best best_action(
    const float4* my_rows, const float* s_ca, const Tables& tb,
    const float (&dfwd)[NB], int ds, int l, int L, int tile) {
  const float gap_min = tb.consts[0], time_gap = tb.consts[1];
  const float w_safety = tb.consts[2], w_ddds = tb.consts[3];
  const float w_ddl = tb.consts[4];
  const float ds_gap = tb.dss[ds] * time_gap;

  float sc[NB], dds_v[NB], q_dds[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    sc[j] = tb.schg[ds * NB + j];
    dds_v[j] = tb.dds_vals[j];
    q_dds[j] = tb.qdds[j];
  }

  Best b = {0.f, 0.f, 0.f, 0.f};
  bool first = true;
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const int lt = clampi(l + tb.kl[m], 0, L - 1);
    const float d_safety = (dfwd[m] - gap_min) - ds_gap;
    const float qdl_m = tb.qdl[m];
    const float dl_v = tb.dl_vals[m];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float4 nn = my_rows[j * tile + lt];

      const float occ = fmaxf(0.f, sc[j] - dfwd[m]);
      const float constr = (s_ca[j * NB + m] + occ) + nn.y;

      float cost = w_safety * fmaxf(0.f, sc[j] - d_safety);
      cost = cost + q_dds[j];
      const float e_dds = nn.z - dds_v[j];
      cost = cost + w_ddds * (e_dds * e_dds);
      cost = cost + qdl_m;
      const float e_dl = nn.w - dl_v;
      cost = cost + w_ddl * (e_dl * e_dl);
      cost = cost + nn.x;

      if (first || constr < b.constr ||
          (constr == b.constr && cost < b.cost)) {
        b.constr = constr;
        b.cost = cost;
        b.dds = dds_v[j];
        b.dl = dl_v;
        first = false;
      }
    }
  }
  return b;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == FEW_THREADS ? FEW_BLOCKS
                                                                  : 1)
action_min_kernel(
    const float4* __restrict__ nodes_next,   // (S, DS, L) x 4 channels
    const float* __restrict__ state_cost,    // (S, DS, L)
    const float* __restrict__ state_constr,  // (S, DS, L)
    const float* __restrict__ d_fwd,         // (S, L, NB)
    const int* __restrict__ ids,             // (DS, NB) target ds row
    const int* __restrict__ ks,              // (DS, NB) s shift (cells)
    const int* __restrict__ kl,              // (NB,)    l shift (cells)
    const float* __restrict__ ca,            // (DS, NB, NB) slope constr
    const float* __restrict__ schg,          // (DS, NB) s change
    const float* __restrict__ qdds,          // (NB,)
    const float* __restrict__ qdl,           // (NB,)
    const float* __restrict__ dds_vals,      // (NB,)
    const float* __restrict__ dl_vals,       // (NB,)
    const float* __restrict__ dss,           // (DS,)
    const float* __restrict__ consts,        // gap_min, time_gap, w_safety,
                                             // w_ddds, w_ddl
    float4* __restrict__ out,                // (S, DS, L) x 4 channels
    int S, int DS, int L, int ts_rows) {
  // (the tables arrive as read-only kernel parameters of their own, which
  // is what lets the compiler keep their loads out of the way)
  const Tables tb = {ids, ks, kl, ca, schg, qdds, qdl, dds_vals, dl_vals,
                     dss, consts};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* rows = reinterpret_cast<float4*>(smem_raw);   // (NB, ts_rows, L)
  float* s_ca = reinterpret_cast<float*>(rows + NB * ts_rows * L);  // (j, m)

  const int tid = threadIdx.x;
  const int ds = blockIdx.y;
  const int s0 = blockIdx.x * ts_rows;
  const int tile = ts_rows * L;
  stage_lookups(rows, s_ca, nodes_next, tb, ds, s0, S, DS, L, tile);
  copies_wait();
  __syncthreads();

  const int row = tid / L;
  const int l = tid - row * L;
  const int s = s0 + row;
  if (tid >= tile || s >= S) return;
  const int cell = (s * DS + ds) * L + l;

  float dfwd[NB];
  const float* dfwd_cell = d_fwd + (s * L + l) * NB;
#pragma unroll
  for (int m = 0; m < NB; ++m) dfwd[m] = dfwd_cell[m];

  const Best b = latlon_am_parent::best_action(rows + row * L, s_ca, tb,
                                               dfwd, ds, l, L, tile);
  out[cell] = make_float4(state_cost[cell] + b.cost,
                          state_constr[cell] + b.constr, b.dds, b.dl);
}

// One whole backward slice: what the plain version computes with some
// hundred tensor operations before the action-min (the state cost and
// constraint of every cell, with the nearest reference-line row, the two
// first-obstacle searches along l and the mid-lane target, and the 7
// forward distances with their per-side running minimum), computed per cell
// from the tile's rows of the distance map in shared memory, then the
// action-min above.  Every expression keeps the plain version's operations
// and their order (reference: lat_lon_planner.cu:80-192 computed the same
// per cell inside its backward step).
template <int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == FEW_THREADS ? FEW_BLOCKS
                                                                  : 1)
backward_slice_kernel(
    const float4* __restrict__ nodes_next,   // (S, DS, L) x 4 channels
    const float* __restrict__ dist_t,        // (S, L) distance ahead
    const float* __restrict__ ref_line,      // (n_ref, 8)
    const float* __restrict__ ref_step,      // one value
    const float* __restrict__ sc,            // SliceConst
    const int* __restrict__ ids,             // (DS, NB) target ds row
    const int* __restrict__ ks,              // (DS, NB) s shift (cells)
    const int* __restrict__ kl,              // (NB,)    l shift (cells)
    const float* __restrict__ ca,            // (DS, NB, NB) slope constr
    const float* __restrict__ schg,          // (DS, NB) s change
    const float* __restrict__ qdds,          // (NB,)
    const float* __restrict__ qdl,           // (NB,)
    const float* __restrict__ dds_vals,      // (NB,)
    const float* __restrict__ dl_vals,       // (NB,)
    const float* __restrict__ dss,           // (DS,)
    const float* __restrict__ consts,        // gap_min, time_gap, w_safety,
                                             // w_ddds, w_ddl
    float4* __restrict__ out,                // (S, DS, L) x 4 channels
    int S, int DS, int L, int n_ref, int slice, int ts_rows) {
  // (the tables arrive as read-only kernel parameters of their own, which
  // is what lets the compiler keep their loads out of the way)
  const Tables tb = {ids, ks, kl, ca, schg, qdds, qdl, dds_vals, dl_vals,
                     dss, consts};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* rows = reinterpret_cast<float4*>(smem_raw);   // (NB, ts_rows, L)
  float* s_ca = reinterpret_cast<float*>(rows + NB * ts_rows * L);  // (j, m)
  float* dist = s_ca + NB * NB;                         // (ts_rows, L)
  int* il2 = reinterpret_cast<int*>(dist + ts_rows * L);   // (L, NB)

  const int tid = threadIdx.x;
  const int ds = blockIdx.y;
  const int s0 = blockIdx.x * ts_rows;
  const int tile = ts_rows * L;
  const float l_min = sc[C_L_MIN], l_step = sc[C_L_STEP], dt = sc[C_DT];

  stage_lookups(rows, s_ca, nodes_next, tb, ds, s0, S, DS, L, tile);
  for (int k = tid; k < tile; k += blockDim.x)
    dist[k] = dist_t[clampi(s0 + k / L, 0, S - 1) * L + k % L];
  // the l index each dl action's lateral sweep reads, per l
  for (int k = tid; k < L * NB; k += blockDim.x) {
    const float l_g = l_min + (float)(k / NB) * l_step;
    const float at = rintf(((l_g + tb.dl_vals[k % NB] * dt) - l_min) / l_step);
    il2[k] = (int)fminf(fmaxf(at, 0.f), (float)(L - 1));
  }
  copies_wait();
  __syncthreads();

  const int row = tid / L;
  const int l = tid - row * L;
  const int s = s0 + row;
  if (tid >= tile || s >= S) return;
  const int cell = (s * DS + ds) * L + l;

  const float s_g = sc[C_S_MIN] + (float)s * sc[C_S_STEP];
  const float l_g = l_min + (float)l * l_step;
  const float ds_g = tb.dss[ds];
  const float t = sc[C_DT_START] + (float)(slice - 1) * dt;
  const float half_len = sc[C_LENGTH_VEH] * 0.5f;
  const float* drow = dist + row * L;

  // the nearest reference-line row (round half to even)
  const float at = rintf(s_g / *ref_step);
  const float* rl =
      ref_line + (size_t)(int)fminf(fmaxf(at, 0.f), (float)(n_ref - 1)) * 8;
  const float v_max_ref = rl[4];
  const float half_width = sc[C_WIDTH_VEH] * 0.5f;
  const float d_left_ref = rl[5] - half_width;
  const float d_right_ref = -(rl[6] - half_width);

  // the first l offset to each side whose distance ahead is too short
  const float mean_dist = fmaxf(ds_g * dt, half_len);
  int i_left = 0, i_right = 0;
  bool found_left = false, found_right = false;
  for (int k = 0; k < L; ++k)
    if (drow[clampi(l + k, 0, L - 1)] < mean_dist) {
      i_left = k;
      found_left = true;
      break;
    }
  for (int k = 0; k < L; ++k)
    if (drow[clampi(l - k, 0, L - 1)] < mean_dist) {
      i_right = k;
      found_right = true;
      break;
    }
  const float l_left = found_left ? l_g + (float)i_left * l_step : 0.f;
  const float l_right = found_right ? l_g - (float)i_right * l_step : 0.f;
  const float mid = l_right + (l_left - l_right) * 0.5f;
  const float mid_y = fminf(l_right + sc[C_D_LAT_COMF], mid);
  const float mid_z = fmaxf(l_left - sc[C_D_LAT_COMF], mid);
  const float l_trg = sc[C_L_TRG];
  const float mid_x =
      l_trg < l_right ? mid_y : (l_trg > l_left ? mid_z : l_trg);

  // the state cost and constraint, term by term
  float cost = 1000.f * fmaxf(l_g - d_left_ref, 0.f);
  cost = cost + 1000.f * fmaxf(d_right_ref - l_g, 0.f);
  float e = mid_x - l_g;
  cost = cost + sc[C_W_L] * (e * e);
  e = mid_y - l_g;
  cost = cost + (l_g < mid_y ? sc[C_W_LAT_DIST] * (e * e) : 0.f);
  e = mid_z - l_g;
  cost = cost + (l_g > mid_z ? sc[C_W_LAT_DIST] * (e * e) : 0.f);
  cost = cost + sc[C_W_PROGRESS] * (1000.f - s_g);
  const float constr = ds_g > v_max_ref ? ds_g - v_max_ref : 0.f;
  const float s_st = sc[C_S_ST], w_st = sc[C_W_ST];
  cost = cost + (t < sc[C_T_ST_MIN] ? w_st * fmaxf(s_g - s_st, 0.f) : 0.f);
  cost = cost + (t > sc[C_T_ST_MAX] ? w_st * fmaxf(s_st - s_g, 0.f) : 0.f);

  // the forward distances: center, then the running minimum to each side
  float dfwd[NB];
  const int* il2_l = il2 + l * NB;
  dfwd[0] = drow[il2_l[0]];
#pragma unroll
  for (int m = 1; m < NB; ++m)
    dfwd[m] = fminf(m == NB / 2 + 1 ? dfwd[0] : dfwd[m - 1], drow[il2_l[m]]);
#pragma unroll
  for (int m = 0; m < NB; ++m) dfwd[m] = dfwd[m] - half_len;

  const Best b = latlon_am_parent::best_action(rows + row * L, s_ca, tb,
                                               dfwd, ds, l, L, tile);
  out[cell] = make_float4(cost + b.cost, constr + b.constr, b.dds, b.dl);
}
}  // namespace latlon_am_parent

namespace poly_lat_parent {
using namespace poly_lat;

__global__ void __launch_bounds__(THREADS)
poly_lat_sweep_kernel(const float* __restrict__ occ,
                      const float* __restrict__ ref_line,
                      const float* __restrict__ ref_step_p,
                      const float* __restrict__ pp_in,
                      const float* __restrict__ env_in,
                      const float* __restrict__ start,
                      const double* __restrict__ hermite_inv,
                      float* __restrict__ cd_out, double* __restrict__ tc_out,
                      int LD, int SD, int S, int TE, int SE, int LE,
                      int n_ref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cost_sum = reinterpret_cast<double*>(smem_raw);
  double* sl = cost_sum + 1;
  double* sx = sl + S;
  double* sy = sx + S;
  double* sv = sy + S;
  double* scost = sv + S;
  double* st = scost + S;
  float* scoll = reinterpret_cast<float*>(st + S);

  const int tid = threadIdx.x;
  const int cand = blockIdx.x;
  const int il = cand / SD, isd = cand % SD;
  float pp[N_PP], ep[N_ENV];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  for (int k = 0; k < N_ENV; ++k) ep[k] = env_in[k];
  const float l0 = start[0], dl0 = start[1], ddl0 = start[2], s0 = start[3];
  const float v0 = start[4];
  const float ref_step = *ref_step_p;

  const float l_dst = axis_point(pp[L_DST_MIN], pp[L_DST_MAX], il,
                                 LD - 1 > 1 ? LD - 1 : 1);
  const float s_dst = axis_point(pp[S_DST_MIN], pp[S_DST_MAX], isd,
                                 SD - 1 > 1 ? SD - 1 : 1);
  const float s_step = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
  const float s_base = s0 + pp[S_MIN];
  const float s_end = s0 + s_dst;

  // the quintic from its boundary values (PolyQuintic): b scaled by d^k
  const float d = s_end - s0;
  const float b[NC] = {l0, dl0 * d, ddl0 * (d * d), l_dst, 0.0f * d,
                       0.0f * (d * d)};
  double c[NC];
  for (int m = 0; m < NC; ++m) {
    double acc = 0.0;
    for (int k = 0; k < NC; ++k) acc += (double)b[k] * hermite_inv[m * NC + k];
    c[m] = acc;
  }
  const double d1 = (double)d, d2 = (double)(d * d);
  const double d3 = (double)(d * (d * d));
  const double margin = (double)(pp[WIDTH_VEH] * 0.5f) * sqrt(2.0);
  const float a_lat = pp[A_LAT_ABS_MAX];

  for (int i = tid; i < S; i += blockDim.x) {
    const float s = fma32((float)i, s_step, s_base);
    const double u = (double)((s - s0) / d);
    const bool past_end = s >= s_end;
    const double l = past_end ? (double)l_dst : horner(c, u, 0);
    const double dl = past_end ? 0.0 : horner(c, u, 1) / d1;
    const double ddl = past_end ? 0.0 : horner(c, u, 2) / d2;
    const double dddl = past_end ? 0.0 : horner(c, u, 3) / d3;

    // the reference line at s (RefLine::lerp, float32)
    const float q = s / ref_step;
    const float i0f = clampf(floorf(q), 0.0f, (float)(n_ref - 1));
    const float i1f = clampf(ceilf(q), 0.0f, (float)(n_ref - 1));
    const float w = clampf(q - i0f, 0.0f, 1.0f);
    const float* r0 = ref_line + (size_t)(int)i0f * REF_CH;
    const float* r1 = ref_line + (size_t)(int)i1f * REF_CH;
    float rp[7];
    for (int ch = 0; ch < 7; ++ch) rp[ch] = r0[ch] * (1.0f - w) + r1[ch] * w;

    const double hf = atan(dl);
    const double x = (double)rp[RL_X] - (double)sinf(rp[RL_H]) * l;
    const double y = (double)rp[RL_Y] + (double)cosf(rp[RL_H]) * l;
    const double rk = (double)rp[RL_K];
    const double k = ((ddl / (dl * dl + 1.0) + rk) * cos(hf)) / (1.0 - l * rk);
    const double ak = fabs(k);
    const double k_abs_path = fmax(ak, (double)fabsf(rp[RL_K]));
    const double rv = (double)rp[RL_V];
    const double v = k_abs_path > 1e-6
        ? fmin(rv, sqrt((double)a_lat / fmax(k_abs_path, 1e-9)))
        : rv;

    // local constraints (poly_lat_planner.cu:64-76)
    const float mv = fminf(rp[RL_V], v0);
    double constr = fmax((double)(mv * mv) * ak - (double)a_lat, 0.0);
    const bool in_poly = s <= s_end;
    constr = constr + (in_poly ? fmax(ak - (double)pp[K_ABS_MAX], 0.0) : 0.0);
    constr = constr
        + (in_poly ? fmax(l - ((double)rp[RL_DL] - margin), 0.0) : 0.0);
    constr = constr
        + (in_poly ? fmax((-(double)rp[RL_DR] + margin) - l, 0.0) : 0.0);
    // local cost (poly_lat_planner.cu:78-92)
    double cost = ((double)pp[W_DL] * (dl * dl) + (double)pp[W_DDL] * (ddl * ddl))
        + (double)pp[W_DDDL] * (dddl * dddl);
    cost = cost + (ak > (double)fabsf(rp[RL_K]) ? (double)pp[W_K] * (k * k) : 0.0);
    cost = cost + 10e6 * constr;

    sl[i] = l;
    sx[i] = x;
    sy[i] = y;
    sv[i] = v;
    scost[i] = cost;
  }
  __syncthreads();

  // the segment times (poly_lat_planner.cu:102-148)
  for (int i = 1 + tid; i < S; i += blockDim.x) {
    const double dx = sx[i] - sx[i - 1];
    const double dy = sy[i] - sy[i - 1];
    st[i] = sqrt(dx * dx + dy * dy) / fmax(sv[i], 1.0);
  }
  __syncthreads();
  // their running sum on thread 0, the cost sum on a thread of warp 1
  if (tid == 0) {
    double t = 0.0;
    st[0] = 0.0;
    for (int i = 1; i < S; ++i) {
      t = t + st[i];
      st[i] = t;
    }
  } else if (tid == 32) {
    double acc = 0.0;
    for (int i = 0; i < S; ++i) acc = acc + scost[i];
    *cost_sum = acc;
  }
  __syncthreads();

  // collision checks (poly_lat_planner.cu:150-185): interpDistField
  // (env.cu:229-239) with the dt_start time mapping
  const float e_s_span = ep[E_S_MAX] - ep[E_S_MIN];
  const double e_l_span = (double)(ep[E_L_MAX] - ep[E_L_MIN]);
  for (int i = tid; i < S; i += blockDim.x) {
    const float s = fma32((float)i, s_step, s_base);
    const double t = st[i];
    const double l = sl[i];
    const float si = clampf(rintf((s - ep[E_S_MIN]) / e_s_span * (float)(SE - 1)),
                            0.0f, (float)(SE - 1));
    float dist_sem = 0.0f;
    // time offsets -1, 0, 1 s, lateral offsets 0, 0.25, -0.25 m
    for (int a = 0; a < 3; ++a) {
      const double tq = t + (double)(a - 1);
      const double t_idx = tq < (double)ep[E_DT_START]
          ? 0.0 : rint((tq - (double)ep[E_DT_START]) / (double)ep[E_DT]) + 1.0;
      const int ti = (int)clampd(t_idx, 0.0, (double)(TE - 1));
      for (int b2 = 0; b2 < 3; ++b2) {
        const double lq = l + (b2 == 0 ? 0.0 : (b2 == 1 ? 0.25 : -0.25));
        const int li = (int)clampd(
            rint((lq - (double)ep[E_L_MIN]) / e_l_span * (double)(LE - 1)),
            0.0, (double)(LE - 1));
        dist_sem = fmaxf(dist_sem,
                         occ[((size_t)ti * SE + (int)si) * LE + li]);
      }
    }
    const bool hit = dist_sem > 0.0f && t < 8.0 && s > pp[LENGTH_VEH];
    scoll[i] = hit ? s : 10000.0f;
  }
  __syncthreads();

  if (tid == 0) {
    float cmin = scoll[0];
    for (int i = 1; i < S; ++i) cmin = fminf(cmin, scoll[i]);
    double tc = *cost_sum;
    tc = tc + (double)(l_dst < -0.1f ? pp[W_RIGHT] : 0.0f);
    const float dl_t = l_dst - pp[L_TRG];
    tc = tc + (double)(pp[W_L] * (dl_t * dl_t));
    tc = tc + (double)(pp[W_LEN] * fabsf(s_dst));
    cd_out[cand] = fminf(cmin, 1000.0f);
    tc_out[cand] = tc;
  }
}
}  // namespace poly_lat_parent

// The bodies of 92bf3da that this tree changed, over the tree's helpers:
// the lon DP's terms with its backward slice and forward pass, the DP
// action-min's selection with its two kernels (which dropped a NaN of the
// distance map, the path's v_max or the lane bounds in their terms), and
// the lateral sweep and its selection, two launches then.  The NaN value
// tests show them failing where the tree's bodies follow the plain
// versions, and the tree's bodies bit-equal to them elsewhere.  (Their
// calls of the helpers copied here are qualified: an argument of the
// tree's namespace would find the tree's helper too.)
namespace lon_dp_92bf3da {
using namespace lon_dp;

__device__ __forceinline__ StateTerms state_terms(const float* pp, float s,
                                                  float v, float a,
                                                  float s_dist, float v_max) {
  StateTerms r;
  r.cost = (pp[W_A] * (a * a) + pp[W_PROGRESS] * fabsf(1000.0f - s))
      + pp[W_SAFETY_DIST]
            * fmaxf(v * pp[TIME_GAP] + pp[GAP_MIN] - s_dist, 0.0f);
  r.constr = fmaxf(v - v_max, 0.0f);
  return r;
}

// the action's cost and constraint from its looked-up value nn[0..2], the
// path's v_max at the next s, v_max_n, and the acceleration limits' terms
__device__ __forceinline__ void action_terms(const float* pp, StateTerms st,
                                             const float (&nn)[3], float j,
                                             float dt, const Next& n,
                                             float s_dist, float v_max_n,
                                             ALimits al, float* cost_out,
                                             float* constr_out) {
  float cost = st.cost + nn[0];
  float constr = st.constr + nn[1];
  const float dj = nn[2] - j;
  cost = cost + pp[W_SNAP] * (dj * dj);
  const float jd = j * dt;
  cost = cost + pp[W_J] * (jd * jd);
  constr = constr + fmaxf(n.vn - v_max_n, 0.0f);
  constr = constr + fmaxf(n.s_change - s_dist, 0.0f);
  constr = constr + al.below;
  constr = constr + al.above;
  *cost_out = cost;
  *constr_out = constr;
}


// a block: one v (blockIdx.x) and the s rows s0 .. s0 + tile - 1
// (blockIdx.y), every a; `box_cap` floats of shared memory for its box
__global__ void __launch_bounds__(MAX_THREADS, 2)
lon_backward_kernel(const float4* __restrict__ nodes_next,
                    const float* __restrict__ pp_in,
                    const float* __restrict__ path,
                    const float* __restrict__ dist_path,
                    float4* __restrict__ out, int S, int V, int A, int P,
                    int t_idx, bool is_last, int tile, int box_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* res = reinterpret_cast<float4*>(smem_raw);      // (tile, A)
  float* box = reinterpret_cast<float*>(res + tile * A);
  Coord* tab = reinterpret_cast<Coord*>(box + (box_cap + 3) / 4 * 4);
  float* vmax = reinterpret_cast<float*>(tab + A * NB);   // (P,)
  float* s_val = vmax + P;
  float* s_vmax = s_val + tile;
  float* s_slack = s_vmax + tile;
  int* part = reinterpret_cast<int*>(s_slack + tile);     // (warps, 4)

  float pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const int tid = threadIdx.x;
  const int i_v = blockIdx.x;
  const int s0 = blockIdx.y * tile;
  const int n_s = mini(tile, S - s0);
  const float v = axis_point(pp[V_MIN], pp[V_MAX], i_v, V - 1);
  const float pss = pp[PATH_STEP_SIZE];
  const float dt = pp[DT];

  int bs0 = 0, rs = 0, plane = 0;
  bool fits = true;
  if (!is_last) {
    // the (a, jerk) table and each warp's extremes of its row shifts and v
    // rows, then the block's
    const float s_step_x = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
    int k_lo = 0x7fffffff, k_hi = -0x7fffffff - 1;
    int y_lo = 0x7fffffff, y_hi = -0x7fffffff - 1;
    for (int e = tid; e < A * NB; e += blockDim.x) {
      const int i_a = e / NB, jb = e - i_a * NB;
      const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
      const float j = axis_point(pp[J_MIN], pp[J_MAX], jb, NB - 1);
      const Next n = next_state(0.0f, v, a, j, dt);
      Coord c;
      c.s_change = n.s_change;
      c.vn = n.vn;
      c.f_c = n.s_change / s_step_x;
      const float k_c = floorf(c.f_c);
      c.ax_c = c.f_c - k_c;
      const float y = clampf((n.vn - pp[V_MIN]) / (pp[V_MAX] - pp[V_MIN])
                             * (float)(V - 1), 0.0f, (float)(V - 1));
      const float z = clampf((n.an - pp[A_MIN]) / (pp[A_MAX] - pp[A_MIN])
                             * (float)(A - 1), 0.0f, (float)(A - 1));
      const float y0f = floorf(y), z0f = floorf(z);
      const float wy0 = 1.0f - (y - y0f);
      const float wz0 = 1.0f - (z - z0f);
      const int y0 = (int)y0f, z0 = (int)z0f;
      c.o[0] = y0;
      c.o[1] = mini(y0 + 1, V - 1);
      c.o[2] = z0;
      c.o[3] = mini(z0 + 1, A - 1);
      c.w00 = wy0 * wz0;
      c.w01 = wy0 * (1.0f - wz0);
      c.w10 = (1.0f - wy0) * wz0;
      c.w11 = (1.0f - wy0) * (1.0f - wz0);
      c.k = (int)k_c;
      c.al = a_limits(pp, n.an);
      c.j = j;
      tab[e] = c;
      k_lo = mini(k_lo, c.k);
      k_hi = k_hi > c.k ? k_hi : c.k;
      y_lo = mini(y_lo, c.o[0]);
      y_hi = y_hi > c.o[1] ? y_hi : c.o[1];
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2) {
      k_lo = mini(k_lo, __shfl_xor_sync(0xffffffffu, k_lo, o));
      const int kh = __shfl_xor_sync(0xffffffffu, k_hi, o);
      k_hi = k_hi > kh ? k_hi : kh;
      y_lo = mini(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, o));
      const int yh = __shfl_xor_sync(0xffffffffu, y_hi, o);
      y_hi = y_hi > yh ? y_hi : yh;
    }
    if ((tid & (WARP - 1)) == 0) {
      int* w = part + 4 * (tid / WARP);
      w[0] = k_lo;
      w[1] = k_hi;
      w[2] = y_lo;
      w[3] = y_hi;
    }
    __syncthreads();
    for (int w = 0; w < (int)(blockDim.x / WARP); ++w) {
      k_lo = mini(k_lo, part[4 * w]);
      k_hi = k_hi > part[4 * w + 1] ? k_hi : part[4 * w + 1];
      y_lo = mini(y_lo, part[4 * w + 2]);
      y_hi = y_hi > part[4 * w + 3] ? y_hi : part[4 * w + 3];
    }

    // the box: the rows every (s, jerk) of the tile reads (clamped as the
    // lookup clamps them) x the v rows y_lo .. y_hi x every a, one plane
    // per channel (cost, constraint, jerk); the copies run while the s
    // rows below are formed
    bs0 = clampi(s0 + k_lo, 0, S - 1);
    const int bs1 = clampi(s0 + n_s - 1 + k_hi + 1, 0, S - 1);
    const int row_len = (y_hi - y_lo + 1) * A;
    rs = row_stride(row_len);
    plane = (bs1 - bs0 + 1) * rs;
    fits = 3 * plane <= box_cap;
    if (fits)
      for (int q = tid; q < (bs1 - bs0 + 1) * row_len; q += blockDim.x) {
        const int r = q / row_len, c = q - r * row_len;
        const float* src = reinterpret_cast<const float*>(
            nodes_next + ((bs0 + r) * V + y_lo) * A + c);
        float* dst = box + r * rs + c;
        copy4_async(dst, src);
        copy4_async(dst + plane, src + 1);
        copy4_async(dst + 2 * plane, src + 2);
      }
    // the table's corners as offsets in a box row
    for (int e = tid; e < A * NB; e += blockDim.x) {
      int* o = tab[e].o;
      const int y0 = (o[0] - y_lo) * A, y1 = (o[1] - y_lo) * A;
      const int z0 = o[2], z1 = o[3];
      o[0] = y0 + z0;
      o[1] = y0 + z1;
      o[2] = y1 + z0;
      o[3] = y1 + z1;
    }
  }
  // the path's v_max column; the tile's s rows: grid value, v_max there and
  // the distance map's slack
  if (!is_last)
    for (int q = tid; q < P; q += blockDim.x)
      vmax[q] = path[q * N_PC + PC_VMAX];
  for (int r = tid; r < n_s; r += blockDim.x) {
    const float s = axis_point(pp[S_MIN], pp[S_MAX], s0 + r, S - 1);
    s_val[r] = s;
    s_vmax[r] = interp_col(path, PC_VMAX, s, pss, P);
    s_slack[r] = s_dist_at(dist_path, pp, t_idx,
                           interp_col(path, PC_S, s, pss, P), S);
  }
  copies_wait();
  __syncthreads();

  // a thread per (s, a) of the tile, neighbouring s on neighbouring lanes
  // (their table entries are one, their box rows neighbours)
  for (int item = tid; item < n_s * A; item += blockDim.x) {
    const int i_a = item / n_s, r = item - i_a * n_s;
    const int i_s = s0 + r;
    const float s = s_val[r];
    const float a = axis_point(pp[A_MIN], pp[A_MAX], i_a, A - 1);
    const float s_dist = s_slack[r];
    const StateTerms st = lon_dp_92bf3da::state_terms(pp, s, v, a, s_dist, s_vmax[r]);
    float4& o = res[r * A + i_a];
    if (is_last) {
      o = make_float4(st.cost, 0.0f, 0.0f, 0.0f);
      continue;
    }
    if (!fits) {
      o = make_float4(NAN, NAN, NAN, NAN);
      continue;
    }
    float cost[NB], constr[NB];
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const Coord& c = tab[i_a * NB + jb];
      Next n;
      n.s_change = c.s_change;
      n.vn = c.vn;
      n.sn = s + c.s_change;
      const int rows[2] = {clampi(i_s + c.k, 0, S - 1) - bs0,
                           clampi(i_s + c.k + 1, 0, S - 1) - bs0};
      const float ax_row = (float)i_s + c.f_c >= (float)(S - 1) ? 0.0f
                                                               : c.ax_c;
      float b[2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* base = box + rows[q] * rs;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* p = base + ch * plane;
          b[q][ch] = ((p[c.o[0]] * c.w00 + p[c.o[1]] * c.w01)
                      + p[c.o[2]] * c.w10)
                     + p[c.o[3]] * c.w11;
        }
      }
      float nn[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        nn[q] = b[0][q] * (1.0f - ax_row) + b[1][q] * ax_row;
      lon_dp_92bf3da::action_terms(pp, st, nn, c.j, dt, n, s_dist,
                   interp_staged(vmax, n.sn, pss, P), c.al, &cost[jb],
                   &constr[jb]);
    }
    // the plain version's lexicographic minimum (the rule above)
    float cmin = constr[0];
    bool nan_c = constr[0] != constr[0];
#pragma unroll
    for (int jb = 1; jb < NB; ++jb) {
      cmin = fminf(cmin, constr[jb]);
      nan_c = nan_c || constr[jb] != constr[jb];
    }
    if (nan_c) cmin = NAN;
    float best = INFINITY;
    int jbest = 0;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const float cj = constr[jb] <= cmin ? cost[jb] : INFINITY;
      if (cj < best || (cj != cj && best == best)) {
        best = cj;
        jbest = jb;
      }
    }
    o = make_float4(best, cmin,
                    axis_point(pp[J_MIN], pp[J_MAX], jbest, NB - 1), 0.0f);
  }
  __syncthreads();

  // the tile's nodes, a row of A at a time
  for (int q = tid; q < n_s * A; q += blockDim.x) {
    const int r = q / A;
    out[((s0 + r) * V + i_v) * A + (q - r * A)] = res[q];
  }
}

__device__ __forceinline__ Here here(const Staged& sg, const float* pp,
                                     int t_idx, float s, float v, float a,
                                     int S, int P) {
  Here h;
  float v_max;
  path_terms(sg, pp, t_idx, s, S, P, &v_max, &h.s_dist);
  h.st = lon_dp_92bf3da::state_terms(pp, s, v, a, h.s_dist, v_max);
  return h;
}

// Two warps.  Mode 0, the forward pass: T dependent steps, the NF = 21
// jerks on lanes 0..20 of each warp.  Both hold the state and its terms.
// Warp 0 forms its jerk's next state and issues the step's one round trip
// to device memory, the trilerp's 8 corners, blends them, forms the cost
// and constraint and takes the lexicographic minimum (warp_pick); lane 0
// writes the row.  Meanwhile warp 1 forms, for its jerk, v_max at the next
// s (which warp 0's constraint needs) and the state the row would lead to
// if that jerk won (the plain version's next-state formula) with that
// state's terms, into shared memory, so that after the minimum the next
// step's state and terms are the winner's, read there.  Mode 1, the reeval
// pass: every row of `states` with its own jerk, rows on the 64 threads.
// The path's columns and the distance map are staged in shared memory
// first; the copies run while step 0's corners load.
template <bool PROF>
__global__ void __launch_bounds__(2 * WARP)
lon_forward_kernel(const float4* __restrict__ nodes,
                   const float* __restrict__ pp_in,
                   const float* __restrict__ path,
                   const float* __restrict__ dist_path,
                   const float* __restrict__ states, float* __restrict__ out,
                   unsigned long long* __restrict__ prof, int T, int S, int V,
                   int A, int P, int n_rows, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const Staged sg = {smem, smem + P, smem + 2 * P};
  float* cand = smem + 2 * P + T * S;         // (2, N_CAND, NF)
  float* vmax_n = cand + 2 * N_CAND * NF;     // (NF,)
  int* win = reinterpret_cast<int*>(vmax_n + NF);
  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), warp = tid / WARP;
  LaneClock<PROF> clk;
  clk.start();
  float pp[N_PP];
#pragma unroll
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  for (int q = tid; q < P; q += 2 * WARP) {
    copy4_async(smem + q, path + q * N_PC + PC_S);
    copy4_async(smem + P + q, path + q * N_PC + PC_VMAX);
  }
  for (int q = tid; q < T * S; q += 2 * WARP) copy4_async(smem + 2 * P + q,
                                                          dist_path + q);
  const size_t slice = (size_t)S * V * A;
  const float pss = pp[PATH_STEP_SIZE];

  if (mode == 1) {
    copies_wait();
    __syncthreads();
    // reeval: every row with its own jerk, rows on the threads
    for (int r = tid; r < n_rows; r += 2 * WARP) {
      float row[N_LC];
#pragma unroll
      for (int c = 0; c < N_LC; ++c) row[c] = states[r * N_LC + c];
      const float dt_i = r == 0 ? pp[DT_START] : pp[DT];
      const float s = row[LC_S], v = row[LC_V], a = row[LC_A];
      const float j = row[LC_J];
      const Here h = lon_dp_92bf3da::here(sg, pp, t_index(row[LC_T], pp, T), s, v, a, S, P);
      const Next n = next_state(s, v, a, j, dt_i);
      float nn[3];
      blend(corners(nodes + mini(r + 1, T - 1) * slice, pp, S, V, A, n.sn,
                    n.vn, n.an), nn);
      float cost, constr;
      lon_dp_92bf3da::action_terms(pp, h.st, nn, j, dt_i, n, h.s_dist,
                   interp_staged(sg.vmax_col, n.sn, pss, P),
                   a_limits(pp, n.an), &cost, &constr);
      // one action: cmin is its constraint, the cost survives unless NaN
      cost = constr <= constr ? cost : INFINITY;
      float o[N_LC];
      finish_row(row, pp, T, h.st.cost, cost, constr, j, o);
#pragma unroll
      for (int c = 0; c < N_LC; ++c) out[r * N_LC + c] = o[c];
    }
    return;
  }

  const unsigned FULL = 0xffffffffu;
  float tp[N_LC];
#pragma unroll
  for (int c = 0; c < N_LC; ++c) tp[c] = states[c];
  const bool valid = lane < NF;
  const int jl = valid ? lane : 0;
  const float j = axis_point(pp[J_MIN], pp[J_MAX], jl, NF - 1);
  Here h;     // the state's terms (step 0's once the staging is in)
  clk.stamp(F_STAGE);
  for (int i = 0; i < T; ++i) {
    const float dt_i = i == 0 ? pp[DT_START] : pp[DT];
    const float s = tp[LC_S], v = tp[LC_V], a = tp[LC_A];
    const Next n = next_state(s, v, a, j, dt_i);
    const bool is_last = rintf(tp[LC_T] / pp[DT]) == (float)(T - 1);
    float* cb = cand + (i & 1) * N_CAND * NF;
    if (warp == 1) {
      if (i == 0) {
        copies_wait();
        __syncthreads();
        h = lon_dp_92bf3da::here(sg, pp, t_index(tp[LC_T], pp, T), s, v, a, S, P);
      }
      // v_max at each jerk's next s, for warp 0's constraints
      if (valid) vmax_n[lane] = interp_staged(sg.vmax_col, n.sn, pss, P);
      pair_arrive(1);
      // the state each jerk's row leads to, and its terms
      const float jj = is_last ? tp[LC_J] : j;
      const float dt2 = dt_i * dt_i;
      const float s_n = fmaxf(s, s + v * dt_i + 0.5f * a * dt2
                              + jj * (dt_i * (dt_i * dt_i)) * (1.0f / 6.0f));
      const float v_n = fmaxf(v + a * dt_i + 0.5f * jj * dt2, 0.0f);
      const float a_n = a + jj * dt_i;
      if (valid && i + 1 < T) {
        const Here h_n = lon_dp_92bf3da::here(sg, pp, t_index(tp[LC_T] + dt_i, pp, T), s_n,
                              v_n, a_n, S, P);
        cb[C_S * NF + lane] = s_n;
        cb[C_V * NF + lane] = v_n;
        cb[C_A * NF + lane] = a_n;
        cb[C_SDIST * NF + lane] = h_n.s_dist;
        cb[C_COST * NF + lane] = h_n.st.cost;
        cb[C_CONSTR * NF + lane] = h_n.st.constr;
      }
      pair_sync(2);
    } else {
      const Corners k = corners(nodes + mini(i + 1, T - 1) * slice, pp, S, V,
                                A, n.sn, n.vn, n.an);
      if (i == 0) {
        copies_wait();
        __syncthreads();
        h = lon_dp_92bf3da::here(sg, pp, t_index(tp[LC_T], pp, T), s, v, a, S, P);
        clk.stamp(F_STAGE);
      }
      float nn[3];
      blend(k, nn);
      clk.stamp(F_LOOKUP);
      pair_sync(1);
      float cost, constr;
      lon_dp_92bf3da::action_terms(pp, h.st, nn, j, dt_i, n, h.s_dist, vmax_n[jl],
                   a_limits(pp, n.an), &cost, &constr);
      clk.stamp(F_TERMS);
      const Pick pk = warp_pick(constr, cost, valid);
      clk.stamp(F_PICK);
      const float c_tier = __shfl_sync(FULL, constr, pk.tier);
      const float k_win = __shfl_sync(FULL, cost, pk.k);
      if (lane == 0) {
        float row[N_LC];
        finish_row(tp, pp, T, h.st.cost,
                   pk.nan_c || pk.all_inf ? INFINITY : k_win,
                   pk.nan_c ? NAN : c_tier,
                   axis_point(pp[J_MIN], pp[J_MAX], pk.k, NF - 1), row);
#pragma unroll
        for (int c = 0; c < N_LC; ++c) out[i * N_LC + c] = row[c];
        *win = pk.k;
      }
      pair_sync(2);
    }
    // the next state: the winner's, with its terms
    const int kw = *win;
    tp[LC_T] = tp[LC_T] + dt_i;
    tp[LC_J] = is_last ? tp[LC_J]
                       : axis_point(pp[J_MIN], pp[J_MAX], kw, NF - 1);
    tp[LC_COST] = 0.0f;
    tp[LC_CONSTR] = 0.0f;
    if (i + 1 < T) {
      tp[LC_S] = cb[C_S * NF + kw];
      tp[LC_V] = cb[C_V * NF + kw];
      tp[LC_A] = cb[C_A * NF + kw];
      h.s_dist = cb[C_SDIST * NF + kw];
      h.st.cost = cb[C_COST * NF + kw];
      h.st.constr = cb[C_CONSTR * NF + kw];
    }
    clk.stamp(F_NEXT);
  }
  clk.flush(prof);
}

}  // namespace lon_dp_92bf3da

namespace latlon_am_92bf3da {
using namespace latlon_am;

// The lexicographic (constraint, cost) minimum over the 7 x 7 actions of one
// cell, dl outer and dds inner (the XLA flattening order of the argmin),
// first minimum winning, as the plain version and the XLA backward take it:
// the least constraint by jnp.min (a NaN makes it NaN), then jnp.argmin of
// the costs whose constraint equals it, the rest inf (the first NaN wins),
// and the winner's own cost and constraint.  So where a constraint is NaN,
// or every action of the least constraint costs inf, no cost beats the
// masked inf of action 0, and action 0 wins with its own cost and
// constraint.  my_rows: the staged rows of the cell's s, entry (j, lt) at
// my_rows[j * tile + lt]; dfwd: the cell's 7 forward distances.
__device__ __forceinline__ Best best_action(
    const float4* my_rows, const float* s_ca, const Tables& tb,
    const float (&dfwd)[NB], int ds, int l, int L, int tile) {
  const float gap_min = tb.consts[0], time_gap = tb.consts[1];
  const float w_safety = tb.consts[2], w_ddds = tb.consts[3];
  const float w_ddl = tb.consts[4];
  const float ds_gap = tb.dss[ds] * time_gap;

  float sc[NB], dds_v[NB], q_dds[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    sc[j] = tb.schg[ds * NB + j];
    dds_v[j] = tb.dds_vals[j];
    q_dds[j] = tb.qdds[j];
  }

  // action (m, j): its cost and constraint, the plain version's terms in
  // their order
  auto action = [&](int m, int j, float& cost, float& constr) {
    const int lt = clampi(l + tb.kl[m], 0, L - 1);
    const float d_safety = (dfwd[m] - gap_min) - ds_gap;
    const float4 nn = my_rows[j * tile + lt];

    const float occ = fmaxf(0.f, sc[j] - dfwd[m]);
    constr = (s_ca[j * NB + m] + occ) + nn.y;

    cost = w_safety * fmaxf(0.f, sc[j] - d_safety);
    cost = cost + q_dds[j];
    const float e_dds = nn.z - dds_v[j];
    cost = cost + w_ddds * (e_dds * e_dds);
    cost = cost + tb.qdl[m];
    const float e_dl = nn.w - tb.dl_vals[m];
    cost = cost + w_ddl * (e_dl * e_dl);
    cost = cost + nn.x;
  };

  Best b = {0.f, 0.f, 0.f, 0.f};
  bool first = true, nan_c = false;
#pragma unroll
  for (int m = 0; m < NB; ++m) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float cost, constr;
      action(m, j, cost, constr);
      nan_c = nan_c || constr != constr;
      if (first || constr < b.constr ||
          (constr == b.constr &&
           (cost < b.cost || (cost != cost && b.cost == b.cost)))) {
        b.constr = constr;
        b.cost = cost;
        b.dds = dds_v[j];
        b.dl = tb.dl_vals[m];
        first = false;
      }
    }
  }
  if (nan_c || b.cost == INFINITY) {
    action(0, 0, b.cost, b.constr);
    b.dds = dds_v[0];
    b.dl = tb.dl_vals[0];
  }
  return b;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == FEW_THREADS ? FEW_BLOCKS
                                                                  : 1)
action_min_kernel(
    const float4* __restrict__ nodes_next,   // (S, DS, L) x 4 channels
    const float* __restrict__ state_cost,    // (S, DS, L)
    const float* __restrict__ state_constr,  // (S, DS, L)
    const float* __restrict__ d_fwd,         // (S, L, NB)
    const int* __restrict__ ids,             // (DS, NB) target ds row
    const int* __restrict__ ks,              // (DS, NB) s shift (cells)
    const int* __restrict__ kl,              // (NB,)    l shift (cells)
    const float* __restrict__ ca,            // (DS, NB, NB) slope constr
    const float* __restrict__ schg,          // (DS, NB) s change
    const float* __restrict__ qdds,          // (NB,)
    const float* __restrict__ qdl,           // (NB,)
    const float* __restrict__ dds_vals,      // (NB,)
    const float* __restrict__ dl_vals,       // (NB,)
    const float* __restrict__ dss,           // (DS,)
    const float* __restrict__ consts,        // gap_min, time_gap, w_safety,
                                             // w_ddds, w_ddl
    float4* __restrict__ out,                // (S, DS, L) x 4 channels
    int S, int DS, int L, int ts_rows) {
  // (the tables arrive as read-only kernel parameters of their own, which
  // is what lets the compiler keep their loads out of the way)
  const Tables tb = {ids, ks, kl, ca, schg, qdds, qdl, dds_vals, dl_vals,
                     dss, consts};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* rows = reinterpret_cast<float4*>(smem_raw);   // (NB, ts_rows, L)
  float* s_ca = reinterpret_cast<float*>(rows + NB * ts_rows * L);  // (j, m)

  const int tid = threadIdx.x;
  const int ds = blockIdx.y;
  const int s0 = blockIdx.x * ts_rows;
  const int tile = ts_rows * L;
  stage_lookups(rows, s_ca, nodes_next, tb, ds, s0, S, DS, L, tile);
  copies_wait();
  __syncthreads();

  const int row = tid / L;
  const int l = tid - row * L;
  const int s = s0 + row;
  if (tid >= tile || s >= S) return;
  const int cell = (s * DS + ds) * L + l;

  float dfwd[NB];
  const float* dfwd_cell = d_fwd + (s * L + l) * NB;
#pragma unroll
  for (int m = 0; m < NB; ++m) dfwd[m] = dfwd_cell[m];

  const Best b = latlon_am_92bf3da::best_action(rows + row * L, s_ca, tb, dfwd, ds, l, L, tile);
  out[cell] = make_float4(state_cost[cell] + b.cost,
                          state_constr[cell] + b.constr, b.dds, b.dl);
}

// One whole backward slice: what the plain version computes with some
// hundred tensor operations before the action-min (the state cost and
// constraint of every cell, with the nearest reference-line row, the two
// first-obstacle searches along l and the mid-lane target, and the 7
// forward distances with their per-side running minimum), computed per cell
// from the tile's rows of the distance map in shared memory, then the
// action-min above.  Every expression keeps the plain version's operations
// and their order (reference: lat_lon_planner.cu:80-192 computed the same
// per cell inside its backward step).
template <int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == FEW_THREADS ? FEW_BLOCKS
                                                                  : 1)
backward_slice_kernel(
    const float4* __restrict__ nodes_next,   // (S, DS, L) x 4 channels
    const float* __restrict__ dist_t,        // (S, L) distance ahead
    const float* __restrict__ ref_line,      // (n_ref, 8)
    const float* __restrict__ ref_step,      // one value
    const float* __restrict__ sc,            // SliceConst
    const int* __restrict__ ids,             // (DS, NB) target ds row
    const int* __restrict__ ks,              // (DS, NB) s shift (cells)
    const int* __restrict__ kl,              // (NB,)    l shift (cells)
    const float* __restrict__ ca,            // (DS, NB, NB) slope constr
    const float* __restrict__ schg,          // (DS, NB) s change
    const float* __restrict__ qdds,          // (NB,)
    const float* __restrict__ qdl,           // (NB,)
    const float* __restrict__ dds_vals,      // (NB,)
    const float* __restrict__ dl_vals,       // (NB,)
    const float* __restrict__ dss,           // (DS,)
    const float* __restrict__ consts,        // gap_min, time_gap, w_safety,
                                             // w_ddds, w_ddl
    float4* __restrict__ out,                // (S, DS, L) x 4 channels
    int S, int DS, int L, int n_ref, int slice, int ts_rows) {
  // (the tables arrive as read-only kernel parameters of their own, which
  // is what lets the compiler keep their loads out of the way)
  const Tables tb = {ids, ks, kl, ca, schg, qdds, qdl, dds_vals, dl_vals,
                     dss, consts};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* rows = reinterpret_cast<float4*>(smem_raw);   // (NB, ts_rows, L)
  float* s_ca = reinterpret_cast<float*>(rows + NB * ts_rows * L);  // (j, m)
  float* dist = s_ca + NB * NB;                         // (ts_rows, L)
  int* il2 = reinterpret_cast<int*>(dist + ts_rows * L);   // (L, NB)

  const int tid = threadIdx.x;
  const int ds = blockIdx.y;
  const int s0 = blockIdx.x * ts_rows;
  const int tile = ts_rows * L;
  const float l_min = sc[C_L_MIN], l_step = sc[C_L_STEP], dt = sc[C_DT];

  stage_lookups(rows, s_ca, nodes_next, tb, ds, s0, S, DS, L, tile);
  for (int k = tid; k < tile; k += blockDim.x)
    dist[k] = dist_t[clampi(s0 + k / L, 0, S - 1) * L + k % L];
  // the l index each dl action's lateral sweep reads, per l
  for (int k = tid; k < L * NB; k += blockDim.x) {
    const float l_g = l_min + (float)(k / NB) * l_step;
    const float at = rintf(((l_g + tb.dl_vals[k % NB] * dt) - l_min) / l_step);
    il2[k] = (int)fminf(fmaxf(at, 0.f), (float)(L - 1));
  }
  copies_wait();
  __syncthreads();

  const int row = tid / L;
  const int l = tid - row * L;
  const int s = s0 + row;
  if (tid >= tile || s >= S) return;
  const int cell = (s * DS + ds) * L + l;

  const float s_g = sc[C_S_MIN] + (float)s * sc[C_S_STEP];
  const float l_g = l_min + (float)l * l_step;
  const float ds_g = tb.dss[ds];
  const float t = sc[C_DT_START] + (float)(slice - 1) * dt;
  const float half_len = sc[C_LENGTH_VEH] * 0.5f;
  const float* drow = dist + row * L;

  // the nearest reference-line row (round half to even)
  const float at = rintf(s_g / *ref_step);
  const float* rl =
      ref_line + (size_t)(int)fminf(fmaxf(at, 0.f), (float)(n_ref - 1)) * 8;
  const float v_max_ref = rl[4];
  const float half_width = sc[C_WIDTH_VEH] * 0.5f;
  const float d_left_ref = rl[5] - half_width;
  const float d_right_ref = -(rl[6] - half_width);

  // the first l offset to each side whose distance ahead is too short
  const float mean_dist = fmaxf(ds_g * dt, half_len);
  int i_left = 0, i_right = 0;
  bool found_left = false, found_right = false;
  for (int k = 0; k < L; ++k)
    if (drow[clampi(l + k, 0, L - 1)] < mean_dist) {
      i_left = k;
      found_left = true;
      break;
    }
  for (int k = 0; k < L; ++k)
    if (drow[clampi(l - k, 0, L - 1)] < mean_dist) {
      i_right = k;
      found_right = true;
      break;
    }
  const float l_left = found_left ? l_g + (float)i_left * l_step : 0.f;
  const float l_right = found_right ? l_g - (float)i_right * l_step : 0.f;
  const float mid = l_right + (l_left - l_right) * 0.5f;
  const float mid_y = fminf(l_right + sc[C_D_LAT_COMF], mid);
  const float mid_z = fmaxf(l_left - sc[C_D_LAT_COMF], mid);
  const float l_trg = sc[C_L_TRG];
  const float mid_x =
      l_trg < l_right ? mid_y : (l_trg > l_left ? mid_z : l_trg);

  // the state cost and constraint, term by term
  float cost = 1000.f * fmaxf(l_g - d_left_ref, 0.f);
  cost = cost + 1000.f * fmaxf(d_right_ref - l_g, 0.f);
  float e = mid_x - l_g;
  cost = cost + sc[C_W_L] * (e * e);
  e = mid_y - l_g;
  cost = cost + (l_g < mid_y ? sc[C_W_LAT_DIST] * (e * e) : 0.f);
  e = mid_z - l_g;
  cost = cost + (l_g > mid_z ? sc[C_W_LAT_DIST] * (e * e) : 0.f);
  cost = cost + sc[C_W_PROGRESS] * (1000.f - s_g);
  const float constr = ds_g > v_max_ref ? ds_g - v_max_ref : 0.f;
  const float s_st = sc[C_S_ST], w_st = sc[C_W_ST];
  cost = cost + (t < sc[C_T_ST_MIN] ? w_st * fmaxf(s_g - s_st, 0.f) : 0.f);
  cost = cost + (t > sc[C_T_ST_MAX] ? w_st * fmaxf(s_st - s_g, 0.f) : 0.f);

  // the forward distances: center, then the running minimum to each side
  float dfwd[NB];
  const int* il2_l = il2 + l * NB;
  dfwd[0] = drow[il2_l[0]];
#pragma unroll
  for (int m = 1; m < NB; ++m)
    dfwd[m] = fminf(m == NB / 2 + 1 ? dfwd[0] : dfwd[m - 1], drow[il2_l[m]]);
#pragma unroll
  for (int m = 0; m < NB; ++m) dfwd[m] = dfwd[m] - half_len;

  const Best b = latlon_am_92bf3da::best_action(rows + row * L, s_ca, tb, dfwd, ds, l, L, tile);
  out[cell] = make_float4(cost + b.cost, constr + b.constr, b.dds, b.dl);
}

}  // namespace latlon_am_92bf3da

namespace poly_lat_92bf3da {
using namespace poly_lat;

// A block per candidate, a thread per sample (S <= THREADS at the demo
// sets; more samples take turns).  The quintic's six coefficients are formed
// once, by six threads; each sample's evaluation and segment time as
// before; the path times are the running sum of the segment times on
// thread 0 in the plain version's order (the chain's sums stay in a
// register; the loads of the segment times run ahead of it); the cost sum
// and the least collision station are a block's warp reductions.
template <bool PROF>
__global__ void __launch_bounds__(THREADS)
poly_lat_sweep_kernel(const float* __restrict__ occ,
                      const float* __restrict__ ref_line,
                      const float* __restrict__ ref_step_p,
                      const float* __restrict__ pp_in,
                      const float* __restrict__ env_in,
                      const float* __restrict__ start,
                      const double* __restrict__ hermite_inv,
                      float* __restrict__ cd_out, double* __restrict__ tc_out,
                      unsigned long long* __restrict__ prof, int LD, int SD,
                      int S, int TE, int SE, int LE, int n_ref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* coef = reinterpret_cast<double*>(smem_raw);   // (NC,)
  double* w_cost = coef + NC;                            // (WARPS,)
  double* sl = w_cost + WARPS;
  double* sx = sl + S;
  double* sy = sx + S;
  double* sv = sy + S;
  double* st = sv + S;
  float* w_coll = reinterpret_cast<float*>(st + S);      // (WARPS,)

  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), warp = tid / WARP;
  const int cand = blockIdx.x;
  const int il = cand / SD, isd = cand % SD;
  BlockClock<PROF> clk;
  clk.start();
  float pp[N_PP], ep[N_ENV];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  for (int k = 0; k < N_ENV; ++k) ep[k] = env_in[k];
  const float l0 = start[0], dl0 = start[1], ddl0 = start[2], s0 = start[3];
  const float v0 = start[4];
  const float ref_step = *ref_step_p;

  const float l_dst = axis_point(pp[L_DST_MIN], pp[L_DST_MAX], il,
                                 LD - 1 > 1 ? LD - 1 : 1);
  const float s_dst = axis_point(pp[S_DST_MIN], pp[S_DST_MAX], isd,
                                 SD - 1 > 1 ? SD - 1 : 1);
  const float s_step = (pp[S_MAX] - pp[S_MIN]) * (1.0f / (float)(S - 1));
  const float s_base = s0 + pp[S_MIN];
  const float s_end = s0 + s_dst;

  // the quintic from its boundary values (PolyQuintic): b scaled by d^k,
  // c[m] = sum_k b[k] inv[m][k] on thread m
  const float d = s_end - s0;
  if (tid < NC) {
    const float b[NC] = {l0, dl0 * d, ddl0 * (d * d), l_dst, 0.0f * d,
                         0.0f * (d * d)};
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      acc += (double)b[k] * hermite_inv[tid * NC + k];
    coef[tid] = acc;
  }
  __syncthreads();
  double c[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) c[m] = coef[m];
  clk.stamp(P_COEF);
  const double d1 = (double)d, d2 = (double)(d * d);
  const double d3 = (double)(d * (d * d));
  const double margin = (double)(pp[WIDTH_VEH] * 0.5f) * sqrt(2.0);
  const float a_lat = pp[A_LAT_ABS_MAX];

  double cost_part = 0.0;
  for (int i = tid; i < S; i += blockDim.x) {
    const float s = fma32((float)i, s_step, s_base);
    const double u = (double)((s - s0) / d);
    const bool past_end = s >= s_end;
    const double l = past_end ? (double)l_dst : horner(c, u, 0);
    const double dl = past_end ? 0.0 : horner(c, u, 1) / d1;
    const double ddl = past_end ? 0.0 : horner(c, u, 2) / d2;
    const double dddl = past_end ? 0.0 : horner(c, u, 3) / d3;

    // the reference line at s (RefLine::lerp, float32)
    const float q = s / ref_step;
    const float i0f = clampf(floorf(q), 0.0f, (float)(n_ref - 1));
    const float i1f = clampf(ceilf(q), 0.0f, (float)(n_ref - 1));
    const float w = clampf(q - i0f, 0.0f, 1.0f);
    const float* r0 = ref_line + (size_t)(int)i0f * REF_CH;
    const float* r1 = ref_line + (size_t)(int)i1f * REF_CH;
    float rp[7];
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) rp[ch] = r0[ch] * (1.0f - w) + r1[ch] * w;

    const double hf = atan(dl);
    const double x = (double)rp[RL_X] - (double)sinf(rp[RL_H]) * l;
    const double y = (double)rp[RL_Y] + (double)cosf(rp[RL_H]) * l;
    const double rk = (double)rp[RL_K];
    const double k = ((ddl / (dl * dl + 1.0) + rk) * cos(hf)) / (1.0 - l * rk);
    const double ak = fabs(k);
    const double k_abs_path = fmax(ak, (double)fabsf(rp[RL_K]));
    const double rv = (double)rp[RL_V];
    const double v = k_abs_path > 1e-6
        ? fmin(rv, sqrt((double)a_lat / fmax(k_abs_path, 1e-9)))
        : rv;

    // local constraints (poly_lat_planner.cu:64-76)
    const float mv = fminf(rp[RL_V], v0);
    double constr = fmax((double)(mv * mv) * ak - (double)a_lat, 0.0);
    const bool in_poly = s <= s_end;
    constr = constr + (in_poly ? fmax(ak - (double)pp[K_ABS_MAX], 0.0) : 0.0);
    constr = constr
        + (in_poly ? fmax(l - ((double)rp[RL_DL] - margin), 0.0) : 0.0);
    constr = constr
        + (in_poly ? fmax((-(double)rp[RL_DR] + margin) - l, 0.0) : 0.0);
    // local cost (poly_lat_planner.cu:78-92)
    double cost = ((double)pp[W_DL] * (dl * dl) + (double)pp[W_DDL] * (ddl * ddl))
        + (double)pp[W_DDDL] * (dddl * dddl);
    cost = cost + (ak > (double)fabsf(rp[RL_K]) ? (double)pp[W_K] * (k * k) : 0.0);
    cost = cost + 10e6 * constr;

    sl[i] = l;
    sx[i] = x;
    sy[i] = y;
    sv[i] = v;
    cost_part = cost_part + cost;
  }
  __syncthreads();
  clk.stamp(P_SAMPLES);

  // the segment times (poly_lat_planner.cu:102-148)
  for (int i = 1 + tid; i < S; i += blockDim.x) {
    const double dx = sx[i] - sx[i - 1];
    const double dy = sy[i] - sy[i - 1];
    st[i] = sqrt(dx * dx + dy * dy) / fmax(sv[i], 1.0);
  }
  // the cost sum: each warp's, then warp 0 adds the warps' (an order other
  // than the plain version's sum, to rounding)
#pragma unroll
  for (int o = WARP / 2; o > 0; o /= 2)
    cost_part = cost_part + __shfl_xor_sync(0xffffffffu, cost_part, o);
  if (lane == 0) w_cost[warp] = cost_part;
  __syncthreads();
  clk.stamp(P_SEGMENTS);
  // their running sum, in order, on the block's last thread (which holds
  // no sample at the demo set's S = 201); meanwhile the other threads form
  // what their samples' occupancy lookups need besides the time: the s
  // index and the three lateral indices
  if (tid == (int)blockDim.x - 1) {
    double t = 0.0;
    st[0] = 0.0;
#pragma unroll 16
    for (int i = 1; i < S; ++i) {
      t = t + st[i];
      st[i] = t;
    }
  }
  const float e_s_span = ep[E_S_MAX] - ep[E_S_MIN];
  const double e_l_span = (double)(ep[E_L_MAX] - ep[E_L_MIN]);
  int s_idx[PER_THREAD], l_idx[PER_THREAD][3];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = tid + q * THREADS;
    if (i >= S) continue;
    const float s = fma32((float)i, s_step, s_base);
    s_idx[q] = (int)clampf(rintf((s - ep[E_S_MIN]) / e_s_span
                                 * (float)(SE - 1)), 0.0f, (float)(SE - 1));
#pragma unroll
    for (int b2 = 0; b2 < 3; ++b2) {
      const double lq = sl[i] + (b2 == 0 ? 0.0 : (b2 == 1 ? 0.25 : -0.25));
      l_idx[q][b2] = (int)clampd(
          rint((lq - (double)ep[E_L_MIN]) / e_l_span * (double)(LE - 1)),
          0.0, (double)(LE - 1));
    }
  }
  __syncthreads();
  clk.stamp(P_TIMES);

  // collision checks (poly_lat_planner.cu:150-185): interpDistField
  // (env.cu:229-239) with the dt_start time mapping, time offsets -1, 0,
  // 1 s and lateral offsets 0, 0.25, -0.25 m
  float coll = INFINITY;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = tid + q * THREADS;
    if (i >= S) continue;
    const float s = fma32((float)i, s_step, s_base);
    const double t = st[i];
    float dist_sem = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double tq = t + (double)(a - 1);
      const double t_idx = tq < (double)ep[E_DT_START]
          ? 0.0 : rint((tq - (double)ep[E_DT_START]) / (double)ep[E_DT]) + 1.0;
      const int ti = (int)clampd(t_idx, 0.0, (double)(TE - 1));
#pragma unroll
      for (int b2 = 0; b2 < 3; ++b2)
        dist_sem = max_nan(
            dist_sem, occ[((size_t)ti * SE + s_idx[q]) * LE + l_idx[q][b2]]);
    }
    const bool hit = dist_sem > 0.0f && t < 8.0 && s > pp[LENGTH_VEH];
    coll = min_nan(coll, hit ? s : 10000.0f);
  }
  clk.stamp(P_COLLISION);
  // the least collision station: each warp's, then thread 0's
#pragma unroll
  for (int o = WARP / 2; o > 0; o /= 2)
    coll = min_nan(coll, __shfl_xor_sync(0xffffffffu, coll, o));
  if (lane == 0) w_coll[warp] = coll;
  __syncthreads();

  if (tid == 0) {
    const int warps = (int)(blockDim.x / WARP);
    float cmin = w_coll[0];
    double tc = w_cost[0];
    for (int w2 = 1; w2 < warps; ++w2) {
      cmin = min_nan(cmin, w_coll[w2]);
      tc = tc + w_cost[w2];
    }
    tc = tc + (double)(l_dst < -0.1f ? pp[W_RIGHT] : 0.0f);
    const float dl_t = l_dst - pp[L_TRG];
    tc = tc + (double)(pp[W_L] * (dl_t * dl_t));
    tc = tc + (double)(pp[W_LEN] * fabsf(s_dst));
    cd_out[cand] = min_nan(cmin, 1000.0f);
    tc_out[cand] = tc;
  }
  clk.stamp(P_REDUCE);
  clk.flush(prof);
}

__global__ void poly_lat_select_kernel(const float* __restrict__ cd,
                                       const double* __restrict__ tc,
                                       const float* __restrict__ length_veh,
                                       long long* __restrict__ best_out,
                                       float* __restrict__ cost_out, int LD,
                                       int SD) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int n = LD * SD;
  const float lv = *length_veh;
  const int init_l = LD / 2 + 1 < LD - 1 ? LD / 2 + 1 : LD - 1;
  const int init = init_l * SD + SD - 1;
  float max_cd = cd[init];
  for (int i = 0; i < n; ++i) {
    if ((float)tc[i] < 1e6f && cd[i] > max_cd + lv) max_cd = cd[i];
  }
  float min_cost = INFINITY;
  int best = init;
  for (int i = 0; i < n; ++i) {
    const float ti = (float)tc[i];
    if (fabsf(cd[i] - max_cd) <= 1.0f && ti < min_cost) {
      max_cd = cd[i];
      min_cost = ti;
      best = i;
    }
  }
  *best_out = best;
  *cost_out = min_cost;
}

}  // namespace poly_lat_92bf3da
"""

HARNESS = r"""
#include <thread>
#include <vector>
#include "ilqr_tracking_mpc.cu"
#include "ilqr_tracking_mpc_time.cu"
#include "ilqr_rstp.cu"
#include "ilqr_generic.cu"
#include "rstp_rampify.cu"
#include "latlon_action_min.cu"
#include "lon_dp.cu"
#include "poly_lat.cu"
#include "idm_rollout.cu"
#include "idm_evaluate.cu"
#include "poly_sampling.cu"
#include "dir_dist_map.cu"
#include "poly_planner.cu"
#include "parents.cuh"
#include "generated.cuh"

// The grid's two-launch design before the one launch (the helpers are the
// kernel source's): a block of 32 threads a candidate, then one block for
// the selection.
namespace poly_sampling_two {
using namespace poly_sampling_k;

__global__ void eval_kernel(
    const float* __restrict__ start, const float* __restrict__ di,
    const float* __restrict__ Ti, const float* __restrict__ tv,
    const float* __restrict__ ts, const float* __restrict__ path,
    const float* __restrict__ hulls, const float* __restrict__ valid,
    const float* __restrict__ pp_in, const double* __restrict__ inv,
    double* __restrict__ rows_out, double* __restrict__ cost_out, int C,
    int N, int n_path, int O, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cl = reinterpret_cast<double*>(smem_raw);    // quintic (6)
  double* cs = cl + 6;                                 // quartic (5)
  double* row = cs + 5;                                // (9, N)
  double* term = row + 9 * N;                          // (N_TERMS, N)
  int* hits = reinterpret_cast<int*>(term + N_TERMS * N);
  float* nrm = reinterpret_cast<float*>(hits + N);     // (O, K, 2)
  float* po_min = nrm + O * K * 2;                     // (O, K)
  float* po_max = po_min + O * K;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = blockIdx.x;
  float pp[N_PP];
  for (int k = 0; k < N_PP; ++k) pp[k] = pp_in[k];
  const float T_end = Ti[c];
  const float d = T_end - 0.0f;        // x1 - x0, the polynomials' span

  if (tid == 0) {
    // PolyQuintic(0, d0, dd0, ddd0, T, d_end, 0, 0): b = [y0, dy0 d,
    // ddy0 (d d), y1, 0 d, 0 (d d)], c = b . inv^T
    const float b5[6] = {start[0], start[1] * d, start[2] * (d * d), di[c],
                         0.0f * d, 0.0f * (d * d)};
    for (int m = 0; m < 6; ++m) {
      double acc = 0.0;
      for (int k = 0; k < 6; ++k) acc += (double)b5[k] * inv[m * 6 + k];
      cl[m] = acc;
    }
    // PolyQuartic(0, s0, sd0, sdd0, T, v_end, 0): b = [s0, v d, (a d) d,
    // ve d, (0 d) d]
    const float b4[5] = {start[3], start[4] * d, start[5] * d * d, tv[c] * d,
                         0.0f * d * d};
    for (int m = 0; m < 5; ++m) {
      double acc = 0.0;
      for (int k = 0; k < 5; ++k) acc += (double)b4[k] * inv[36 + m * 5 + k];
      cs[m] = acc;
    }
  }
  // the obstacles' edge normals and their self-projections
  for (int e = tid; e < O * K; e += nt) {
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

  const double x0e = (double)(-pp[REAR_AXIS_TO_REAR]);
  const double x1e = (double)pp[REAR_AXIS_TO_FRONT];
  const double be = (double)(pp[WIDTH_EGO] / 2.0f);
  const float xs0 = path[3], dxs = path[6 + 3] - path[3];
  for (int n = tid; n < N; n += nt) {
    const float u = (ts[n] - 0.0f) / d;
    const double dv = poly_eval(cl, 5, 0, u, d);
    const double d_d = poly_eval(cl, 5, 1, u, d);
    const double d_dd = poly_eval(cl, 5, 2, u, d);
    const double d_ddd = poly_eval(cl, 5, 3, u, d);
    const double sv = poly_eval(cs, 4, 0, u, d);
    const double s_d = poly_eval(cs, 4, 1, u, d);
    const double s_dd = poly_eval(cs, 4, 2, u, d);
    const double s_ddd = poly_eval(cs, 4, 3, u, d);

    const double q = (sv - (double)xs0) / (double)dxs;
    const double rx = lerp_path(path, n_path, q, 0, false);
    const double ry = lerp_path(path, n_path, q, 1, false);
    const double rh = lerp_path(path, n_path, q, 2, true);
    const double rv = lerp_path(path, n_path, q, 5, false);
    const double hf = atan(d_d / (s_d == 0.0 ? 1e-9 : s_d));
    const double x = rx - sin(rh) * dv;
    const double y = ry + cos(rh) * dv;
    const double yaw = hf + rh;

    // the collision screen at this pose
    int nh = 0;
    const double cy_ = cos(yaw), sy_ = sin(yaw);
    for (int o = 0; o < O; ++o) {
      if (valid[o] == 0.0f) continue;
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

    row[O_D * N + n] = dv;
    row[O_D_D * N + n] = d_d;
    row[O_D_DD * N + n] = d_dd;
    row[O_S * N + n] = sv;
    row[O_S_D * N + n] = s_d;
    row[O_S_DD * N + n] = s_dd;
    row[O_X * N + n] = x;
    row[O_Y * N + n] = y;
    row[O_YAW * N + n] = yaw;
    term[T_JP * N + n] = d_ddd * d_ddd;
    term[T_JS * N + n] = s_ddd * s_ddd;
    term[T_JR * N + n] = dv < 0.0 ? -dv : 0.0;
    term[T_P1 * N + n] = fmax(fabs(s_d) - rv, 0.0);
    term[T_P3 * N + n] = fmax(fabs(s_dd) - (double)pp[A_MAX], 0.0);
    term[T_P4 * N + n] = fmax(fabs(dv) - 4.0, 0.0);
    hits[n] = nh;
  }
  __syncthreads();

  // the segments and the curvature
  double* out = rows_out + (size_t)c * N_ROWS * N;
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
  __syncthreads();

  if (tid == 0) {
    double sums[N_TERMS];
    int n_hits = 0;
    for (int t = 0; t < N_TERMS; ++t) {
      double acc = term[t * N];
      for (int n = 1; n < N; ++n) acc = acc + term[t * N + n];
      sums[t] = acc;
    }
    for (int n = 0; n < N; ++n) n_hits += hits[n];
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
    if (O > 0) cost = cost + (double)((float)PENALTY * (float)n_hits);
    cost_out[c] = cost;
  }
}

__global__ void select_kernel(const double* __restrict__ rows,
                              const double* __restrict__ costs,
                              double* __restrict__ packed,
                              double* __restrict__ cost_out,
                              long long* __restrict__ best_out, int C,
                              int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int& best_s = *reinterpret_cast<int*>(smem_raw);
  if (threadIdx.x == 0) {
    int best = 0;
    double bc = costs[0];
    for (int c = 1; c < C; ++c)
      if (costs[c] < bc) {
        bc = costs[c];
        best = c;
      }
    best_s = best;
    *cost_out = bc;
    *best_out = best;
  }
  __syncthreads();
  const double* src = rows + (size_t)best_s * N_ROWS * N;
  for (int i = threadIdx.x; i < N_ROWS * N; i += blockDim.x)
    packed[i] = src[i];
}
}  // namespace poly_sampling_two


// the kernels' dynamic shared memory (an extern array declared inside a
// function belongs to the function's namespace)
namespace ilqr_mpc { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_mpc_f32 { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_mpc_time { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_rstp { alignas(16) unsigned char smem_raw[262144]; }
namespace ilqr_generic { alignas(16) unsigned char smem_raw[262144]; }
namespace rstp_rampify { alignas(16) unsigned char smem_raw[65536]; }
namespace latlon_am { alignas(16) unsigned char smem_raw[262144]; }
namespace lon_dp { alignas(16) unsigned char smem_raw[262144]; }
namespace poly_lat { alignas(16) unsigned char smem_raw[65536]; }
namespace idm_rollout_k { alignas(16) unsigned char smem_raw[262144]; }
namespace idm_evaluate_k { alignas(16) unsigned char smem_raw[262144]; }
namespace poly_sampling_k { alignas(16) unsigned char smem_raw[65536]; }
namespace poly_sampling_two { alignas(16) unsigned char smem_raw[65536]; }
namespace dir_dist { alignas(16) unsigned char smem_raw[262144]; }
namespace poly_planner_k { alignas(16) unsigned char smem_raw[65536]; }
namespace lon_dp_parent { alignas(16) unsigned char smem_raw[262144]; }
namespace latlon_am_parent { alignas(16) unsigned char smem_raw[262144]; }
namespace poly_lat_parent { alignas(16) unsigned char smem_raw[65536]; }
namespace lon_dp_92bf3da { alignas(16) unsigned char smem_raw[262144]; }
namespace latlon_am_92bf3da { alignas(16) unsigned char smem_raw[262144]; }
namespace poly_lat_92bf3da { alignas(16) unsigned char smem_raw[65536]; }

// A grid of gx x gy blocks of `threads` threads (256 unless given): every
// host thread runs its thread of each block in turn (the blocks share the
// one shared-memory array, so they run one after the other, kept apart by
// a block barrier), in the order of `order` (gx x gy block numbers, y * gx
// + x) where given, else x fastest.
template <class F>
static void run_grid(unsigned gx, unsigned gy, F body,
                     unsigned threads = 256, const int* order = nullptr) {
  std::barrier<> block(threads);
  rehearsal::block_barrier = &block;
  blockDim = {threads, 1, 1};
  std::vector<std::thread> pool;
  for (unsigned i = 0; i < threads; ++i)
    pool.emplace_back([=] {
      threadIdx.x = i;
      gridDim = {gx, gy, 1};
      for (unsigned b = 0; b < gx * gy; ++b) {
        const unsigned n = order ? (unsigned)order[b] : b;
        blockIdx.x = n % gx;
        blockIdx.y = n / gx;
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

// the backward slice on its launcher's grid: a block a v and `tile` s rows
extern "C" void rehearse_lon_backward(const float* nodes_next, const float* pp,
                                      const float* path,
                                      const float* dist_path, float* out,
                                      int S, int V, int A, int P, int t_idx,
                                      int is_last, int tile, int box_cap) {
  using namespace lon_dp;
  run_grid(V, (S + tile - 1) / tile, [=] {
    lon_backward_kernel(reinterpret_cast<const float4*>(nodes_next), pp, path,
                        dist_path, reinterpret_cast<float4*>(out), S, V, A, P,
                        t_idx, is_last != 0, tile, box_cap);
  }, backward_threads(A, tile));
}

// the forward / reeval pass on its launcher's one warp; with `prof` (mode
// 0) the profiling instantiation
extern "C" void rehearse_lon_forward(const float* nodes, const float* pp,
                                     const float* path, const float* dist_path,
                                     const float* states, float* out, int T,
                                     int S, int V, int A, int P, int n_rows,
                                     int mode) {
  using namespace lon_dp;
  run_grid(1, 1, [=] {
    lon_forward_kernel<false>(reinterpret_cast<const float4*>(nodes), pp,
                              path, dist_path, states, out, nullptr, T, S, V,
                              A, P, n_rows, mode);
  }, 2 * WARP);
}

extern "C" void rehearse_lon_forward_profile(
    const float* nodes, const float* pp, const float* path,
    const float* dist_path, const float* states, float* out,
    unsigned long long* prof, int T, int S, int V, int A, int P) {
  using namespace lon_dp;
  run_grid(1, 1, [=] {
    lon_forward_kernel<true>(reinterpret_cast<const float4*>(nodes), pp, path,
                             dist_path, states, out, prof, T, S, V, A, P, T,
                             0);
  }, 2 * WARP);
}

// the lon DP's backward slice and forward pass of 2dd76fb (PARENTS)
extern "C" void rehearse_lon_backward_parent(
    const float* nodes_next, const float* pp, const float* path,
    const float* dist_path, float* out, int S, int V, int A, int P,
    int t_idx, int is_last, int tile, int box_cap) {
  using namespace lon_dp;
  run_grid(V, (S + tile - 1) / tile, [=] {
    lon_dp_parent::lon_backward_kernel(
        reinterpret_cast<const float4*>(nodes_next), pp, path, dist_path,
        reinterpret_cast<float4*>(out), S, V, A, P, t_idx, is_last != 0, tile,
        box_cap);
  }, backward_threads(A, tile));
}

extern "C" void rehearse_lon_forward_parent(
    const float* nodes, const float* pp, const float* path,
    const float* dist_path, const float* states, float* out, int T, int S,
    int V, int A, int P, int n_rows, int mode) {
  run_block([=] {
    lon_dp_parent::lon_forward_kernel(reinterpret_cast<const float4*>(nodes),
                                      pp, path, dist_path, states, out, T, S,
                                      V, A, P, n_rows, mode);
  });
}

// the lon DP's backward slice and forward pass of 92bf3da (PARENTS)
extern "C" void rehearse_lon_backward_92bf3da(
    const float* nodes_next, const float* pp, const float* path,
    const float* dist_path, float* out, int S, int V, int A, int P,
    int t_idx, int is_last, int tile, int box_cap) {
  using namespace lon_dp;
  run_grid(V, (S + tile - 1) / tile, [=] {
    lon_dp_92bf3da::lon_backward_kernel(
        reinterpret_cast<const float4*>(nodes_next), pp, path, dist_path,
        reinterpret_cast<float4*>(out), S, V, A, P, t_idx, is_last != 0, tile,
        box_cap);
  }, backward_threads(A, tile));
}

extern "C" void rehearse_lon_forward_92bf3da(
    const float* nodes, const float* pp, const float* path,
    const float* dist_path, const float* states, float* out, int T, int S,
    int V, int A, int P, int n_rows, int mode) {
  using namespace lon_dp;
  run_grid(1, 1, [=] {
    lon_dp_92bf3da::lon_forward_kernel<false>(
        reinterpret_cast<const float4*>(nodes), pp, path, dist_path, states,
        out, nullptr, T, S, V, A, P, n_rows, mode);
  }, 2 * WARP);
}

// The sweep and its selection in one launch on a grid of LD x SD blocks,
// in the order `order` (LD x SD block numbers) where given; with `prof` the
// profiling instantiation.
extern "C" int rehearse_poly_lat_sweep(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start, const double* inv,
    float* cd, double* tc, long long* best, float* cost,
    unsigned long long* prof, const int* order, int LD, int SD, int S,
    int TE, int SE, int LE, int n_ref) {
  using namespace poly_lat;
  static int counter = 0;
  run_grid(LD * SD, 1, [=] {
    if (prof)
      poly_lat_sweep_kernel<true>(occ, ref_line, ref_step, pp, env, start,
                                  inv, cd, tc, best, cost, &counter, prof, LD,
                                  SD, S, TE, SE, LE, n_ref);
    else
      poly_lat_sweep_kernel<false>(occ, ref_line, ref_step, pp, env, start,
                                   inv, cd, tc, best, cost, &counter, nullptr,
                                   LD, SD, S, TE, SE, LE, n_ref);
  }, THREADS, order);
  return counter;     // the last block puts it back to 0
}

// the sweep of 2dd76fb (PARENTS)
extern "C" void rehearse_poly_lat_sweep_parent(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start, const double* inv,
    float* cd, double* tc, int LD, int SD, int S, int TE, int SE, int LE,
    int n_ref) {
  run_grid(LD * SD, 1, [=] {
    poly_lat_parent::poly_lat_sweep_kernel(occ, ref_line, ref_step, pp, env,
                                           start, inv, cd, tc, LD, SD, S, TE,
                                           SE, LE, n_ref);
  });
}

// the selection of the sweep's last block on given maps
extern "C" void rehearse_poly_lat_select(const float* cd, const double* tc,
                                         const float* length_veh,
                                         long long* best, float* cost, int LD,
                                         int SD) {
  run_block([=] {
    poly_lat::select_block(cd, tc, LD, SD, *length_veh,
                           reinterpret_cast<float*>(poly_lat::smem_raw), best,
                           cost);
  });
}

// the sweep and the selection of 92bf3da (PARENTS): two launches
extern "C" void rehearse_poly_lat_sweep_92bf3da(
    const float* occ, const float* ref_line, const float* ref_step,
    const float* pp, const float* env, const float* start, const double* inv,
    float* cd, double* tc, long long* best, float* cost, int LD, int SD,
    int S, int TE, int SE, int LE, int n_ref) {
  run_grid(LD * SD, 1, [=] {
    poly_lat_92bf3da::poly_lat_sweep_kernel<false>(
        occ, ref_line, ref_step, pp, env, start, inv, cd, tc, nullptr, LD, SD,
        S, TE, SE, LE, n_ref);
  });
  run_block([=] {
    poly_lat_92bf3da::poly_lat_select_kernel(
        cd, tc, pp + poly_lat::LENGTH_VEH, best, cost, LD, SD);
  });
}

extern "C" void rehearse_poly_lat_select_92bf3da(
    const float* cd, const double* tc, const float* length_veh,
    long long* best, float* cost, int LD, int SD) {
  run_block([=] {
    poly_lat_92bf3da::poly_lat_select_kernel(cd, tc, length_veh, best, cost,
                                             LD, SD);
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

// the poly-sampling grid's one launch (a block per candidate, the last to
// arrive selects), the blocks in `order`; with `prof` the profiling
// instantiation
extern "C" void rehearse_poly_sampling(
    const float* start, const float* di, const float* Ti, const float* tv,
    const float* ts, const float* path, const float* hulls,
    const float* valid, const float* pp, const double* inv, double* rows,
    double* costs, double* packed, double* cost, long long* best,
    int* counter, unsigned long long* prof, const int* order, int C, int N,
    int n_path, int O, int K) {
  using namespace poly_sampling_k;
  run_grid(C, 1, [=] {
    if (prof)
      poly_sampling_kernel<true>(start, di, Ti, tv, ts, path, hulls, valid,
                                 pp, inv, rows, costs, packed, cost, best,
                                 counter, prof, C, N, n_path, O, K);
    else
      poly_sampling_kernel<false>(start, di, Ti, tv, ts, path, hulls, valid,
                                  pp, inv, rows, costs, packed, cost, best,
                                  counter, nullptr, C, N, n_path, O, K);
  }, 256, order);
}

extern "C" size_t poly_sampling_smem_bytes(int N, int O, int K) {
  return poly_sampling_k::smem_bytes(N, O, K);
}

// the two-launch design the grid had before (a block of 32 threads per
// candidate, thread 0 solving the coefficients and summing the terms, a
// thread a step running the whole collision screen; then a one-block
// selection that keeps the strictly smaller cost), for the rows' bits and
// the selection's fault with a NaN cost
extern "C" void rehearse_poly_sampling_two_kernel(
    const float* start, const float* di, const float* Ti, const float* tv,
    const float* ts, const float* path, const float* hulls,
    const float* valid, const float* pp, const double* inv, double* rows,
    double* costs, double* packed, double* cost, long long* best, int C,
    int N, int n_path, int O, int K) {
  run_grid(C, 1, [=] {
    poly_sampling_two::eval_kernel(start, di, Ti, tv, ts, path, hulls, valid,
                                   pp, inv, rows, costs, C, N, n_path, O, K);
  }, 32);
  run_block([=] {
    poly_sampling_two::select_kernel(rows, costs, packed, cost, best, C, N);
  });
}

// the directional distance field: a grid of S x ceil(T / 32) blocks, the
// launcher's; with `prof` the profiling instantiation
extern "C" void rehearse_dir_dist(const float* occ, const float* ray,
                                  float s_min, float s_step, float l_min,
                                  float l_step, float step, float* out,
                                  unsigned long long* prof, int T, int S,
                                  int L, int D, int R) {
  using namespace dir_dist;
  run_grid(S, (T + GROUP - 1) / GROUP, [=] {
    if (prof)
      dir_dist_kernel<true>(occ, ray, s_min, s_step, l_min, l_step, step,
                            out, prof, T, S, L, D, R);
    else
      dir_dist_kernel<false>(occ, ray, s_min, s_step, l_min, l_step, step,
                             out, nullptr, T, S, L, D, R);
  }, block_threads(L, D));
}

extern "C" size_t dir_dist_smem_bytes(int T, int S, int L, int D, int R) {
  return dir_dist::smem_bytes(T, S, L, D, R);
}

// one level's edge evaluation as the launcher runs it: the field's slice
// straight ahead into `slice`, then a thread per edge; consts as the
// launcher's; with `prof` the profiling instantiation
extern "C" void rehearse_poly_eval(const float* start_pts,
                                   const int* edge_starts,
                                   const float* end_specs,
                                   const float* dir_dist, const float* ref_line,
                                   float* slice, float* out,
                                   unsigned long long* prof,
                                   const float* consts, int E, int is_last,
                                   int R, int T, int S, int L, int D,
                                   int n_ref) {
  using namespace poly_planner_k;
  EvalParams p;
  std::memcpy(p.ev, consts, sizeof(p.ev));
  std::memcpy(p.m4, consts + N_EV, sizeof(p.m4));
  std::memcpy(p.h5, consts + N_EV + 25, sizeof(p.h5));
  const int n = T * S * L;
  run_grid((n + THREADS - 1) / THREADS, 1, [=] {
    field_slice_kernel(dir_dist, slice, p.ev[DIR_MIN], p.ev[DIR_MAX], n, D);
  });
  run_grid((E + THREADS - 1) / THREADS, 1, [=] {
    if (prof)
      eval_edges_kernel<true>(start_pts, edge_starts, end_specs, slice,
                              ref_line, out, prof, p, E, is_last, R, T, S, L,
                              n_ref);
    else
      eval_edges_kernel<false>(start_pts, edge_starts, end_specs, slice,
                               ref_line, out, nullptr, p, E, is_last, R, T,
                               S, L, n_ref);
  });
}

// the propagation's one launch on the launcher's grid, the blocks in
// `order` (its length the grid's); offs as the launcher's; with `prof` the
// profiling instantiation
extern "C" int poly_propagate_blocks(const int* offs, int K) {
  const int n = offs[K] - offs[K - 1];
  return n > 0 ? (n + poly_planner_k::WARPS - 1) / poly_planner_k::WARPS : 1;
}

extern "C" void rehearse_poly_propagate(const float* pts, double* node_cost,
                                        int* best, const int* seg,
                                        double* traj, const int* offs,
                                        int* counter,
                                        unsigned long long* prof,
                                        const int* order, int K) {
  using namespace poly_planner_k;
  Levels lv;
  std::memcpy(lv.node_off, offs, sizeof(lv.node_off));
  std::memcpy(lv.seg_off, offs + MAX_LEVELS + 2, sizeof(lv.seg_off));
  run_grid(poly_propagate_blocks(offs, K), 1, [=] {
    if (prof)
      propagate_kernel<true>(pts, node_cost, best, seg, traj, counter, prof,
                             lv, K);
    else
      propagate_kernel<false>(pts, node_cost, best, seg, traj, counter,
                              nullptr, lv, K);
  }, 256, order);
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

// the fused slice over a batch of B scenarios (backward_slice_batch_kernel)
// on `blocks` persistent blocks of the launcher's threads (the tile's cells
// in whole warps), one after the other in `order` (block numbers) where
// given; `prof` (N_PHASE counts) selects the profiling
// instantiation; scenario b's distance map at dist_t + b * dist_stride
extern "C" void rehearse_backward_slice_persistent(
    const float* nodes_next, const float* dist_t, const float* ref_line,
    const float* ref_step, const float* slice_consts,
    const void* const* tables, float* out, int S, int DS, int L, int n_ref,
    int slice, int ts_rows, int B, long long dist_stride, int blocks,
    const int* order, unsigned long long* prof) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid(blocks, 1, [=] {
    if (prof)
      backward_slice_batch_kernel<FEW_THREADS, true>(
          reinterpret_cast<const float4*>(nodes_next), dist_t, ref_line,
          ref_step, slice_consts, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg,
          tb.qdds, tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
          reinterpret_cast<float4*>(out), prof, S, DS, L, n_ref, slice,
          ts_rows, B, dist_stride);
    else
      backward_slice_batch_kernel<FEW_THREADS, false>(
          reinterpret_cast<const float4*>(nodes_next), dist_t, ref_line,
          ref_step, slice_consts, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg,
          tb.qdds, tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
          reinterpret_cast<float4*>(out), nullptr, S, DS, L, n_ref, slice,
          ts_rows, B, dist_stride);
  }, (ts_rows * L + 31) / 32 * 32, order);
}

// the same with a block a work item (the whole batch in one walk), the
// blocks in `order` where given
extern "C" void rehearse_backward_slice_batch(
    const float* nodes_next, const float* dist_t, const float* ref_line,
    const float* ref_step, const float* slice_consts,
    const void* const* tables, float* out, int S, int DS, int L, int n_ref,
    int slice, int ts_rows, int B, long long dist_stride, const int* order) {
  rehearse_backward_slice_persistent(
      nodes_next, dist_t, ref_line, ref_step, slice_consts, tables, out, S,
      DS, L, n_ref, slice, ts_rows, B, dist_stride,
      (S + ts_rows - 1) / ts_rows * DS * B, order, nullptr);
}

// the action-min and the fused slice of 2dd76fb (PARENTS)
extern "C" void rehearse_action_min_parent(
    const float* nodes_next, const float* state_cost,
    const float* state_constr, const float* d_fwd, const void* const* tables,
    float* out, int S, int DS, int L, int ts_rows) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid((S + ts_rows - 1) / ts_rows, DS, [=] {
    latlon_am_parent::action_min_kernel<FEW_THREADS>(
        reinterpret_cast<const float4*>(nodes_next), state_cost, state_constr,
        d_fwd, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg, tb.qdds, tb.qdl,
        tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
        reinterpret_cast<float4*>(out), S, DS, L, ts_rows);
  });
}

extern "C" void rehearse_backward_slice_parent(
    const float* nodes_next, const float* dist_t, const float* ref_line,
    const float* ref_step, const float* slice_consts,
    const void* const* tables, float* out, int S, int DS, int L, int n_ref,
    int slice, int ts_rows) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid((S + ts_rows - 1) / ts_rows, DS, [=] {
    latlon_am_parent::backward_slice_kernel<FEW_THREADS>(
        reinterpret_cast<const float4*>(nodes_next), dist_t, ref_line,
        ref_step, slice_consts, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg, tb.qdds,
        tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
        reinterpret_cast<float4*>(out), S, DS, L, n_ref, slice, ts_rows);
  });
}

// the action-min and the fused slice of 92bf3da (PARENTS)
extern "C" void rehearse_action_min_92bf3da(
    const float* nodes_next, const float* state_cost,
    const float* state_constr, const float* d_fwd, const void* const* tables,
    float* out, int S, int DS, int L, int ts_rows) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid((S + ts_rows - 1) / ts_rows, DS, [=] {
    latlon_am_92bf3da::action_min_kernel<FEW_THREADS>(
        reinterpret_cast<const float4*>(nodes_next), state_cost, state_constr,
        d_fwd, tb.ids, tb.ks, tb.kl, tb.ca, tb.schg, tb.qdds, tb.qdl,
        tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
        reinterpret_cast<float4*>(out), S, DS, L, ts_rows);
  });
}

extern "C" void rehearse_backward_slice_92bf3da(
    const float* nodes_next, const float* dist_t, const float* ref_line,
    const float* ref_step, const float* slice_consts,
    const void* const* tables, float* out, int S, int DS, int L, int n_ref,
    int slice, int ts_rows) {
  using namespace latlon_am;
  const Tables tb = tables_of(tables);
  run_grid((S + ts_rows - 1) / ts_rows, DS, [=] {
    latlon_am_92bf3da::backward_slice_kernel<FEW_THREADS>(
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

// the time-indexed MPC's solve, its profiling instantiation when prof is
// given
extern "C" void rehearse_mpc_time(const double* in, double* out,
                                  long long* prof, int H, int n_ref, int T,
                                  int max_it, int max_lg, int mu_step,
                                  int integrator) {
  using namespace ilqr_mpc_time;
  run_block([=] {
    if (prof)
      ilqr_tracking_mpc_time_kernel<true>(in, out, prof, H, n_ref, T, max_it,
                                          max_lg, mu_step, integrator);
    else
      ilqr_tracking_mpc_time_kernel<false>(in, out, nullptr, H, n_ref, T,
                                           max_it, max_lg, mu_step,
                                           integrator);
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

// the generic AL-iLQR body (csrc/ilqr_generic.cu, and from id 100 the
// structs the sympy front end prints, generated.cuh) in double or float:
// slots == 0 the block geometry, a grid of B blocks of 256 threads, block b
// on row b, at `limit` bytes of shared memory a block; else the resident
// geometry, `grid` blocks of `slots` warps walking the B rows, at `limit`
// bytes a slot; the blocks in `order` where given
template <class P, typename R>
static void rehearse_generic_one(int integ, const R* shared, const R* rows,
                                 R* out, R* ws, long long* prof, int B, int H,
                                 int n_ref, int T, int max_it, int max_lg,
                                 size_t limit, int slots, int grid,
                                 const int* order) {
  using namespace ilqr_generic;
  R* smr = reinterpret_cast<R*>(smem_raw);
  const size_t cap = limit / sizeof(R);
  typedef Solve<P, R> S;
  auto body = [=] {
#define RUN(PR)                                                            \
  (slots == 0 ? S::template run<PR>(smr, ws, cap, shared, rows, out, prof,  \
                                    H, n_ref, T, max_it, max_lg, integ)     \
              : S::template run_resident<PR>(smr, ws, cap, slots, shared,   \
                                             rows, out, prof, B, H, n_ref,  \
                                             T, max_it, max_lg, integ))
    if (prof)
      RUN(true);
    else
      RUN(false);
#undef RUN
  };
  if (slots == 0)
    run_grid(B, 1, body, 256, order);
  else
    run_grid(grid, 1, body, slots * 32, order);
}

extern "C" void rehearse_generic(int problem, int f64, int integ,
                                 const void* shared, const void* rows,
                                 void* out, void* ws, long long* prof, int B,
                                 int H, int n_ref, int T, int max_it,
                                 int max_lg, size_t limit, int slots,
                                 int grid, const int* order) {
  using namespace ilqr_generic;
  // float: ref_line_smoother_dk alone (its Riccati pass on the lanes)
  if (problem == 1 && !f64)
    return rehearse_generic_one<RefLineSmootherDK<float>, float>(
        integ, (const float*)shared, (const float*)rows, (float*)out,
        (float*)ws, prof, B, H, n_ref, T, max_it, max_lg, limit, slots, grid,
        order);
#define X(ID, P)                                                           \
  if (problem == ID && f64)                                                \
    return rehearse_generic_one<P<double>, double>(                        \
        integ, (const double*)shared, (const double*)rows, (double*)out,   \
        (double*)ws, prof, B, H, n_ref, T, max_it, max_lg, limit, slots,   \
        grid, order);
  ILQR_GENERIC_PROBLEMS(X)
  GENERATED_PROBLEMS(X)
#undef X
}

// the words of shared memory (which = 0; a resident block's at `slots`)
// and of workspace (1) a block (slots == 0) or a slot takes at `limit`
// bytes; which = 3: whether its derivative blocks lie in the workspace,
// staged in shared memory for the backward pass
extern "C" size_t rehearse_generic_words(int problem, int f64, int H,
                                         int n_ref, size_t limit, int slots,
                                         int which) {
  using namespace ilqr_generic;
  size_t n_sm = 0, n_ws = 0;
  bool staged = false;
  auto words = [&](auto solve, size_t cap) {
    typedef decltype(solve) S;
    typename S::Mem m{};
    if (slots == 0) {
      S::carve(nullptr, nullptr, H, n_ref, cap, &m, &n_sm, &n_ws);
    } else {
      typename S::Carver c{nullptr, nullptr, cap, 0, 0};
      S::carve_slot(c, H, &m);
      n_sm = S::shared_len(H, n_ref) + slots * c.o_sm;
      n_ws = c.o_ws;
    }
    staged = m.staged;
  };
  if (problem == 1 && !f64)
    words(Solve<RefLineSmootherDK<float>, float>{}, limit / 4);
#define X(ID, P) \
  if (problem == ID && f64) words(Solve<P<double>, double>{}, limit / 8);
  ILQR_GENERIC_PROBLEMS(X)
  GENERATED_PROBLEMS(X)
#undef X
  return which == 3 ? (size_t)staged : which == 1 ? n_ws : n_sm;
}

extern "C" size_t rehearse_rstp_smem(int problem, int H, int n_ref) {
  using namespace ilqr_rstp;
  return problem == 0
      ? Solve<Lateral<double>, double>::carve(nullptr, H, n_ref, nullptr)
      : Solve<Velocity<double>, double>::carve(nullptr, H, n_ref, nullptr);
}
"""


def generated_structs():
    """generated.cuh of the harness: the struct the sympy front end prints
    for the genopt MPC (``scenes.genopt_mpc_config``), id 100."""
    from tpl_tpu_torch.optim import genopt

    spec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
    return (f"{spec.struct}\n#define GENERATED_PROBLEMS(X) "
            f"X(100, {spec.struct_name})\n")


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    """The two kernel bodies compiled for the host, as a ctypes library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies for the host")
    tmp = tmp_path_factory.mktemp("rehearsal")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "parents.cuh").write_text(PARENTS)
    (tmp / "generated.cuh").write_text(generated_structs())
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
    lib.rehearse_mpc_time.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
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
    lib.rehearse_generic.restype = None
    lib.rehearse_generic.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_size_t] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.rehearse_generic_words.restype = ctypes.c_size_t
    lib.rehearse_generic_words.argtypes = ([ctypes.c_int] * 4
                                           + [ctypes.c_size_t]
                                           + [ctypes.c_int] * 2)
    lib.ilqr_generic_split.restype = ctypes.c_size_t
    lib.ilqr_generic_split.argtypes = ([ctypes.c_int] * 4
                                       + [ctypes.c_size_t, ctypes.c_int])
    lib.rehearse_rampify.restype = None
    lib.rehearse_rampify.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.rehearse_rampify_start.restype = None
    lib.rehearse_rampify_start.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.rehearse_lon_backward.restype = None
    lib.rehearse_lon_backward.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 8)
    lib.lon_dp_backward_smem_bytes.restype = ctypes.c_size_t
    lib.lon_dp_backward_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.rehearse_lon_forward_profile.restype = None
    lib.rehearse_lon_forward_profile.argtypes = ([ctypes.c_void_p] * 7
                                                 + [ctypes.c_int] * 5)
    lib.lon_dp_forward_smem_bytes.restype = ctypes.c_size_t
    lib.lon_dp_forward_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.lon_dp_backward_threads.restype = ctypes.c_int
    lib.lon_dp_backward_threads.argtypes = [ctypes.c_int] * 2
    lib.rehearse_lon_forward.restype = None
    lib.rehearse_lon_forward.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 7)
    lib.rehearse_lon_backward_parent.restype = None
    lib.rehearse_lon_backward_parent.argtypes = ([ctypes.c_void_p] * 5
                                                 + [ctypes.c_int] * 8)
    lib.rehearse_lon_forward_parent.restype = None
    lib.rehearse_lon_forward_parent.argtypes = ([ctypes.c_void_p] * 6
                                                + [ctypes.c_int] * 7)
    lib.rehearse_poly_lat_sweep_parent.restype = None
    lib.rehearse_poly_lat_sweep_parent.argtypes = ([ctypes.c_void_p] * 9
                                                   + [ctypes.c_int] * 7)
    lib.rehearse_action_min_parent.restype = None
    lib.rehearse_action_min_parent.argtypes = ([ctypes.c_void_p] * 6
                                               + [ctypes.c_int] * 4)
    lib.rehearse_backward_slice_parent.restype = None
    lib.rehearse_backward_slice_parent.argtypes = ([ctypes.c_void_p] * 7
                                                   + [ctypes.c_int] * 6)
    lib.rehearse_poly_lat_sweep.restype = ctypes.c_int
    lib.rehearse_poly_lat_sweep.argtypes = ([ctypes.c_void_p] * 13
                                            + [ctypes.c_int] * 7)
    lib.poly_lat_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.poly_lat_sweep_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.poly_lat_max_candidates.restype = ctypes.c_int
    lib.poly_lat_max_candidates.argtypes = []
    lib.rehearse_poly_lat_select.restype = None
    lib.rehearse_poly_lat_select.argtypes = ([ctypes.c_void_p] * 5
                                             + [ctypes.c_int] * 2)
    lib.rehearse_poly_lat_sweep_92bf3da.restype = None
    lib.rehearse_poly_lat_sweep_92bf3da.argtypes = ([ctypes.c_void_p] * 11
                                                    + [ctypes.c_int] * 7)
    lib.rehearse_poly_lat_select_92bf3da.restype = None
    lib.rehearse_poly_lat_select_92bf3da.argtypes = ([ctypes.c_void_p] * 5
                                                     + [ctypes.c_int] * 2)
    lib.rehearse_lon_backward_92bf3da.restype = None
    lib.rehearse_lon_backward_92bf3da.argtypes = ([ctypes.c_void_p] * 5
                                                  + [ctypes.c_int] * 8)
    lib.rehearse_lon_forward_92bf3da.restype = None
    lib.rehearse_lon_forward_92bf3da.argtypes = ([ctypes.c_void_p] * 6
                                                 + [ctypes.c_int] * 7)
    lib.rehearse_action_min_92bf3da.restype = None
    lib.rehearse_action_min_92bf3da.argtypes = ([ctypes.c_void_p] * 6
                                                + [ctypes.c_int] * 4)
    lib.rehearse_backward_slice_92bf3da.restype = None
    lib.rehearse_backward_slice_92bf3da.argtypes = ([ctypes.c_void_p] * 7
                                                    + [ctypes.c_int] * 6)
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
    lib.rehearse_poly_sampling.argtypes = ([ctypes.c_void_p] * 18
                                           + [ctypes.c_int] * 5)
    lib.rehearse_poly_sampling_two_kernel.restype = None
    lib.rehearse_poly_sampling_two_kernel.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5)
    lib.poly_sampling_smem_bytes.restype = ctypes.c_size_t
    lib.poly_sampling_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.rehearse_action_min.restype = None
    lib.rehearse_action_min.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 4)
    lib.rehearse_backward_slice.restype = None
    lib.rehearse_backward_slice.argtypes = ([ctypes.c_void_p] * 7
                                            + [ctypes.c_int] * 6)
    lib.rehearse_backward_slice_batch.restype = None
    lib.rehearse_backward_slice_batch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_longlong, ctypes.c_void_p])
    lib.rehearse_backward_slice_persistent.restype = None
    lib.rehearse_backward_slice_persistent.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.rehearse_dir_dist.restype = None
    lib.rehearse_dir_dist.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_float] * 5
                                      + [ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 5)
    lib.dir_dist_smem_bytes.restype = ctypes.c_size_t
    lib.dir_dist_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.rehearse_poly_eval.restype = None
    lib.rehearse_poly_eval.argtypes = ([ctypes.c_void_p] * 9
                                       + [ctypes.c_int] * 8)
    lib.rehearse_poly_propagate.restype = None
    lib.rehearse_poly_propagate.argtypes = ([ctypes.c_void_p] * 9
                                            + [ctypes.c_int])
    lib.poly_propagate_blocks.restype = ctypes.c_int
    lib.poly_propagate_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
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
    bodies.rehearse_mpc_time(_ptr(host), _ptr(out), None, *args)
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


@pytest.mark.parametrize("kind", scenes.MPC_TIME_KINDS)
def test_mpc_time_profiling_body_is_bit_equal(bodies, kind):
    """The time-indexed MPC's profiling instantiation returns the bits of
    the plain instantiation and a count for every phase."""
    host, args = scenes.mpc_time_case(kind)
    n = ilqr.layout(itt.output_layout(args[0]))[1]
    out, prof_out = np.zeros(n), np.zeros(n)
    prof = np.zeros(len(ilqr.PHASES), np.int64)
    bodies.rehearse_mpc_time(_ptr(host), _ptr(out), None, *args)
    bodies.rehearse_mpc_time(_ptr(host), _ptr(prof_out), _ptr(prof), *args)
    assert np.array_equal(out, prof_out)
    assert np.all(prof > 0)


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


def generic_spec(name):
    """A problem of the harness's generic bodies: a native one by its name,
    or the genopt MPC's printed struct (id 100)."""
    import dataclasses
    from tpl_tpu_torch.optim import genopt, ilqr_generic as ig

    if name == "genopt_mpc":
        spec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
        return dataclasses.replace(spec, id=100)
    return ig.NATIVE[name]


def generic_launch(bodies, spec, shared, rows, H, n_ref, T, it, integ,
                   lg=1, f64=True, limit=None, slots=0, grid=0, order=None,
                   prof=None):
    """The generic body on the harness's grid: the block geometry (slots
    == 0, B blocks, ``limit`` bytes of shared memory a block) or the
    resident one (``grid`` blocks of ``slots`` warps, ``limit`` bytes a
    slot); the ``(B, n_out)`` results."""
    from tpl_tpu_torch.optim import ilqr_generic as ig

    dtype = np.float64 if f64 else np.float32
    limit = ig.SMEM_LIMIT if limit is None else limit
    shared = np.ascontiguousarray(shared, dtype)
    rows = np.ascontiguousarray(np.atleast_2d(rows), dtype)
    B = rows.shape[0]
    words = lambda which: bodies.rehearse_generic_words(
        spec.id, int(f64), H, n_ref, limit, slots, which)
    assert words(0) * dtype().itemsize <= 262144
    ws = np.full(max((grid * slots if slots else B) * words(1), 1), np.nan,
                 dtype)
    out = np.zeros((B, ig._size(ig.output_layout(spec, H))), dtype)
    o = None if order is None else np.ascontiguousarray(order, np.int32)
    bodies.rehearse_generic(
        spec.id, int(f64), integ, _ptr(shared), _ptr(rows), _ptr(out),
        _ptr(ws), None if prof is None else _ptr(prof), B, H, n_ref, T, it,
        lg, limit, slots, grid, None if o is None else _ptr(o))
    return out


@pytest.mark.parametrize("name,integ", [
    ("ref_line_smoother_k", ilqr.EULER), ("ref_line_smoother_dk", ilqr.HEUN),
    ("velocity_profile_time", ilqr.RK4), ("genopt_mpc", ilqr.HEUN)])
def test_generic_native_body_in_double_matches_plain(bodies, name, integ):
    """The generic AL-iLQR body (csrc/ilqr_generic.cu) on the native
    problems without a kernel of their own, H = 250, and on the struct the
    sympy front end prints for the genopt MPC, H = 60, against the plain
    float64 make_update_fn (the cases of tests/test_torch_ilqr_generic.py,
    which also runs them at H = 300, warm, and against JAX)."""
    import test_torch_ilqr_generic as tig
    from tpl_tpu_torch.optim import ilqr_generic as ig

    spec = generic_spec(name)
    if name == "genopt_mpc":
        H, n_ref, it = MPC_H, 128, 8
        inputs, params, mu = scenes.genopt_mpc_case(False, 3, H)
    else:
        H, n_ref = RSTP_H, tig.N_REF
        _, inputs, params, mu, it = tig.native_case(name, H, H, False,
                                                    seed=4)
    host = ig.pack_inputs(spec, inputs, params, mu)
    n_sh = ig._size(ig.shared_layout(spec, H, n_ref))
    out = generic_launch(bodies, spec, host[:n_sh], host[n_sh:], H, n_ref, H,
                         it, integ)
    tig.assert_matches(ig.unpack_outputs(spec, out[0], H),
                       tig.plain(spec, host, H, n_ref, H, it, 1, integ), it)


def generic_batch(name, B, seed, dtype=torch.float64, H=None):
    """(spec, H, n_ref, it, integ, shared, rows, plain) of a seeded batch of
    a harness problem; ``plain()`` is the plain batched update's result,
    the batch last."""
    from tpl_tpu_torch.optim import ilqr_generic as ig

    rng = np.random.default_rng(seed)
    spec = generic_spec(name)
    if name == "genopt_mpc":
        H, n_ref, it, integ = H or 40, 128, 4, ilqr.HEUN
        inputs, params, _ = scenes.genopt_mpc_case(False, 1, H)
        spread = np.array([1, 1, 0.2, 0.1, 3, 0, 0.5])
    else:
        H, n_ref, integ = H or 60, 512, ilqr.RK4
        inputs, params, _, it = scenes.generic_native_case(name, H, H, False,
                                                           2, n_ref)
        spread = np.full(spec.nx, 0.3) * (0.01 if spec.nx == 4 else 1.0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype)
    tp = {k: t(v) for k, v in params.items()
          if k in spec.scalars + spec.tables}
    cfg = dict(u_min=t(inputs["u_lims"][..., 0]),
               u_max=t(inputs["u_lims"][..., 1]),
               barrier_weight=t(inputs["bw_lim"][:, 0]),
               lg_mult_limit=t(inputs["bw_lim"][:, 1]),
               dt=t(inputs["cfg_f"][0]),
               min_rel_cost_change=t(inputs["cfg_f"][1]), T=H,
               max_iterations=it, max_lg_iterations=1)
    x = torch.zeros((H + 1, spec.nx, B), dtype=dtype)
    u = t(rng.normal(0.0, 0.02, (H, spec.nu, B)) * (spec.nx != 4))
    lam = torch.zeros((H, spec.ncl, B), dtype=dtype)
    mu = torch.as_tensor(rng.integers(0, 3, B), dtype=torch.int32)
    x0 = t(inputs["x"][0][:, None]
           + rng.normal(0.0, 1.0, (spec.nx, B)) * spread[:, None])
    shared, rows = ig.pack_inputs_batched(spec, x, u, lam, mu, x0, tp, cfg,
                                          dtype)

    def plain():
        upd = batched.make_batched_update_fn(spec.problem, H, B, integ, dtype)
        return upd.reference(x, u, lam, mu, x0, tp, cfg, iterations=True)

    return (spec, H, n_ref, it, integ, shared.numpy(), rows.numpy(), plain)


def assert_rows_are_single_launches(bodies, spec, shared, rows, out, H,
                                    n_ref, it, integ, f64=True):
    """Every row of a batch's result bit-equal to its own single launch
    (the block geometry at the default shared memory)."""
    for b in range(rows.shape[0]):
        one = generic_launch(bodies, spec, shared, rows[b], H, n_ref, H, it,
                             integ, f64=f64)
        assert np.array_equal(out[b], one[0]), b


@pytest.mark.parametrize("name", ["genopt_mpc", "ref_line_smoother_k"])
def test_generic_resident_batch_matches_single_launches(bodies, name):
    """The resident-warp geometry of the generic body at B = 5 on 2 blocks
    of 2 warps (4 slots, so one warp walks two scenarios), the blocks in
    reversed order: every row bit-equal to its single launch of the block
    geometry, twice: with a slot's arrays in shared memory, and at a slot
    limit that puts most of them (the derivative blocks, staged for the
    backward pass with cp.async's stand-in, among them) in the workspace;
    the profiling instantiation bit-equal, its cycles counted; the batch
    within 1e-12 of the plain batched update."""
    from tpl_tpu_torch.optim import ilqr_generic as ig

    spec, H, n_ref, it, integ, shared, rows, plain = generic_batch(name, 5,
                                                                   11)
    small = 24 * 1024 if name == "genopt_mpc" else 6 * 1024
    words = lambda which: bodies.rehearse_generic_words(
        spec.id, 1, H, n_ref, small, 2, which)
    assert words(1) > 0 and words(3) == (name == "genopt_mpc")
    outs = [generic_launch(bodies, spec, shared, rows, H, n_ref, H, it,
                           integ, limit=limit, slots=2, grid=2,
                           order=[1, 0])
            for limit in (64 * 1024, small)]
    assert np.array_equal(outs[0], outs[1])
    assert_rows_are_single_launches(bodies, spec, shared, rows, outs[0], H,
                                    n_ref, it, integ)
    prof = np.zeros(len(ilqr.PHASES), np.int64)
    p = generic_launch(bodies, spec, shared, rows, H, n_ref, H, it, integ,
                       limit=small, slots=2, grid=2, prof=prof)
    assert np.array_equal(p, outs[0])
    assert np.all(prof[[ilqr.PHASES.index(k) for k in
                        ("derivatives", "riccati")]] > 0)
    got = ig.unpack_outputs_batched(spec, torch.from_numpy(outs[0]), H)
    want = plain()
    for g, w, what in zip(got, want, ("x", "u", "lam", "mu", "cost", "it")):
        if what in ("mu", "it"):
            assert np.array_equal(g.numpy(), w.numpy()), what
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=what)


def test_generic_team_geometry_at_b2(bodies):
    """The block geometry of the generic body at B = 2 (a block a scenario,
    the blocks in reversed order): each row bit-equal to its single
    launch."""
    spec, H, n_ref, it, integ, shared, rows, _ = generic_batch("genopt_mpc",
                                                               2, 5)
    out = generic_launch(bodies, spec, shared, rows, H, n_ref, H, it, integ,
                         order=[1, 0])
    assert_rows_are_single_launches(bodies, spec, shared, rows, out, H,
                                    n_ref, it, integ)


def test_generic_float32_body(bodies):
    """The float32 instantiation (ref_line_smoother_dk, its Riccati pass on
    the lanes): a single solve against the plain float32 update (x within
    chip_smoke's RSTP_X_ATOL, 2e-2, the cost within its RSTP_COST_RTOL,
    1e-5), and the resident geometry at B = 5 on one block of 4 warps (4
    candidates a line-search round) at a slot limit that stages the
    derivative blocks, every row bit-equal to its single launch."""
    from tpl_tpu_torch.optim import ilqr_generic as ig

    spec, H, n_ref, it, integ, shared, rows, plain = generic_batch(
        "ref_line_smoother_dk", 5, 3, torch.float32)
    limit = 7 * 1024
    assert bodies.rehearse_generic_words(spec.id, 0, H, n_ref, limit, 4, 3)
    out = generic_launch(bodies, spec, shared, rows, H, n_ref, H, it, integ,
                         f64=False, limit=limit, slots=4, grid=1)
    assert_rows_are_single_launches(bodies, spec, shared, rows, out, H,
                                    n_ref, it, integ, f64=False)
    host = np.concatenate([shared, rows[0]])
    want = ig.unpack_outputs(spec, ig.update_reference(
        spec, torch.from_numpy(host), H, n_ref, H, it, 1, integ).numpy()
        .astype(np.float64), H)
    got = ig.unpack_outputs(spec, out[0].astype(np.float64), H)
    assert np.all(np.isfinite(got["x"]))
    assert float(np.max(np.abs(got["x"] - want["x"]))) <= 2e-2
    assert abs(got["traj_costs"] - want["traj_costs"]) <= 1e-5 * abs(
        want["traj_costs"])


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


def test_optimizers_horizon_fits_the_kernels(bodies):
    """Each ``optimizers`` factory holds the JAX package's horizon of 300
    on every device, and the solve a factory's solver takes fits its
    kernel: the tracking MPCs' own float64 kernels hold at most 110 and 132
    steps in the 227 KB a block can use at the default 128 reference
    samples (``solver.own_kernel_fits``, whose carve words are held here to
    the sources' at several reference capacities), so at 300 they take the
    generic kernel; the RSTP solves in double, an upper bound of their
    float32 instantiation's, fit at 300."""
    from tpl_tpu_torch.optim import optimizers, solver

    limit = 227 * 1024
    opts = {n: getattr(optimizers, n) for n in (
        "trajectory_tracking_mpc", "trajectory_tracking_mpc_time",
        "lateral_profile", "velocity_profile_space")}
    assert all(b(device="cpu").horizon_max == optimizers.HORIZON_MAX == 300
               for b in opts.values())
    cap = lambda n: opts[n].param_spec[
        "k_ref" if n == "lateral_profile" else "ref_v"].capacity
    mpc = lambda h, n=cap("trajectory_tracking_mpc"): (
        bodies.ilqr_tracking_mpc_smem_bytes(h, n, 0))
    mpc_time = lambda h, n=cap("trajectory_tracking_mpc_time"): (
        bodies.ilqr_tracking_mpc_time_smem_bytes(h, n))
    assert mpc(110) <= limit < mpc(111)
    assert mpc_time(132) <= limit < mpc_time(133)
    for name, fn in (("trajectory_tracking_mpc", mpc),
                     ("trajectory_tracking_mpc_time", mpc_time)):
        for h in (1, 60, 110, 132, 133, 300):
            for n in (16, 128, 256):
                a, b_, c = solver.OWN_KERNEL_WORDS[name]
                assert 8 * (a + b_ * h + c * n) == fn(h, n), (name, h, n)
                assert solver.own_kernel_fits(name, h, n) == (fn(h, n)
                                                              <= limit)
        assert opts[name](device="cpu").route == "ilqr_generic"
    for name in ("lateral_profile", "velocity_profile_space"):
        pid = ilqr_rstp.PROBLEMS[name]["id"]
        assert bodies.rehearse_rstp_smem(pid, 300, cap(name)) <= limit


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


def _am_nan_case(channel):
    """``action_min_case(37, 5, 3)`` with the next slice's row s = 18 NaN
    (every channel, or the cost alone)."""
    args, tables = action_min_case(37, 5, 3, 37)
    _poison(args[0].numpy()[18], channel)
    return args, tables


def _nan_free_cells(constr_o, cost_o):
    return ~(torch.isnan(constr_o) | torch.isnan(cost_o)).any(-1).numpy()


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_action_min_body_nan_rule(bodies, channel):
    """The action-min with a NaN row in the next slice: the plain version's
    cells bit for bit, NaN equal to NaN (a NaN constraint: action 0 with
    its own cost and constraint; a NaN cost among the least constraint:
    the first one); 2dd76fb's body differs there and agrees on every cell
    whose 49 actions hold no NaN."""
    args, tables = _am_nan_case(channel)
    S, DS, L = args[0].shape[:3]
    ts_rows = bodies.latlon_action_min_tile_rows(L)
    want, constr_o, cost_o = lam.action_min_reference(*args, tables,
                                                      return_actions=True)
    want = want.numpy()
    outs = {}
    for name, fn in (("new", bodies.rehearse_action_min),
                     ("old", bodies.rehearse_action_min_parent)):
        out = outs[name] = np.full((S, DS, L, 4), -7.0, np.float32)
        fn(*[_ptr(a.numpy()) for a in args], _table_ptrs(tables), _ptr(out),
           S, DS, L, ts_rows)
    np.testing.assert_array_equal(outs["new"], want)
    keep = _nan_free_cells(constr_o, cost_o)
    assert keep.any() and not keep.all()
    np.testing.assert_array_equal(outs["old"][keep], want[keep])
    assert not np.array_equal(outs["old"], want)


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_backward_slice_body_nan_rule(bodies, channel):
    """The fused slice on a seeded scene's slice T - 2 with the next
    slice's row S // 2 NaN: as the action-min above.  (At 37 x 5 x 3 the
    first action is every touched cell's least, so 61 x 9 x 11.)"""
    S, DS, L, T = 61, 9, 11, 6
    solve, dist_x, rl, step, pp = slice_case(S, DS, L, T, S + T)
    tables = solve.action_tables(pp)
    ts_rows = bodies.latlon_action_min_tile_rows(L)
    nxt = solve.final_slice(dist_x, rl, step, pp).clone()
    _poison(nxt[S // 2].numpy(), channel)
    i = T - 2
    want = solve.backward_slice_reference(nxt, i, dist_x, rl, step, pp,
                                          tables).numpy()
    ins = solve.slice_inputs(i, dist_x, rl, step, pp)
    _, constr_o, cost_o = lam.action_min_reference(nxt, *ins, tables,
                                                   return_actions=True)
    outs = {}
    for name, fn in (("new", bodies.rehearse_backward_slice),
                     ("old", bodies.rehearse_backward_slice_parent)):
        out = outs[name] = np.full((S, DS, L, 4), -7.0, np.float32)
        fn(_ptr(nxt.numpy()), _ptr(dist_x[i].numpy()), _ptr(rl.numpy()),
           _ptr(step.reshape(1).numpy()), _ptr(tables.slice_consts.numpy()),
           _table_ptrs(tables), _ptr(out), S, DS, L, rl.shape[0], i, ts_rows)
    np.testing.assert_array_equal(outs["new"], want)
    keep = _nan_free_cells(constr_o, cost_o)
    assert keep.any() and not keep.all()
    np.testing.assert_array_equal(outs["old"][keep], want[keep])
    assert not np.array_equal(outs["old"], want)


@pytest.mark.parametrize("B,S,DS,L,T", [(1, 37, 5, 3, 4), (3, 61, 9, 11, 4),
                                       (4, 37, 5, 3, 5)])
def test_backward_slice_batch_body_matches_single_and_plain(bodies, B, S, DS,
                                                            L, T):
    """The fused slice over a batch of B scenarios, a block a work item
    (``scenes.dp_batch_scenes``: each its own leader, parked car, lane
    bounds and ``l_trg``, one with NaN distance cells), the blocks in a
    seeded order, every backward slice chained through the plain version:
    each scenario bit-equal to its own one-scenario run and to the plain
    version (``backward_slice_batch_reference``), NaN equal to NaN."""
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=T, s_steps=S, ds_steps=DS, l_steps=L), "cpu")
    dist, rl, pp, _ = scenes.dp_batch_scenes(B, T, S, L, seed=S + B)
    dist_x, rls, step, pps = solve.batch_inputs(dist, rl, 0.5, pp)
    tables = lam.BatchTables([solve.action_tables(pp) for pp in pps])
    assert len({float(pp["l_trg"]) for pp in pps}) == B
    ts_rows = bodies.latlon_action_min_tile_rows(L)
    blocks = -(-S // ts_rows) * DS * B
    rng = np.random.default_rng(B)
    nxt = torch.stack([solve.final_slice(dist_x[b], rls[b], step, pps[b])
                       for b in range(B)])
    n_nan = 0
    for i in range(T - 2, 0, -1):
        want = solve.backward_slice_batch_reference(nxt, i, dist_x, rls,
                                                    step, pps, tables).numpy()
        order = rng.permutation(blocks).astype(np.int32)
        out = np.full((B, S, DS, L, 4), -7.0, np.float32)
        bodies.rehearse_backward_slice_batch(
            _ptr(nxt.numpy()), _ptr(dist_x[:, i].numpy()), _ptr(rls.numpy()),
            _ptr(step.reshape(1).numpy()), _ptr(tables.slice_consts.numpy()),
            _table_ptrs(tables), _ptr(out), S, DS, L, rls.shape[1], i,
            ts_rows, B, T * S * L, _ptr(order))
        np.testing.assert_array_equal(out, want, err_msg=f"slice {i}")
        for b in range(B):
            single = np.full((S, DS, L, 4), -7.0, np.float32)
            tb = tables.tables[b]
            bodies.rehearse_backward_slice(
                _ptr(nxt[b].numpy()), _ptr(dist_x[b, i].numpy()),
                _ptr(rls[b].numpy()), _ptr(step.reshape(1).numpy()),
                _ptr(tb.slice_consts.numpy()), _table_ptrs(tb), _ptr(single),
                S, DS, L, rls.shape[1], i, ts_rows)
            assert np.array_equal(single, out[b], equal_nan=True), (i, b)
        n_nan += int(np.isnan(want).any(-1).sum())
        nxt = torch.from_numpy(want)
    # the NaN distance cells reach the nodes
    assert n_nan > 0


@pytest.mark.parametrize("B,S,DS,L,T,blocks", [
    (2, 37, 5, 3, 4, 3), (3, 61, 9, 11, 4, 7), (3, 61, 9, 11, 4, 2),
    (5, 37, 5, 3, 5, 4), (5, 37, 5, 3, 5, 11), (2, 13, 3, 37, 4, 5)])
def test_backward_slice_batch_persistent_matches_single_and_plain(
        bodies, B, S, DS, L, T, blocks):
    """The batched slice on fewer blocks than work items (each block walks
    items w = block, + blocks, ..., its next item's copies staged while it
    computes one; item counts that the blocks do not divide, S not a
    multiple of the tile, two block counts at B = 3 and 5; L = 37, past the
    32 lateral cells of the searches' ballot masks, with a tile of fewer s
    rows than dl actions), the blocks in a
    seeded order, on ``scenes.dp_batch_scenes`` (one scenario with NaN
    distance cells), every backward slice chained through the plain
    version: each scenario bit-equal to its own one-scenario body and to
    ``backward_slice_batch_reference``, NaN equal to NaN; the profiling
    instantiation bit-equal, its clock counts in every phase."""
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=T, s_steps=S, ds_steps=DS, l_steps=L), "cpu")
    dist, rl, pp, _ = scenes.dp_batch_scenes(B, T, S, L, seed=S + B + blocks)
    dist_x, rls, step, pps = solve.batch_inputs(dist, rl, 0.5, pp)
    tables = lam.BatchTables([solve.action_tables(pp) for pp in pps])
    ts_rows = bodies.latlon_action_min_tile_rows(L)
    items = -(-S // ts_rows) * DS * B
    assert S % ts_rows and items % blocks and items > blocks
    rng = np.random.default_rng(blocks)
    nxt = torch.stack([solve.final_slice(dist_x[b], rls[b], step, pps[b])
                       for b in range(B)])
    n_nan = 0
    for i in range(T - 2, 0, -1):
        want = solve.backward_slice_batch_reference(nxt, i, dist_x, rls,
                                                    step, pps, tables).numpy()
        args = (_ptr(nxt.numpy()), _ptr(dist_x[:, i].numpy()),
                _ptr(rls.numpy()), _ptr(step.reshape(1).numpy()),
                _ptr(tables.slice_consts.numpy()), _table_ptrs(tables))
        outs = []
        for prof in (None, np.zeros(len(lam.SLICE_PHASES), np.uint64)):
            out = np.full((B, S, DS, L, 4), -7.0, np.float32)
            order = rng.permutation(blocks).astype(np.int32)
            bodies.rehearse_backward_slice_persistent(
                *args, _ptr(out), S, DS, L, rls.shape[1], i, ts_rows, B,
                T * S * L, blocks, _ptr(order),
                None if prof is None else _ptr(prof))
            outs.append(out)
        np.testing.assert_array_equal(outs[0], want, err_msg=f"slice {i}")
        assert np.array_equal(outs[1], outs[0], equal_nan=True), i
        assert (prof > 0).all(), prof
        for b in range(B):
            single = np.full((S, DS, L, 4), -7.0, np.float32)
            tb = tables.tables[b]
            bodies.rehearse_backward_slice(
                _ptr(nxt[b].numpy()), _ptr(dist_x[b, i].numpy()),
                _ptr(rls[b].numpy()), _ptr(step.reshape(1).numpy()),
                _ptr(tb.slice_consts.numpy()), _table_ptrs(tb), _ptr(single),
                S, DS, L, rls.shape[1], i, ts_rows)
            assert np.array_equal(single, outs[0][b], equal_nan=True), (i, b)
        n_nan += int(np.isnan(want).any(-1).sum())
        nxt = torch.from_numpy(want)
    # the NaN distance cells reach the nodes
    assert n_nan > 0


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
    tile, cap = tlk.backward_plan(pp, S, V, A, P)
    for i in range(T - 1, 0, -1):
        nxt = nodes[min(i + 1, T - 1)].numpy()
        out = np.full((S, V, A, 4), -7.0, np.float32)
        bodies.rehearse_lon_backward(_ptr(nxt), _ptr(pp), _ptr(path),
                                     _ptr(dist), _ptr(out), S, V, A, P, i,
                                     int(i == T - 1), tile, cap)
        np.testing.assert_array_equal(out, nodes[i].numpy(),
                                      err_msg=f"slice {i}")
    # the constraint channel is in play: some nodes are infeasible
    assert (nodes[1:T - 1, ..., 1] > 0).any()

    args = (torch.from_numpy(pp), torch.from_numpy(path),
            torch.from_numpy(dist))
    # the scene's start, and a replan's (a previous plan's cost and
    # constraint at its head, which the last row must not take over)
    for start in (lon_shifted_start(x0), x0):
        want = tlk.forward_reference(nodes, *args,
                                     torch.from_numpy(start)).numpy()
        out = np.full((T, 7), -7.0, np.float32)
        bodies.rehearse_lon_forward(_ptr(nodes.numpy()), _ptr(pp),
                                    _ptr(path), _ptr(dist), _ptr(start),
                                    _ptr(out), T, S, V, A, P, T, 0)
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


@pytest.mark.parametrize("S,V,A,P,T", [(41, 13, 7, 90, 5), (23, 7, 20, 40, 4)])
def test_lon_forward_body_matches_2dd76fb(bodies, S, V, A, P, T):
    """The redesigned forward pass (the path and the distance map staged,
    the minimum by warp shuffles, the next state on every lane) and its
    reeval pass against 2dd76fb's body, bit for bit, at A = 7 and 20 (the
    lattice and FAS loops' widths), with more reeval rows than slices; its
    profiling instantiation bit-equal, every phase counted; the staging
    fits a block at the demo grid.  The forward pass also from a
    replan's start (the previous plan's cost and constraint at its head),
    against the parent and the plain version."""
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A + 1)
    nodes = lon_nodes(pp, path, dist, T, S, V, A).numpy()
    shifted = lon_shifted_start(x0)
    want = tlk.forward_reference(
        torch.from_numpy(nodes), torch.from_numpy(pp), torch.from_numpy(path),
        torch.from_numpy(dist), torch.from_numpy(shifted)).numpy()
    assert want[-1, tlk.LC_CONSTR] != shifted[tlk.LC_CONSTR]
    for fn in (bodies.rehearse_lon_forward,
               bodies.rehearse_lon_forward_parent):
        np.testing.assert_array_equal(
            _lon_forward(fn, nodes, pp, path, dist, shifted, 0), want)
    got = _lon_forward(bodies.rehearse_lon_forward, nodes, pp, path,
                       dist, x0, 0)
    old = _lon_forward(bodies.rehearse_lon_forward_parent, nodes, pp,
                       path, dist, x0, 0)
    np.testing.assert_array_equal(got, old)
    traj = got.copy()
    traj[2:, tlk.LC_J] = pp[tlk.LON_PP_KEYS.index("j_min")]
    traj = np.concatenate([traj, traj[-3:]])
    np.testing.assert_array_equal(
        _lon_forward(bodies.rehearse_lon_forward, nodes, pp, path,
                     dist, traj, 1),
        _lon_forward(bodies.rehearse_lon_forward_parent, nodes, pp,
                     path, dist, traj, 1))
    prof = np.zeros(len(tlk.FORWARD_PHASES), np.uint64)
    out = np.full((T, 7), -7.0, np.float32)
    bodies.rehearse_lon_forward_profile(
        _ptr(np.ascontiguousarray(nodes)), _ptr(pp), _ptr(path), _ptr(dist),
        _ptr(x0), _ptr(out), _ptr(prof), T, S, V, A, P)
    np.testing.assert_array_equal(out, got)
    assert (prof > 0).all()
    # the staging the wrapper sizes from the body's formula fits a block at
    # the demo grid
    assert bodies.lon_dp_forward_smem_bytes(10, 201, 200) <= tlk.BLOCK_SMEM


@pytest.mark.parametrize("grid", scenes.LON_EDGE)
def test_lon_backward_body_edge_grids_bit_for_bit(bodies, grid):
    """The staged-box backward body on the edge grids of
    ``scenes.LON_EDGE``: every slice bit for bit against
    ``backward_slice_reference`` at tiles that do not divide S, where the
    fastest v shifts past the last s row and the next v and a clamp at both
    ends of V and A; the host's shared-memory formula is the body's; a box
    one node short of the largest makes a block write NaN, not a wrong
    value."""
    T, S, V, A, P = grid
    pp, path, dist, _ = lon_scene(S, V, A, P, T, 3)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    k, _, _ = tlk.backward_coords(pp, S, V, A)
    p = {key: float(x) for key, x in zip(tlk.LON_PP_KEYS, pp)}
    v = np.linspace(p["v_min"], p["v_max"], V)[:, None, None]
    a = np.linspace(p["a_min"], p["a_max"], A)[None, :, None]
    j = np.linspace(p["j_min"], p["j_max"], tlk.NB)[None, None, :]
    vn = v + a * p["dt"] + 0.5 * j * p["dt"] ** 2
    an = a + j * p["dt"]
    assert k.max() > S // 2
    assert vn.min() < p["v_min"] and vn.max() > p["v_max"]
    assert an.min() < p["a_min"] and an.max() > p["a_max"]

    def run(i, tile, cap):
        out = np.full((S, V, A, 4), -7.0, np.float32)
        bodies.rehearse_lon_backward(
            _ptr(nodes[min(i + 1, T - 1)].numpy()), _ptr(pp), _ptr(path),
            _ptr(dist), _ptr(out), S, V, A, P, i, int(i == T - 1), tile, cap)
        return out

    for tile in (4, 7, S - 1):
        assert S % tile
        cap = tlk.box_floats(pp, S, V, A, tile)
        assert bodies.lon_dp_backward_smem_bytes(A, tile, P, cap) \
            == tlk.backward_smem_bytes(A, tile, P, cap)
        assert bodies.lon_dp_backward_threads(A, tile) \
            == tlk.backward_threads(A, tile)
        for i in range(T - 1, 0, -1):
            np.testing.assert_array_equal(run(i, tile, cap),
                                          nodes[i].numpy(),
                                          err_msg=f"tile {tile} slice {i}")
    out = run(T - 2, 7, tlk.box_floats(pp, S, V, A, 7) - 1)
    short = np.isnan(out).any(axis=-1)
    assert short.any()
    np.testing.assert_array_equal(out[~short], nodes[T - 2].numpy()[~short])


# The NaN rule of the plain versions (``torch.amin`` / ``torch.argmin``, the
# JAX default): a NaN constraint makes the minimum NaN, so that no action
# passes the mask (the node's cost inf, its constraint NaN, the first jerk),
# and among the actions of the least constraint the first NaN cost wins.
# 2dd76fb's bodies (PARENTS) dropped a NaN in both; every node whose result
# holds no NaN is theirs bit for bit.

def _lon_slice(fn, nxt, pp, path, dist, i, last, plan=None):
    S, V, A, _ = nxt.shape
    P = path.shape[0]
    tile, cap = plan or tlk.backward_plan(pp, S, V, A, P)
    out = np.full((S, V, A, 4), -7.0, np.float32)
    fn(_ptr(np.ascontiguousarray(nxt)), _ptr(pp), _ptr(path), _ptr(dist),
       _ptr(out), S, V, A, P, i, int(last), tile, cap)
    return out


def _lon_forward(fn, nodes, pp, path, dist, states, mode):
    T, S, V, A, _ = nodes.shape
    rows = T if mode == 0 else len(states)
    out = np.full((rows, 7), -7.0, np.float32)
    fn(_ptr(np.ascontiguousarray(nodes)), _ptr(pp), _ptr(path), _ptr(dist),
       _ptr(states), _ptr(out), T, S, V, A, path.shape[0], rows, mode)
    return out


def _poison(a, channel):
    """NaN into ``a[..., :]`` (``channel`` "all": every channel) or its
    cost channel alone (``channel`` "cost")."""
    if channel == "all":
        a[...] = np.nan
    else:
        a[..., 0] = np.nan


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_lon_backward_body_nan_rule(bodies, channel):
    """Slice T - 2 of ``lon_scene(41, 13, 5, 90, 5)`` with the next slice's
    row S // 2 NaN (every channel, or the cost alone): the plain version's
    nodes bit for bit, NaN equal to NaN; the NaN reaches the slice after
    it; 2dd76fb's body differs there and agrees on every node without a
    NaN."""
    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, _ = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    nxt = nodes[T - 1].numpy().copy()
    _poison(nxt[S // 2], channel)
    args = tuple(torch.from_numpy(x) for x in (pp, path, dist))
    want = tlk.backward_slice_reference(torch.from_numpy(nxt), *args, T - 2,
                                        False).numpy()
    got = _lon_slice(bodies.rehearse_lon_backward, nxt, pp, path,
                     dist, T - 2, False)
    np.testing.assert_array_equal(got, want)
    hit = np.isnan(want).any(axis=-1)
    assert hit.any() and not hit.all()
    if channel == "all":
        assert np.isinf(want[..., 0][hit]).all()
        assert np.isnan(want[..., 1][hit]).all()
        assert (want[..., 2][hit] == pp[tlk.LON_PP_KEYS.index("j_min")]).all()
    else:
        assert np.isnan(want[..., 0][hit]).all()
        assert not np.isnan(want[..., 1]).any()
    old = _lon_slice(bodies.rehearse_lon_backward_parent, nxt, pp,
                     path, dist, T - 2, False)
    np.testing.assert_array_equal(old[~hit], want[~hit])
    assert not np.array_equal(old, want)
    # the slice after it takes the NaN nodes as the plain version does
    want2 = tlk.backward_slice_reference(torch.from_numpy(want), *args,
                                         T - 3, False).numpy()
    got2 = _lon_slice(bodies.rehearse_lon_backward, want, pp, path,
                      dist, T - 3, False)
    np.testing.assert_array_equal(got2, want2)
    assert np.isnan(want2).any()


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_lon_forward_body_nan_rule(bodies, channel):
    """The forward pass over nodes whose slice 2 holds NaN at a index 1,
    which some of step 1's jerks look up (every channel, or the cost
    alone), and the reeval pass of the clean trajectory over them: the
    plain versions bit for bit, NaN equal to NaN; 2dd76fb's forward body
    takes another jerk at the NaN step and agrees on the row before it.
    (Its reeval pass, one action a row, already followed the rule.)"""
    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A).numpy().copy()
    args = tuple(torch.from_numpy(x) for x in (pp, path, dist))
    clean = tlk.forward_reference(torch.from_numpy(nodes), *args,
                                  torch.from_numpy(x0)).numpy()
    _poison(nodes[2, :, :, 1], channel)
    n_t = torch.from_numpy(nodes)
    want = tlk.forward_reference(n_t, *args, torch.from_numpy(x0)).numpy()
    got = _lon_forward(bodies.rehearse_lon_forward, nodes, pp, path,
                       dist, x0, 0)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(want[1]).any() and not np.isnan(want[0]).any()
    old = _lon_forward(bodies.rehearse_lon_forward_parent, nodes, pp,
                       path, dist, x0, 0)
    np.testing.assert_array_equal(old[:1], want[:1])
    assert not np.array_equal(old[1], want[1])

    traj = np.concatenate([clean, clean[-2:]])
    want_r = tlk.reeval_reference(n_t, *args, torch.from_numpy(traj)).numpy()
    got_r = _lon_forward(bodies.rehearse_lon_forward, nodes, pp,
                         path, dist, traj, 1)
    np.testing.assert_array_equal(got_r, want_r)
    assert np.isnan(want_r).any()


# The sweep and its selection in one launch.  The blocks run in a seeded
# order (the last block to arrive takes the selection: it must not always
# be the last index).


def _order(n, seed):
    return None if seed is None else np.random.default_rng(seed).permutation(
        n).astype(np.int32)


def _sweep(bodies, scene, LD, SD, S, prof=None, seed=None):
    """The tree's one launch: (cd, tc, best, cost)."""
    occ, rl, step, pp, env, start = scene
    cd = np.full((LD, SD), -7.0, np.float32)
    tc = np.full((LD, SD), -7.0, np.float64)
    best = np.full(1, -7, np.int64)
    cost = np.full(1, -7.0, np.float32)
    inv = np.ascontiguousarray(splines._HERMITE_INV[5])
    step_a = np.array([step], np.float32)
    order = _order(LD * SD, seed)
    left = bodies.rehearse_poly_lat_sweep(
        _ptr(occ), _ptr(rl), _ptr(step_a), _ptr(pp), _ptr(env), _ptr(start),
        _ptr(inv), _ptr(cd), _ptr(tc), _ptr(best), _ptr(cost),
        None if prof is None else _ptr(prof),
        None if order is None else _ptr(order), LD, SD, S, *occ.shape,
        len(rl))
    assert left == 0
    return cd, tc, int(best[0]), cost[0]


def _sweep_of(fn, scene, LD, SD, S, select=False):
    """An earlier body's sweep (2dd76fb's: (cd, tc)) or sweep and selection
    (92bf3da's two launches, ``select``: (cd, tc, best, cost))."""
    occ, rl, step, pp, env, start = scene
    cd = np.full((LD, SD), -7.0, np.float32)
    tc = np.full((LD, SD), -7.0, np.float64)
    best = np.full(1, -7, np.int64)
    cost = np.full(1, -7.0, np.float32)
    inv = np.ascontiguousarray(splines._HERMITE_INV[5])
    step_a = np.array([step], np.float32)
    extra = (_ptr(best), _ptr(cost)) if select else ()
    fn(_ptr(occ), _ptr(rl), _ptr(step_a), _ptr(pp), _ptr(env), _ptr(start),
       _ptr(inv), _ptr(cd), _ptr(tc), *extra, LD, SD, S, *occ.shape, len(rl))
    return (cd, tc, int(best[0]), cost[0]) if select else (cd, tc)


def _plain_sweep(scene, LD, SD, S):
    T = torch.from_numpy
    occ, rl, step, pp, env, start = scene
    return plk.sweep_select(T(occ), T(rl), T(np.array([step], np.float32)),
                            T(pp), T(env), T(start), LD, SD, S)


def _check_sweep(got, want):
    """The kernel's (cd, tc, best, cost) against the plain version's: the
    collision distance, the winner and its cost exactly, the cost map to
    rtol 1e-12 (its sums in another order), NaN where the plain one is."""
    cd, tc, best, cost = got
    np.testing.assert_array_equal(cd, want[0].numpy())
    np.testing.assert_array_equal(np.isnan(tc), np.isnan(want[1].numpy()))
    np.testing.assert_allclose(tc, want[1].numpy(), rtol=1e-12, atol=0)
    assert best == int(want[2])
    assert cost == float(want[3])


# A NaN in a value input (``scenes.lon_nan_values``, a NaN DP distance
# cell or lane bound): the terms keep it as the plain versions' torch.clamp
# / torch.minimum do, and no index takes it.  92bf3da's bodies (PARENTS)
# dropped it; every node or cell whose terms do not meet it is theirs bit
# for bit.

@pytest.mark.parametrize("where", scenes.NAN_VALUES)
def test_lon_backward_body_nan_value(bodies, where):
    """Slice T - 2 of ``lon_scene(41, 13, 5, 90, 5)`` from the clean next
    slice with a NaN in the distance map or the path's v_max: the plain
    version's nodes bit for bit (the nodes that meet the NaN: constraint
    NaN, cost inf, the first jerk); 92bf3da's body differs there and agrees
    elsewhere; the final slice too."""
    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, _ = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A).numpy()
    path, dist = scenes.lon_nan_values(path, dist, where)
    args = tuple(torch.from_numpy(x) for x in (pp, path, dist))
    for i, last in ((T - 2, False), (T - 1, True)):
        nxt = nodes[min(i + 1, T - 1)]
        want = tlk.backward_slice_reference(torch.from_numpy(nxt), *args, i,
                                            last).numpy()
        got = _lon_slice(bodies.rehearse_lon_backward, nxt, pp, path, dist,
                         i, last)
        np.testing.assert_array_equal(got, want)
        hit = np.isnan(want).any(axis=-1)
        old = _lon_slice(bodies.rehearse_lon_backward_92bf3da, nxt, pp,
                         path, dist, i, last)
        np.testing.assert_array_equal(old[~hit], want[~hit])
        if where == "dist_path" or not last:
            assert hit.any() and not hit.all()
            assert not np.isnan(old).any()
        if not last:
            assert np.isinf(want[..., 0][hit]).all()
            assert (want[..., 2][hit]
                    == pp[tlk.LON_PP_KEYS.index("j_min")]).all()


@pytest.mark.parametrize("where", scenes.NAN_VALUES)
def test_lon_forward_body_nan_value(bodies, where):
    """The forward pass over clean nodes with a NaN in the distance map or
    the path's v_max, and the reeval pass of the clean trajectory: the
    plain versions bit for bit (the step that meets the NaN: constraint
    NaN, cost inf, the first jerk); 92bf3da's bodies agree on the rows
    before it and differ there."""
    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    args = tuple(torch.from_numpy(x) for x in (pp, path, dist))
    clean = tlk.forward_reference(nodes, *args, torch.from_numpy(x0)).numpy()
    path, dist = scenes.lon_nan_values(path, dist, where)
    args = tuple(torch.from_numpy(x) for x in (pp, path, dist))
    want = tlk.forward_reference(nodes, *args, torch.from_numpy(x0)).numpy()
    n = nodes.numpy()
    got = _lon_forward(bodies.rehearse_lon_forward, n, pp, path, dist, x0, 0)
    np.testing.assert_array_equal(got, want)
    bad = np.isnan(want).any(axis=-1)
    k = int(np.argmax(bad))
    assert bad.any() and k > 0
    old = _lon_forward(bodies.rehearse_lon_forward_92bf3da, n, pp, path,
                       dist, x0, 0)
    np.testing.assert_array_equal(old[:k], want[:k])
    assert not np.isnan(old).any()

    traj = np.concatenate([clean, clean[-2:]])
    want_r = tlk.reeval_reference(nodes, *args, torch.from_numpy(traj)).numpy()
    got_r = _lon_forward(bodies.rehearse_lon_forward, n, pp, path, dist,
                         traj, 1)
    np.testing.assert_array_equal(got_r, want_r)
    bad_r = np.isnan(want_r).any(axis=-1)
    assert bad_r.any() and not bad_r.all()
    old_r = _lon_forward(bodies.rehearse_lon_forward_92bf3da, n, pp, path,
                         dist, traj, 1)
    np.testing.assert_array_equal(old_r[~bad_r], want_r[~bad_r])
    assert not np.isnan(old_r).any()


def _dp_nan_case(where):
    """``slice_case(61, 9, 11, 6)``'s final slice, then its distance map
    with a NaN (two s rows of one l column of slice T - 2) or its reference
    line with NaN lane bounds (``where`` "lane_bounds": dl at rows 40-43,
    dr at 80-81)."""
    S, DS, L, T = 61, 9, 11, 6
    solve, dist_x, rl, step, pp = slice_case(S, DS, L, T, S + T)
    nxt = solve.final_slice(dist_x, rl, step, pp)
    dist_x, rl = dist_x.clone(), rl.clone()
    if where == "distance":
        dist_x[T - 2, 20:22, L // 2 + 1] = np.nan
    else:
        rl[40:44, 5] = np.nan
        rl[80:82, 6] = np.nan
    return solve, nxt, dist_x, rl, step, pp


@pytest.mark.parametrize("where", ["distance", "lane_bounds"])
def test_backward_slice_body_nan_value(bodies, where):
    """The fused slice T - 2 with a NaN in the DP distance map (the forward
    distances' running minimum, the occupancy and safety terms keep it: the
    cells whose lateral sweep meets it take action 0 with its own NaN
    constraint) or in the lane bounds (the state cost keeps it): the plain
    version bit for bit; 92bf3da's body differs and agrees on every cell
    that does not meet the NaN.  The action-min alone on the same slice's
    inputs likewise."""
    solve, nxt, dist_x, rl, step, pp = _dp_nan_case(where)
    T, S, L = dist_x.shape[:3]
    DS = nxt.shape[1]
    tables = solve.action_tables(pp)
    ts_rows = bodies.latlon_action_min_tile_rows(L)
    i = T - 2
    want = solve.backward_slice_reference(nxt, i, dist_x, rl, step, pp,
                                          tables).numpy()
    ins = solve.slice_inputs(i, dist_x, rl, step, pp)
    want_a, constr_o, cost_o = lam.action_min_reference(
        nxt, *ins, tables, return_actions=True)
    want_a = want_a.numpy()
    # the cells whose terms meet the NaN: a NaN state cost or a NaN among
    # their 49 actions (then action 0 wins, NaN or not)
    keep = _nan_free_cells(constr_o, cost_o) & ~np.isnan(want).any(axis=-1)
    assert keep.any() and not keep.all()
    outs = {}
    for name, fn in (("new", bodies.rehearse_backward_slice),
                     ("old", bodies.rehearse_backward_slice_92bf3da)):
        out = outs[name] = np.full((S, DS, L, 4), -7.0, np.float32)
        fn(_ptr(nxt.numpy()), _ptr(dist_x[i].numpy()), _ptr(rl.numpy()),
           _ptr(step.reshape(1).numpy()), _ptr(tables.slice_consts.numpy()),
           _table_ptrs(tables), _ptr(out), S, DS, L, rl.shape[0], i, ts_rows)
    np.testing.assert_array_equal(outs["new"], want)
    np.testing.assert_array_equal(outs["old"][keep], want[keep])
    assert not np.isnan(outs["old"]).any()

    outs = {}
    for name, fn in (("new", bodies.rehearse_action_min),
                     ("old", bodies.rehearse_action_min_92bf3da)):
        out = outs[name] = np.full((S, DS, L, 4), -7.0, np.float32)
        fn(*[_ptr(a.numpy()) for a in (nxt, *ins)], _table_ptrs(tables),
           _ptr(out), S, DS, L, ts_rows)
    np.testing.assert_array_equal(outs["new"], want_a)
    np.testing.assert_array_equal(outs["old"][keep], want_a[keep])
    if where == "distance":
        assert not np.array_equal(outs["old"], want_a)


@pytest.mark.parametrize("LD,SD,S", [(21, 13, 61), (1, 20, 41), (6, 4, 201)])
def test_poly_lat_sweep_body_matches_plain(bodies, LD, SD, S):
    scene = poly_lat_scene(LD, SD, S, LD + SD + S)
    got = _sweep(bodies, scene, LD, SD, S, seed=S)
    _check_sweep(got, _plain_sweep(scene, LD, SD, S))
    # the scene's obstacles and limits reach the outputs
    cd, tc = got[:2]
    assert (cd < 1000.0).any() and (tc >= 1e6).any() or LD == 1


@pytest.mark.parametrize("LD,SD,S", [(21, 13, 61), (1, 20, 41), (6, 4, 201)])
def test_poly_lat_sweep_body_matches_2dd76fb(bodies, LD, SD, S):
    """The redesigned sweep (coefficients once a block, the cost sum and the
    least station as warp reductions, the time sum in order on one thread)
    against 2dd76fb's body: the collision distance bit for bit, the cost to
    rtol 1e-12 (its sum in another order)."""
    scene = poly_lat_scene(LD, SD, S, LD + SD + S)
    cd, tc = _sweep(bodies, scene, LD, SD, S)[:2]
    cd0, tc0 = _sweep_of(bodies.rehearse_poly_lat_sweep_parent, scene,
                         LD, SD, S)
    np.testing.assert_array_equal(cd, cd0)
    np.testing.assert_allclose(tc, tc0, rtol=1e-12, atol=0)


@pytest.mark.parametrize("S", [41, 11])
@pytest.mark.parametrize("LD,SD,seed", [(1, 20, 1), (21, 13, 2), (5, 11, 3)])
def test_poly_lat_sweep_select_body_matches_92bf3da(bodies, LD, SD, S, seed):
    """The one launch, its blocks in a seeded order, against 92bf3da's
    sweep and selection (two launches): cd, tc, the winner and its cost bit
    for bit; and against the plain versions.  At 5 x 11 the candidates
    fill one warp's 32 lanes and part of the next.  At S = 11 the staged
    values of 21 x 13 candidates outgrow the sweep's region (5 S = 55
    candidates), which then takes the staging's size."""
    grows = bodies.poly_lat_sweep_smem_bytes(S, LD * SD) \
        > bodies.poly_lat_sweep_smem_bytes(S, 1)
    assert grows == (LD * SD > 5 * S)
    scene = poly_lat_scene(LD, SD, S, seed)
    got = _sweep(bodies, scene, LD, SD, S, seed=seed)
    old = _sweep_of(bodies.rehearse_poly_lat_sweep_92bf3da, scene, LD, SD, S,
                    select=True)
    for x, y in zip(got, old):
        np.testing.assert_array_equal(x, y)
    _check_sweep(got, _plain_sweep(scene, LD, SD, S))
    assert (got[0] == 1000.0).sum() > 1        # tied collision distances


@pytest.mark.parametrize("LD,SD,S", [(1, 20, 41), (21, 13, 61), (5, 11, 41)])
def test_poly_lat_sweep_body_nan_lane_bounds(bodies, LD, SD, S):
    """NaN lane bounds (``scenes.poly_lat_nan_bounds``): the constraints keep
    them (torch.clamp), so the candidates that reach them cost NaN and the
    selection passes over them; the plain version's cd, NaN pattern,
    winner and cost, where 92bf3da's sweep dropped the NaN (its costs
    finite there); every other candidate bit-equal to 92bf3da's."""
    scene = list(poly_lat_scene(LD, SD, S, LD + SD + S))
    scene[1] = scenes.poly_lat_nan_bounds(scene[1])
    got = _sweep(bodies, scene, LD, SD, S, seed=LD + SD)
    _check_sweep(got, _plain_sweep(scene, LD, SD, S))
    hit = np.isnan(got[1])
    assert hit.any() and not hit.all()
    old = _sweep_of(bodies.rehearse_poly_lat_sweep_92bf3da, scene, LD, SD, S,
                    select=True)
    assert not np.isnan(old[1]).any()
    np.testing.assert_array_equal(got[0], old[0])
    np.testing.assert_array_equal(got[1][~hit], old[1][~hit])


@pytest.mark.parametrize("case", scenes.SELECT_EDGES)
def test_poly_lat_sweep_select_body_edges(bodies, case):
    """The one launch at 5 x 11 x 41, its blocks in a seeded order, with the
    selection driven into an edge through the sweep's inputs
    (``scenes.poly_lat_select_edge``): the plain versions' maps, winner and
    cost; where no NaN is met, 92bf3da's two launches bit for bit."""
    LD, SD, S = 5, 11, 41
    scene = scenes.poly_lat_select_edge(poly_lat_scene(LD, SD, S, 7), SD,
                                        case)
    got = _sweep(bodies, scene, LD, SD, S, seed=11)
    _check_sweep(got, _plain_sweep(scene, LD, SD, S))
    init = min(LD // 2 + 1, LD - 1) * SD + SD - 1
    nan = np.isnan(got[1]).ravel()
    if case == "empty":
        assert (got[0] == 1000.0).all()
    elif case == "infeasible":
        assert (got[1].astype(np.float32) >= 1e6).all()
    elif case == "nan_init":
        assert nan[init] and not nan.all()
    else:
        assert nan.all() and got[2] == init and got[3] == np.inf
    if not nan.any():
        old = _sweep_of(bodies.rehearse_poly_lat_sweep_92bf3da, scene, LD,
                        SD, S, select=True)
        for x, y in zip(got, old):
            np.testing.assert_array_equal(x, y)


def test_poly_lat_sweep_profiling_body_is_bit_equal(bodies):
    """The profiling instantiation: every result the plain instantiation's,
    every phase counted; a block's shared memory at the most samples and
    candidates the launcher takes inside the 48 KB a block has without
    opting in."""
    LD, SD, S = 6, 4, 201
    scene = poly_lat_scene(LD, SD, S, 5)
    want = _sweep(bodies, scene, LD, SD, S, seed=4)
    prof = np.zeros(len(plk.SWEEP_PHASES), np.uint64)
    got = _sweep(bodies, scene, LD, SD, S, prof, seed=4)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert (prof > 0).all()
    assert bodies.poly_lat_sweep_smem_bytes(
        900, bodies.poly_lat_max_candidates()) <= 48 * 1024


def test_poly_lat_sweep_body_nan_occupancy(bodies):
    """A NaN occupancy cell beside each obstacle cell: a sample whose
    lookups meet both is no collision (torch.maximum keeps the NaN, and NaN
    > 0 is false), where 2dd76fb's body dropped the NaN and took the
    obstacle: the plain version bit for bit."""
    LD, SD, S = 6, 4, 61
    scene = list(poly_lat_scene(LD, SD, S, LD + SD + S))
    occ = scene[0].copy()
    occ[np.roll(occ > 0, 1, axis=2) & (occ == 0)] = np.nan
    scene[0] = occ
    got = _sweep(bodies, scene, LD, SD, S)
    _check_sweep(got, _plain_sweep(scene, LD, SD, S))
    cd0, _ = _sweep_of(bodies.rehearse_poly_lat_sweep_parent, scene, LD,
                       SD, S)
    assert not np.array_equal(cd0, got[0])


def _select_maps(LD, SD, rng, case):
    """Candidate maps as tests/test_poly_chain.py draws them; ``case``
    "nan": NaN costs and collision distances among them (also at the first
    update's index), "tie": equal costs and distances a pass must keep the
    first of, "infeasible": every cost past the feasibility limit."""
    cd = rng.uniform(0.0, 60.0, (LD, SD)).astype(np.float32)
    cd[rng.random((LD, SD)) < 0.3] = 1000.0
    tc = rng.uniform(0.0, 100.0, (LD, SD))
    tc[rng.random((LD, SD)) < 0.2] = 1e7
    if case == "nan":
        tc[rng.random((LD, SD)) < 0.2] = np.nan
        cd[rng.random((LD, SD)) < 0.1] = np.nan
        if rng.random() < 0.3:
            cd[min(LD // 2 + 1, LD - 1), SD - 1] = np.nan
    elif case == "tie":
        tc[rng.random((LD, SD)) < 0.4] = 12.5
        cd[rng.random((LD, SD)) < 0.3] = 30.0
    elif case == "infeasible":
        tc[...] = 2e6
    return cd, tc


@pytest.mark.parametrize("grids", [((21, 13), (5, 11)), ((1, 20), (4, 3))],
                         ids=["warps", "one_warp"])
@pytest.mark.parametrize("case", ["random", "nan", "tie", "infeasible"])
def test_poly_lat_select_body_matches_plain(bodies, case, grids):
    """The last block's selection on given maps: the winner and its cost
    as the plain version's and as 92bf3da's one-thread kernel's, at 21 x 13
    and 5 x 11 (the passes over several warps' rounds) and at 1 x 20 and
    4 x 3 (one round)."""
    rng = np.random.default_rng(len(case) + grids[0][0])
    for LD, SD in grids:
        for trial in range(4):
            cd, tc = _select_maps(LD, SD, rng, case)
            lv = np.array([2.0], np.float32)
            outs = []
            for fn, extra in ((bodies.rehearse_poly_lat_select, ()),
                              (bodies.rehearse_poly_lat_select_92bf3da, ())):
                best = np.zeros(1, np.int64)
                cost = np.zeros(1, np.float32)
                fn(_ptr(cd), _ptr(tc), _ptr(lv), _ptr(best), _ptr(cost), LD,
                   SD, *extra)
                outs.append((int(best[0]), cost[0]))
            want_b, want_c = plk.select_reference(
                torch.from_numpy(cd), torch.from_numpy(tc),
                torch.from_numpy(lv), LD, SD)
            assert outs[0] == outs[1], (LD, SD, trial)
            assert outs[0][0] == int(want_b), (LD, SD, trial)
            assert outs[0][1] == float(want_c)


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


def _poly_sampling_case(scene, C=None, nan_at=(), tie=False):
    """The grid's inputs of a scene of ``scenes.poly_scene`` (float32 CPU
    tensors), its first C candidates; ``nan_at``: those candidates' end
    offset NaN (their costs NaN); ``tie``: the last candidate a copy of the
    plain version's winner, or the first where that is the last (an equal
    least cost)."""
    start, path, obs, pp = poly_scene(obstacles=scene == "obstacles",
                                      bench=scene == "bench")
    a = [x.clone() for x in psp.device_inputs(start, path, obs, pp, "cpu")]
    if C is not None:
        for i in (1, 2, 3):
            a[i] = a[i][:C].contiguous()
    if tie:
        b = int(pok.run_reference(*a)[2])
        j = a[1].shape[0] - 1 if b != a[1].shape[0] - 1 else 0
        for i in (1, 2, 3):
            a[i][j] = a[i][b]
    for j in nan_at:
        a[1][j] = float("nan")
    return a


def _rehearse_poly_sampling(bodies, a, seed=0, prof=None, two=False):
    """The one launch (the blocks in a seeded order) or, with ``two``, the
    earlier two-launch body: (rows, costs, packed, cost, best), and the
    counter back at 0 after the one launch."""
    n = [np.ascontiguousarray(x.numpy()) for x in a]
    C, N = a[1].shape[0], a[4].shape[0]
    O, K = a[6].shape[:2]
    inv = np.ascontiguousarray(pok._inverses("cpu").numpy())
    rows = np.zeros((C, 11, N))
    costs = np.zeros(C)
    packed = np.zeros((11, N))
    cost = np.zeros(1)
    best = np.zeros(1, np.int64)
    out = [_ptr(x) for x in (rows, costs, packed, cost, best)]
    if two:
        bodies.rehearse_poly_sampling_two_kernel(
            *[_ptr(x) for x in n], _ptr(inv), *out, C, N, a[5].shape[0], O, K)
    else:
        counter = np.zeros(1, np.int32)
        order = np.random.default_rng(seed).permutation(C).astype(np.int32)
        bodies.rehearse_poly_sampling(
            *[_ptr(x) for x in n], _ptr(inv), *out, _ptr(counter),
            None if prof is None else _ptr(prof), _ptr(order), C, N,
            a[5].shape[0], O, K)
        assert counter[0] == 0
    return rows, costs, packed, cost[0], int(best[0])


def _check_poly_sampling(bodies, a, seed=0):
    """The one launch against the plain version (the winner, its rows to
    1e-9, NaN equal to NaN) and against the two-launch body (every
    candidate's rows and cost bit for bit); returns both results and the
    plain version's winner."""
    want_p, want_c, want_b = pok.run_reference(*a)
    got = _rehearse_poly_sampling(bodies, a, seed)
    two = _rehearse_poly_sampling(bodies, a, two=True)
    rows, costs, packed, cost, best = got
    assert best == int(want_b)
    np.testing.assert_allclose(packed, want_p.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(cost, float(want_c), rtol=1e-12)
    np.testing.assert_array_equal(rows, two[0])
    np.testing.assert_array_equal(costs, two[1])
    np.testing.assert_array_equal(packed, rows[best])
    assert cost == costs[best] or (np.isnan(cost) and np.isnan(costs[best]))
    return got, two, int(want_b)


@pytest.mark.parametrize("scene", ["obstacles", "free", "bench"])
def test_poly_sampling_body_matches_plain(bodies, scene):
    """The grid's one launch at C = 30, the blocks in a seeded order: the
    plain version's winner, its rows to 1e-9 (float64 rows; the coefficient
    solves sum in another order); every candidate's rows and cost bit for
    bit the two-launch body's."""
    a = _poly_sampling_case(scene)
    (_, costs, _, _, _), _, _ = _check_poly_sampling(bodies, a, seed=1)
    if scene != "free":
        assert (costs >= pok.PENALTY).any()


@pytest.mark.parametrize("C", [1, 6])
@pytest.mark.parametrize("scene", ["obstacles", "free", "bench"])
def test_poly_sampling_body_small_grids(bodies, scene, C):
    """The first 1 and 6 candidates of each scene, as at C = 30."""
    _check_poly_sampling(bodies, _poly_sampling_case(scene, C), seed=C)


@pytest.mark.parametrize("case", ["nan", "two_nans", "tie", "nan_and_tie"])
def test_poly_sampling_body_selection_nan_and_tie(bodies, case):
    """A NaN cost at an index > 0 wins (the first NaN, as ``torch.argmin``
    and ``jnp.argmin`` take it), an exact tie of the least cost goes to the
    smaller index, whichever block arrives last.  The two-launch body's
    selection, which kept the strictly smaller cost, misses every NaN case
    (the fault this repairs)."""
    nan_at = {"nan": (17,), "two_nans": (23, 9), "tie": (),
              "nan_and_tie": (21,)}[case]
    a = _poly_sampling_case("obstacles", nan_at=nan_at,
                            tie=case in ("tie", "nan_and_tie"))
    for seed in (0, 1, 2):
        (_, costs, _, _, best), two, want = _check_poly_sampling(
            bodies, a, seed)
    if nan_at:
        assert best == min(nan_at) and np.isnan(costs[best])
        assert np.isnan(costs).sum() == len(nan_at)
        assert two[4] != want and not np.isnan(two[3])
    else:
        least = np.flatnonzero(costs == costs.min())
        assert len(least) == 2 and best == least[0] == two[4]


def test_poly_sampling_profiling_body_is_bit_equal(bodies):
    """The profiling instantiation: every row, cost and the winner the
    plain instantiation's; each block's phases counted, the selection's on
    the last block alone."""
    a = _poly_sampling_case("bench")
    got = _rehearse_poly_sampling(bodies, a, seed=3)
    prof = np.zeros(len(pok.PHASES), np.uint64)
    again = _rehearse_poly_sampling(bodies, a, seed=4, prof=prof)
    for x, y in zip(got, again):
        np.testing.assert_array_equal(x, y)
    assert (prof > 0).all()


def test_poly_sampling_block_memory_within_the_default_limit(bodies):
    """A block's shared memory: the coefficients, the term sums and 16
    float64 values a step, 4 ints, 16 bytes a hull edge; the demo set's and
    the bench's grids well inside the 48 KB the launcher allows."""
    assert bodies.poly_sampling_smem_bytes(25, 8, 4) == (
        8 * (6 + 5 + 7 + 25 * 16) + 4 * 4 + 4 * 8 * 4 * 4)
    assert bodies.poly_sampling_smem_bytes(25, 8, 4) < 48 * 1024


# ---------------------------------------------------------------------
# the graph DP planner's kernels: the directional field cell for cell, the
# edge evaluation's end points bit for bit (the same operations in the same
# order), the propagation's selections and trajectory exactly

def _dir_field(bodies, occ, R, prof=None):
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
        ray.numpy())), *scal, step, _ptr(out),
        None if prof is None else _ptr(prof), T, S, L, D, R)
    return out, want.numpy()


@pytest.mark.parametrize("case,R", [("obstacle", 72), ("random", 72),
                                    ("random", 40)])
def test_dir_dist_body_matches_plain_cell_for_cell(bodies, case, R):
    """On two time slices of 41 stations (a grid of 41 blocks: the host
    threads' barriers are slow when the machine is busy): the test scene's
    stretch around the obstacle and seeded occupancy."""
    tpl_tpu_torch.use_device("cpu")
    occ = (dp_poly_env(True).get_occ_map()[:2, 40:81] if case == "obstacle"
           else dp_random_occ(3, T=2, S=41))
    got, want = _dir_field(bodies, occ, R)
    np.testing.assert_array_equal(got, want)
    # some rays meet nothing, some block at once, some in between
    assert (want == dpe.FREE_DIST).any() and (want == 0.0).any()
    assert ((want > 0.0) & (want < dpe.FREE_DIST)).any()


@pytest.mark.parametrize("T", [1, 10, 40])
@pytest.mark.parametrize("R", [40, 72])
def test_dir_dist_body_one_march_for_all_slices(bodies, T, R):
    """One march a ray for every slice of a group (T = 40: two groups of
    32 and 8) on occupancy that changes over t: cell for cell the plain
    version's field; the profiling instantiation bit-equal, its phases
    counted on every block."""
    occ = dp_moving_occ(T + R, T)
    got, want = _dir_field(bodies, occ, R)
    np.testing.assert_array_equal(got, want)
    if T > 1:   # the slices' fields differ, so a slice's own march matters
        assert not (want == want[:1]).all()
    prof = np.zeros(len(dpe.PHASES), np.uint64)
    again, _ = _dir_field(bodies, occ, R, prof)
    np.testing.assert_array_equal(again, got)
    assert (prof > 0).all()
    # the merged march needs no more samples than one march a slice
    field = torch.from_numpy(want)
    merged = dpe.dir_dist_merged_samples(field, 0.5, R)
    assert merged <= dpe.dir_dist_samples(field, 0.5, R)
    assert merged >= field[0].numel()


def test_dir_dist_block_memory_holds_a_group_and_the_grid(bodies):
    """A block's shared memory: the group's distances (at most 32 slices),
    a mask word a cell and a row a sample of each direction, whatever T."""
    assert bodies.dir_dist_smem_bytes(10, 201, 21, 21, 72) == 4 * (
        10 * 441 + 201 * 21 + 21 * 72 + 2)
    assert bodies.dir_dist_smem_bytes(40, 201, 21, 21, 72) == \
        bodies.dir_dist_smem_bytes(32, 201, 21, 21, 72)


def _rehearse_eval(bodies, start_pts, starts, specs, is_last, ev, dd, rl,
                   n_int, prof=None):
    m4, h5 = ppk.inverses_f32()
    consts = np.concatenate([ev, m4.ravel(), h5.ravel()]).astype(np.float32)
    E = len(starts)
    out = np.zeros((E, 8), np.float32)
    T, S, L, D = dd.shape
    field_slice = np.zeros(T * S * L, np.float32)
    bodies.rehearse_poly_eval(
        _ptr(start_pts), _ptr(starts), _ptr(specs), _ptr(dd), _ptr(rl),
        _ptr(field_slice), _ptr(out), None if prof is None else _ptr(prof),
        _ptr(consts), E, int(is_last), n_int, T, S, L, D, len(rl))
    return out


def _rehearse_propagate(bodies, pts, seg, node_off, seg_off, seed=0,
                        prof=None):
    """The propagation's one launch, its blocks in a seeded order:
    (node_cost, best, traj), and the counter back at 0."""
    K = len(node_off) - 2
    N = node_off[-1]
    offs = np.zeros(2 * ppk.MAX_LEVELS + 3, np.int32)
    offs[:K + 2] = node_off
    offs[ppk.MAX_LEVELS + 2:ppk.MAX_LEVELS + 3 + K] = seg_off
    node_cost = np.zeros(N)
    best = np.zeros(N, np.int32)
    traj = np.zeros((K + 1, 8))
    counter = np.zeros(1, np.int32)
    order = np.random.default_rng(seed).permutation(
        bodies.poly_propagate_blocks(_ptr(offs), K)).astype(np.int32)
    bodies.rehearse_poly_propagate(
        _ptr(np.ascontiguousarray(pts, np.float32)), _ptr(node_cost),
        _ptr(best), _ptr(np.ascontiguousarray(seg, np.int32)), _ptr(traj),
        _ptr(offs), _ptr(counter), None if prof is None else _ptr(prof),
        _ptr(order), K)
    assert counter[0] == 0
    return node_cost, best, traj


@pytest.mark.parametrize("key", [(2, 4), (5, 1), (7, 8)])
def test_poly_planner_bodies_match_plain(bodies, key):
    """Both levels' edge evaluation on the obstacle scene (and its
    profiling instantiation, with the steps it takes), then the
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
        prof = np.zeros(len(ppk.EVAL_PHASES) + len(ppk.EVAL_COUNTS),
                        np.uint64)
        again = _rehearse_eval(bodies, level[k].numpy(), starts.numpy(),
                               specs.numpy(), k == K - 1, ev, dd.numpy(),
                               rl.numpy(), n_int, prof)
        np.testing.assert_array_equal(again, got)
        assert tuple(prof[-2:].tolist()) == ppk.eval_steps_needed(
            level[k], starts, specs, k == K - 1, ev, n_int)
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


@pytest.mark.parametrize("is_last", [True, False])
def test_poly_eval_body_near_the_horizon(bodies, is_last):
    """Edges from start points near the horizon (the loops end at once or
    after a step or two; an edge ends at the horizon, one starts at it,
    some end past it) and the profiling instantiation: bit for bit, its
    step counts those of :func:`ppk.eval_steps_needed`."""
    tpl_tpu_torch.use_device("cpu")
    env = dp_poly_env(True)
    dd = env.update_dir_dist_map()
    p = ppk.DpPolyParams()
    ev = ppk.eval_params(p, env.params, np.float32(env.ref_step))
    pts, starts, specs = dp_poly_near_horizon(p)
    assert (specs[:, 0] == np.float32((p.t_steps - 1) * p.dt)).any()
    n_int = p.n_int_steps()
    rl = env.grid.ref_line
    want = ppk.eval_edges_reference(torch.from_numpy(pts),
                                    torch.from_numpy(starts),
                                    torch.from_numpy(specs), is_last, ev, dd,
                                    rl, n_int)
    got = _rehearse_eval(bodies, pts, starts, specs, is_last, ev, dd.numpy(),
                         rl.numpy(), n_int)
    np.testing.assert_array_equal(got, want.numpy())
    prof = np.zeros(len(ppk.EVAL_PHASES) + len(ppk.EVAL_COUNTS), np.uint64)
    again = _rehearse_eval(bodies, pts, starts, specs, is_last, ev,
                           dd.numpy(), rl.numpy(), n_int, prof)
    np.testing.assert_array_equal(again, got)
    poly, tail = ppk.eval_steps_needed(
        torch.from_numpy(pts), torch.from_numpy(starts),
        torch.from_numpy(specs), is_last, ev, n_int)
    counts = dict(zip(ppk.EVAL_PHASES + ppk.EVAL_COUNTS, prof.tolist()))
    assert (counts["poly_steps"], counts["tail_steps"]) == (poly, tail)
    assert tail > 0 if is_last else tail == 0
    assert counts["fit"] > 0 and counts["lookup"] > 0


def _check_propagate(bodies, node_pts, edge_steps, seed):
    """The one launch against :func:`ppk.propagate_reference`: every
    selection, propagated cost (NaN equal to NaN) and the trajectory;
    returns the plain version's buffers."""
    pts, node_cost, best, seg, node_off, seg_off, traj = dp_poly_buffers(
        node_pts, edge_steps, "cpu")
    ppk.propagate_reference(pts, node_cost, best, seg, node_off, seg_off,
                            traj)
    g_cost, g_best, g_traj = _rehearse_propagate(bodies, pts.numpy(),
                                                 seg.numpy(), node_off,
                                                 seg_off, seed)
    inner = node_off[-2]
    np.testing.assert_array_equal(g_best[:inner], best.numpy()[:inner])
    np.testing.assert_array_equal(g_cost[:inner], node_cost.numpy()[:inner])
    np.testing.assert_array_equal(g_traj, traj.numpy())
    return node_cost.numpy(), node_off


@pytest.mark.parametrize("seed,ties,nan", [(0, True, True), (1, True, False),
                                           (2, False, True)])
def test_poly_propagate_body_matches_plain(bodies, seed, ties, nan):
    """Seeded graphs with equal least costs in a node's range, NaN costs
    and nodes without edges, the blocks in seeded orders: the same
    selections, costs and trajectory."""
    node_pts, edge_steps = dp_poly_propagation_case(seed, ties=ties, nan=nan)
    for order in range(3):
        node_cost, node_off = _check_propagate(bodies, node_pts, edge_steps,
                                               order)
    inner = node_off[-2]
    # the case has what it is for: nodes without edges (+inf) and, with
    # ``nan``, a NaN propagated cost
    assert np.isinf(node_cost[1:inner]).any()
    assert np.isnan(node_cost[:inner]).any() == nan


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("ties,nan", [(True, True), (False, False)])
def test_poly_propagate_body_levels(bodies, levels, ties, nan):
    """K = 1 (the root is the last level: one block, no lower level) and
    K = 3 (the last block takes level 1, 40 nodes a warp each, then the
    root over the block): the plain version's selections, costs and
    trajectory, whichever block arrives last."""
    node_pts, edge_steps = dp_poly_propagation_case(
        5, ties=ties, nan=nan, levels=levels)
    assert len(edge_steps) == levels
    for order in range(3):
        node_cost, node_off = _check_propagate(bodies, node_pts, edge_steps,
                                               order)
    if levels == 3:
        assert np.isinf(node_cost[1:node_off[-2]]).any()
        assert np.isnan(node_cost[:node_off[-2]]).any() == nan


def test_poly_propagate_profiling_body_is_bit_equal(bodies):
    """The profiling instantiation: the same buffers bit for bit, each
    phase counted."""
    node_pts, edge_steps = dp_poly_propagation_case(0, levels=3)
    pts, _, _, seg, node_off, seg_off, _ = dp_poly_buffers(
        node_pts, edge_steps, "cpu")
    got = _rehearse_propagate(bodies, pts.numpy(), seg.numpy(), node_off,
                              seg_off, 1)
    prof = np.zeros(len(ppk.PROP_PHASES), np.uint64)
    again = _rehearse_propagate(bodies, pts.numpy(), seg.numpy(), node_off,
                                seg_off, 2, prof)
    for x, y in zip(got, again):
        np.testing.assert_array_equal(x, y)
    assert (prof > 0).all()

// Backward action-min of the DP lat/lon value iteration, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpl_tpu/planning/dyn_prog/latlon_pallas.py
// (make_action_min, its pl.pallas_call), and computes exactly what the XLA
// formulation tpl_tpu/planning/dyn_prog/lat_lon_kernel.py backward_slice
// computes for the action part: for every grid cell (s, ds, l) it visits the
// 7 x 7 (dds, dl) actions in dl-outer / dds-inner order, looks up the
// next-slice node at the edge-clamped target cell, forms the action's
// (constraint, cost) and keeps the lexicographic minimum.  The first minimum
// wins (the running update takes strictly better actions only), which is the
// XLA two-stage argmin's tie order.  The TPU kernel's padded layout and its
// 127-row shift cap are not carried over: indices clamp to the grid edge.
//
// What bounds it on an H100: the 49 lookups of a cell, not its ~1,050
// operations.  Read straight from device memory they are 49 x 16 B a cell,
// ~120 MB per slice at the demo grid (201 x 37 x 21 = 156,177 cells) through
// L2 and L1 for a next-slice table of 2.5 MB.  But the 49 lookups of a cell
// hit only 7 rows of that table, one per dds action: row (clamp(s + ks[ds,
// j]), ids[ds, j]), L x 16 contiguous bytes; the 7 dl shifts move along l
// inside it.  So a block takes one ds, a run of TS consecutive s and all l,
// stages the 7 x TS target rows in shared memory with asynchronous 16-byte
// copies (cp.async.cg, past L1; 7 loads from device memory per cell instead
// of 49) and reads every lookup from there, the l shift edge-clamped.  All
// 7 x TS rows are resident at once (27.6 KB at TS = 12, L = 21), so the
// actions are visited in the plain order with one running best; the copies
// of one block overlap the arithmetic of the others on its SM.  A block
// reads only its own ds row of the action tables, into registers, and both
// action loops are unrolled, so d_fwd's 7 values stay in registers.
//
// Rounding: the integer shift tables arrive precomputed (round-half-even on
// the host side, matching jnp.round); the kernel itself rounds nothing.
// A NaN of the distance map or of the reference line's lane bounds stays in
// the terms, as jnp.maximum / jnp.minimum and the plain version's
// torch.clamp / torch.cummin keep it (max_nan / min_nan, nan_minmax.cuh);
// the clamps that form an index drop it.
// Build without --use_fast_math and with --fmad=false so every float op
// rounds exactly like the elementwise reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "nan_minmax.cuh"
#include "smem_limit.cuh"

namespace latlon_am {

using nan_minmax::max_nan;
using nan_minmax::min_nan;

constexpr int NB = 7;           // action samples per dimension
constexpr int MAX_ROWS = 24;    // s rows of a block's tile, at most
constexpr int MAX_THREADS = 1024;
constexpr int FEW_THREADS = 256;    // the instantiation with more registers
// blocks of FEW_THREADS an SM holds at least: caps the registers at 80
constexpr int FEW_BLOCKS = 3;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy16_async(float4* dst, const float4* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

// 4 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
#else
  *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
#endif
}

// waits for every asynchronous copy of the calling thread
__device__ __forceinline__ void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
#endif
}

__host__ __device__ inline size_t smem_bytes(int ts, int L) {
  return sizeof(float4) * NB * ts * L + sizeof(float) * NB * NB;
}

// The action tables of one solve (tpl_tpu_torch latlon_action_min.py
// TABLE_KEYS), as device pointers, in the kernels' parameter order.
struct Tables {
  const int *ids, *ks, *kl;
  const float *ca, *schg, *qdds, *qdl, *dds_vals, *dl_vals, *dss, *consts;
};

// Stages what every cell of the block's tile looks up: the 7 target rows
// per s of the tile, one per dds action, as rows (NB, ts_rows, L), and the
// block's ds row of the slope constraints as s_ca (j, m).  The caller waits
// (copies_wait) and synchronises.
__device__ __forceinline__ void stage_lookups(
    float4* rows, float* s_ca, const float4* __restrict__ nodes_next,
    const Tables& tb, int ds, int s0, int S, int DS, int L, int tile) {
  for (int k = threadIdx.x; k < NB * tile; k += blockDim.x) {
    const int j = k / tile;
    const int r = k - j * tile;
    const int st = clampi(s0 + r / L + tb.ks[ds * NB + j], 0, S - 1);
    copy16_async(rows + k, nodes_next
                 + ((size_t)(st * DS + tb.ids[ds * NB + j]) * L + r % L));
  }
  for (int k = threadIdx.x; k < NB * NB; k += blockDim.x)
    s_ca[k] = tb.ca[ds * NB * NB + k];
}

struct Best {
  float cost, constr, dds, dl;
};

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

    const float occ = max_nan(0.f, sc[j] - dfwd[m]);
    constr = (s_ca[j * NB + m] + occ) + nn.y;

    cost = w_safety * max_nan(0.f, sc[j] - d_safety);
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

  const Best b = best_action(rows + row * L, s_ca, tb, dfwd, ds, l, L, tile);
  out[cell] = make_float4(state_cost[cell] + b.cost,
                          state_constr[cell] + b.constr, b.dds, b.dl);
}

// The per-solve scalars of the fused slice, in the order of
// latlon_action_min.py SLICE_CONSTS.
enum SliceConst {
  C_S_MIN, C_S_STEP, C_L_MIN, C_L_STEP, C_DT, C_DT_START, C_LENGTH_VEH,
  C_WIDTH_VEH, C_D_LAT_COMF, C_L_TRG, C_W_L, C_W_LAT_DIST, C_W_PROGRESS,
  C_T_ST_MIN, C_T_ST_MAX, C_S_ST, C_W_ST, N_SLICE_CONST
};

__host__ __device__ inline size_t slice_smem_bytes(int ts, int L) {
  // the lookups, the tile's rows of the distance map, the d_fwd l indices
  return smem_bytes(ts, L) + sizeof(float) * ts * L + sizeof(int) * L * NB;
}

constexpr int N_CONSTS = 5;     // gap_min, time_gap, w_safety, w_ddds, w_ddl

// One whole backward slice: what the plain version computes with some
// hundred tensor operations before the action-min (the state cost and
// constraint of every cell, with the nearest reference-line row, the two
// first-obstacle searches along l and the mid-lane target, and the 7
// forward distances with their per-side running minimum), computed per cell
// from the tile's rows of the distance map in shared memory, then the
// action-min above.  Every expression keeps the plain version's operations
// and their order (reference: lat_lon_planner.cu:80-192 computed the same
// per cell inside its backward step).
//
// One scenario; a batch of scenarios takes backward_slice_batch_kernel.
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
  float cost = 1000.f * max_nan(l_g - d_left_ref, 0.f);
  cost = cost + 1000.f * max_nan(d_right_ref - l_g, 0.f);
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
    dfwd[m] = min_nan(m == NB / 2 + 1 ? dfwd[0] : dfwd[m - 1], drow[il2_l[m]]);
#pragma unroll
  for (int m = 0; m < NB; ++m) dfwd[m] = dfwd[m] - half_len;

  const Best b = best_action(rows + row * L, s_ca, tb, dfwd, ds, l, L, tile);
  out[cell] = make_float4(cost + b.cost, constr + b.constr, b.dds, b.dl);
}

// ---------------------------------------------------------------------
// The fused slice for a batch of B scenarios, each with its own next nodes,
// distance map, reference line, tables and slice constants (the JAX package
// vmaps its whole solve over a scenario batch, tpl_tpu/parallel/kernels.py
// sharded_latlon_batch).  A cell's arithmetic and its order are
// backward_slice_kernel's, so every scenario has the bits of its own
// launch; what differs is how the work reaches the SMs.
//
// What bounds it: the issue of a cell's ~2,000 instructions (49 actions of
// ~33, the producers, the staging), not its bytes (5 MB a scenario at the
// demo grid against ~10^7 warp-instructions).  Measured on 692c5cb's design
// (a block an item, 3 an SM), a block waited on device memory for ~8 of its
// 12.6 us: its row copies' addresses, its distance rows and its reference
// rows were plain loads.  So here the launch has only the resident blocks
// (SMs x blocks an SM), and each walks work items (scenario, ds row, tile
// of ts_rows s rows) w = blockIdx.x, + gridDim.x, ..., the tile fastest and
// the scenario slowest, so that the blocks in flight share one or two
// scenarios' next-slice tables (2.5 MB each at the demo grid) in L2.  While
// a block computes item w, its next item's copies land in the other of two
// buffers: the 7 target nodes of each cell (16-byte cp.async.cg, issued by
// the cell's thread one dds action at a time between the action loop's dl
// rounds, so that they never queue up at once), the distance rows, the
// reference row nearest each s row and the item's table words (its ds row
// of ca and schg, the shift and action tables, dss, the constants, the
// slice constants; 4-byte cp.async); one item further ahead, the item's
// (ids, ks) pairs and s grid, from which those addresses are formed.  So a
// cell reads every input from shared memory, and no scenario pointer is
// live in the action loop.  The rows are laid out (s row, l, dds), so that
// an action's lookup is one 16-byte load at a constant offset from its dl
// shift's row; each cell's thread replaces the z of its own staged nodes
// by their dds term w_ddds * (z - dds_vals[j])^2, which the actions of 7
// cells would otherwise each recompute; the l searches read a ballot mask
// of "too short ahead" (L <= 32).  The running best keeps the winning
// action's index with its cost and constraint, and reads (dds, dl) after
// the loop.  No load waits on device memory once a walk runs.

// the per-phase clock64() cycles of thread 0 (the profiling
// instantiation), in the order latlon_action_min.py SLICE_PHASES names
// them, which is their order in an item: waiting for its copies (and the
// block), issuing the next item's copies beside its target rows and
// preparing this one (its l indices, dds terms and ballots), the
// producers, the action loop with the next item's row copies, the store
enum Phase { P_WAIT, P_STAGE, P_PRODUCERS, P_ACTIONS, P_STORE, N_PHASE };

template <bool PROF>
struct BlockClock {
  long long last = 0;
  long long acc[N_PHASE] = {};

  __device__ __forceinline__ void start() {
    if constexpr (PROF) last = clock64();
  }
  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[phase] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* prof) {
    if constexpr (PROF) {
      if (threadIdx.x == 0)
        for (int i = 0; i < N_PHASE; ++i)
          atomicAdd(prof + i, (unsigned long long)acc[i]);
    }
  }
};

// An item's 4-byte table words in shared memory, in this order: kl, its ds
// row of ca (j, m) and of schg, qdds, qdl, dds_vals, dl_vals, its dss,
// consts, the slice constants.
enum ItemWord {
  W_KL = 0,
  W_CA = W_KL + NB,
  W_SCHG = W_CA + NB * NB,
  W_QDDS = W_SCHG + NB,
  W_QDL = W_QDDS + NB,
  W_DDS = W_QDL + NB,
  W_DL = W_DDS + NB,
  W_DSS = W_DL + NB,
  W_CONSTS = W_DSS + 1,
  W_SC = W_CONSTS + N_CONSTS,
  N_WORDS = W_SC + N_SLICE_CONST
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// An item's index slot: its ds row of (ids, ks) pairs, one a dds action,
// and its scenario's s_min and s_step, from which its copies' addresses
// are formed.
constexpr int SLOT_WORDS = 2 * NB + 2;
constexpr int REF_WORDS = 3;    // a reference row's v_max and lane bounds

// one item's buffer: the rows (ts, L, NB) float4, the distance rows
// (ts, L), the l indices of the dl actions (L, NB), the reference-row words
// of each s row (ts, REF_WORDS), the table words
__host__ __device__ inline size_t batch_buffer_bytes(int ts, int L) {
  return sizeof(float4) * NB * ts * L + align16(sizeof(float) * ts * L)
         + align16(sizeof(int) * L * NB)
         + align16(sizeof(float) * ts * REF_WORDS)
         + align16(sizeof(float) * N_WORDS);
}

// where each table word and index-slot word of an item lies in device
// memory: base + b * per_b + ds * per_ds (the block's table, in shared
// memory)
struct WordSrc {
  const unsigned* base;
  int per_b, per_ds;
};

// the ballots of a block's warps (one more word, read past the last warp's)
constexpr int N_BALLOTS = MAX_THREADS / 32 + 1;

// two buffers, two index slots, the ballots, the word sources
__host__ __device__ inline size_t batch_smem_bytes(int ts, int L) {
  return 2 * batch_buffer_bytes(ts, L) + 2 * sizeof(int) * SLOT_WORDS
         + align16(sizeof(unsigned) * N_BALLOTS)
         + sizeof(WordSrc) * (N_WORDS + SLOT_WORDS);
}

// A walk's place: scenario b, ds row, s tile t (the tile fastest, then ds,
// then the scenario).
struct Walk {
  int b, ds, t;
};

__device__ __forceinline__ Walk walk_of(int w, int DS, int n_tiles) {
  const int per_b = DS * n_tiles;
  const int r = w % per_b;
  return Walk{w / per_b, r / n_tiles, r % n_tiles};
}

// w advanced by `step` items (both in walk_of's terms)
__device__ __forceinline__ Walk walk_add(Walk w, const Walk& step, int DS,
                                         int n_tiles) {
  w.t += step.t;
  int carry = w.t >= n_tiles;
  w.t -= carry ? n_tiles : 0;
  w.ds += step.ds + carry;
  carry = w.ds >= DS;
  w.ds -= carry ? DS : 0;
  w.b += step.b + carry;
  return w;
}

// The batch's inputs (kernel parameters), for the copies.
struct BatchIn {
  const float4* nodes_next;
  const float* dist_t;
  const float* ref_line;
  const float* sc;
  Tables tb;
  float ref_step;
  int S, DS, L, n_ref, ts_rows;
  long long dist_stride;
};

// the reference-row words of an item's buffer (ts, REF_WORDS)
__device__ __forceinline__ float* ref_words(unsigned char* buf, int ts,
                                            int L) {
  return reinterpret_cast<float*>(buf + batch_buffer_bytes(ts, L)
                                  - align16(sizeof(float) * N_WORDS)
                                  - align16(sizeof(float) * ts * REF_WORDS));
}

// table word k of an item (k < N_WORDS), else word k - N_WORDS of its
// index slot
__device__ __forceinline__ WordSrc word_src(int k, const BatchIn& in) {
  const int DS = in.DS;
  auto at = [](const void* p, int per_b, int per_ds) {
    return WordSrc{static_cast<const unsigned*>(p), per_b, per_ds};
  };
  if (k < W_CA) return at(in.tb.kl + k, NB, 0);
  if (k < W_SCHG) return at(in.tb.ca + (k - W_CA), DS * NB * NB, NB * NB);
  if (k < W_QDDS) return at(in.tb.schg + (k - W_SCHG), DS * NB, NB);
  if (k < W_QDL) return at(in.tb.qdds + (k - W_QDDS), NB, 0);
  if (k < W_DDS) return at(in.tb.qdl + (k - W_QDL), NB, 0);
  if (k < W_DL) return at(in.tb.dds_vals + (k - W_DDS), NB, 0);
  if (k < W_DSS) return at(in.tb.dl_vals + (k - W_DL), NB, 0);
  if (k < W_CONSTS) return at(in.tb.dss, DS, 1);
  if (k < W_SC) return at(in.tb.consts + (k - W_CONSTS), N_CONSTS, 0);
  if (k < N_WORDS) return at(in.sc + (k - W_SC), N_SLICE_CONST, 0);
  k -= N_WORDS;
  if (k < 2 * NB)
    return at((k % 2 ? in.tb.ks : in.tb.ids) + k / 2, DS * NB, NB);
  return at(in.sc + (k == 2 * NB ? C_S_MIN : C_S_STEP), N_SLICE_CONST, 0);
}

__device__ __forceinline__ const unsigned* word_at(const WordSrc& d,
                                                   const Walk& it) {
  return d.base + (size_t)it.b * d.per_b + it.ds * d.per_ds;
}

// item `it`'s index slot (SLOT_WORDS words) from the word sources `src`,
// asynchronously (`now` false) or with plain loads
__device__ __forceinline__ void stage_index(int* slot, const WordSrc* src,
                                            const Walk& it, bool now) {
  for (int k = threadIdx.x; k < SLOT_WORDS; k += blockDim.x) {
    const unsigned* from = word_at(src[N_WORDS + k], it);
    if (now)
      slot[k] = (int)*from;
    else
      copy4_async(slot + k, from);
  }
}

// The copy of an item's target node for dds action j at the cell (row, l)
// of its tile, by that cell's thread: row clamp(s + ks[j]) and ds row
// ids[j] of the item's next slice, from its (ids, ks) pairs in the slot.
struct RowCopy {
  float4* dst;            // the cell's 7 staged nodes
  const float4* nodes;    // the item's next slice, at the cell's l
  const int2* pairs;      // the item's (ids, ks) of each dds action
  int s, S, DS, L;        // the cell's s row, the grid

  __device__ __forceinline__ void operator()(int j) const {
    const int2 t = pairs[j];
    copy16_async(dst + j, nodes + (size_t)(clampi(s + t.y, 0, S - 1) * DS
                                           + t.x) * L);
  }
};

__device__ __forceinline__ RowCopy row_copy(unsigned char* buf,
                                            const int* slot,
                                            const BatchIn& in,
                                            const Walk& it, int row, int l) {
  return RowCopy{reinterpret_cast<float4*>(buf) + (row * in.L + l) * NB,
                 in.nodes_next + (size_t)it.b * in.S * in.DS * in.L + l,
                 reinterpret_cast<const int2*>(slot), it.t * in.ts_rows + row,
                 in.S, in.DS, in.L};
}

// Item `it`'s copies into `buf` beside its target rows, by the thread of
// cell (row, l) of the tile (a block has a thread for each cell): the
// distance at (row, l), the reference-row words and the table words.
__device__ __forceinline__ void stage_item(unsigned char* buf,
                                           const int* slot,
                                           const WordSrc* src,
                                           const BatchIn& in, const Walk& it,
                                           int row, int l) {
  const int L = in.L, tile = in.ts_rows * L, S = in.S;
  const int s0 = it.t * in.ts_rows;
  if (row < in.ts_rows) {
    float* dist = reinterpret_cast<float*>(
        reinterpret_cast<float4*>(buf) + NB * tile);
    copy4_async(dist + row * L + l,
                in.dist_t + it.b * in.dist_stride
                    + clampi(s0 + row, 0, S - 1) * L + l);
  }
  // the reference row nearest s row r (round half to even), as
  // backward_slice_kernel finds it: its channels 4, 5, 6
  const float* slot_f = reinterpret_cast<const float*>(slot);
  for (int k = threadIdx.x; k < in.ts_rows * REF_WORDS; k += blockDim.x) {
    const int r = k / REF_WORDS;
    const float s_g = slot_f[2 * NB] + (float)(s0 + r) * slot_f[2 * NB + 1];
    const float at = rintf(s_g / in.ref_step);
    copy4_async(ref_words(buf, in.ts_rows, L) + k,
                in.ref_line + (size_t)it.b * in.n_ref * 8
                    + (size_t)(int)fminf(fmaxf(at, 0.f),
                                         (float)(in.n_ref - 1)) * 8
                    + 4 + (k - r * REF_WORDS));
  }
  unsigned* words = reinterpret_cast<unsigned*>(
      buf + batch_buffer_bytes(in.ts_rows, L) - align16(4 * N_WORDS));
  for (int k = threadIdx.x; k < N_WORDS; k += blockDim.x)
    copy4_async(words + k, word_at(src[k], it));
}

// best_action's lexicographic minimum (the same actions, terms, order and
// NaN rule) on an item's staged rows and table words: the winner as its
// action index m * NB + j with its cost and constraint.  my_rows: the
// staged rows of the cell's s row, entry (lt, j) at my_rows[lt * NB + j],
// its z already the dds term w_ddds * ((z - dds_vals[j])^2).
struct Pick {
  float cost, constr;
  int a;
};

//
// `between(m)` runs before dl action m's dds actions: the next item's row
// copies are issued there, spread over the loop, so that they do not queue
// up at its start.
template <class Between>
__device__ __forceinline__ Pick best_action_staged(
    const float4* my_rows, const float* w, const float (&dfwd)[NB], int l,
    int L, const Between& between) {
  const int* kl = reinterpret_cast<const int*>(w + W_KL);
  const float gap_min = w[W_CONSTS], time_gap = w[W_CONSTS + 1];
  const float w_safety = w[W_CONSTS + 2], w_ddl = w[W_CONSTS + 4];
  const float ds_gap = w[W_DSS] * time_gap;

  auto action = [&](int m, int j, float& cost, float& constr) {
    const int lt = clampi(l + kl[m], 0, L - 1);
    const float d_safety = (dfwd[m] - gap_min) - ds_gap;
    const float4 nn = my_rows[lt * NB + j];

    const float occ = max_nan(0.f, w[W_SCHG + j] - dfwd[m]);
    constr = (w[W_CA + j * NB + m] + occ) + nn.y;

    cost = w_safety * max_nan(0.f, w[W_SCHG + j] - d_safety);
    cost = cost + w[W_QDDS + j];
    cost = cost + nn.z;
    cost = cost + w[W_QDL + m];
    const float e_dl = nn.w - w[W_DL + m];
    cost = cost + w_ddl * (e_dl * e_dl);
    cost = cost + nn.x;
  };

  Pick p;
  between(0);
  action(0, 0, p.cost, p.constr);
  p.a = 0;
  bool nan_c = p.constr != p.constr;
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    if (m > 0) between(m);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (m == 0 && j == 0) continue;
      float cost, constr;
      action(m, j, cost, constr);
      nan_c = nan_c || constr != constr;
      if (constr < p.constr ||
          (constr == p.constr &&
           (cost < p.cost || (cost != cost && p.cost == p.cost)))) {
        p.constr = constr;
        p.cost = cost;
        p.a = m * NB + j;
      }
    }
  }
  if (nan_c || p.cost == INFINITY) {
    action(0, 0, p.cost, p.constr);
    p.a = 0;
  }
  return p;
}

// the batched kernel's blocks an SM at FEW_THREADS: caps the registers
constexpr int BATCH_BLOCKS = 3;

template <int THREADS, bool PROF>
__global__ void __launch_bounds__(THREADS, THREADS == FEW_THREADS
                                               ? BATCH_BLOCKS : 1)
backward_slice_batch_kernel(
    const float4* __restrict__ nodes_next,   // (B, S, DS, L) x 4 channels
    const float* __restrict__ dist_t,        // (S, L) at b * dist_stride
    const float* __restrict__ ref_line,      // (B, n_ref, 8)
    const float* __restrict__ ref_step,      // one value
    const float* __restrict__ sc,            // (B, N_SLICE_CONST)
    const int* __restrict__ ids,             // (B, DS, NB)
    const int* __restrict__ ks,              // (B, DS, NB)
    const int* __restrict__ kl,              // (B, NB)
    const float* __restrict__ ca,            // (B, DS, NB, NB)
    const float* __restrict__ schg,          // (B, DS, NB)
    const float* __restrict__ qdds,          // (B, NB)
    const float* __restrict__ qdl,           // (B, NB)
    const float* __restrict__ dds_vals,      // (B, NB)
    const float* __restrict__ dl_vals,       // (B, NB)
    const float* __restrict__ dss,           // (B, DS)
    const float* __restrict__ consts,        // (B, N_CONSTS)
    float4* __restrict__ out,                // (B, S, DS, L) x 4 channels
    unsigned long long* __restrict__ prof,   // N_PHASE (PROF only)
    int S, int DS, int L, int n_ref, int slice, int ts_rows, int B,
    long long dist_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BatchIn in = {nodes_next, dist_t, ref_line, sc,
                      Tables{ids, ks, kl, ca, schg, qdds, qdl, dds_vals,
                             dl_vals, dss, consts},
                      *ref_step, S, DS, L, n_ref, ts_rows, dist_stride};
  const int tid = threadIdx.x;
  const int tile = ts_rows * L;
  const int n_tiles = (S + ts_rows - 1) / ts_rows;
  const size_t buf_bytes = batch_buffer_bytes(ts_rows, L);
  int* slots = reinterpret_cast<int*>(smem_raw + 2 * buf_bytes);
  // a warp's ballot of its cells' "too short ahead" (the l searches)
  unsigned* ballots = reinterpret_cast<unsigned*>(slots + 2 * SLOT_WORDS);
  WordSrc* src = reinterpret_cast<WordSrc*>(
      reinterpret_cast<unsigned char*>(ballots)
      + align16(sizeof(unsigned) * N_BALLOTS));
  for (int k = tid; k < N_WORDS + SLOT_WORDS; k += blockDim.x)
    src[k] = word_src(k, in);
  // the thread's cell in every item (a block has a thread for each)
  const int row = tid / L;
  const int l = tid - row * L;
  BlockClock<PROF> clk;
  clk.start();

  const Walk step = walk_of(gridDim.x, DS, n_tiles);
  Walk it = walk_of(blockIdx.x, DS, n_tiles);
  Walk next = walk_add(it, step, DS, n_tiles);
  __syncthreads();
  if (it.b < B) {
    stage_index(slots, src, it, true);
    __syncthreads();
    stage_item(smem_raw, slots, src, in, it, row, l);
    if (row < ts_rows) {
      const RowCopy copy = row_copy(smem_raw, slots, in, it, row, l);
#pragma unroll
      for (int j = 0; j < NB; ++j) copy(j);
    }
    if (next.b < B) stage_index(slots + SLOT_WORDS, src, next, false);
  }
  for (int k = 0; it.b < B; ++k, it = next, next = walk_add(next, step, DS,
                                                             n_tiles)) {
    copies_wait();
    __syncthreads();
    clk.stamp(P_WAIT);
    unsigned char* buf = smem_raw + (k & 1) * buf_bytes;
    unsigned char* buf_next = smem_raw + ((k + 1) & 1) * buf_bytes;
    const int* slot_next = slots + ((k + 1) & 1) * SLOT_WORDS;
    const bool more = next.b < B;
    if (more) {
      stage_item(buf_next, slot_next, src, in, next, row, l);
      const Walk after = walk_add(next, step, DS, n_tiles);
      if (after.b < B)
        stage_index(slots + (k & 1) * SLOT_WORDS, src, after, false);
    }

    float4* rows = reinterpret_cast<float4*>(buf);
    const float* dist = reinterpret_cast<const float*>(rows + NB * tile);
    int* il2 = reinterpret_cast<int*>(buf + NB * tile * sizeof(float4)
                                      + align16(sizeof(float) * tile));
    const float* wd = reinterpret_cast<const float*>(
        buf + buf_bytes - align16(4 * N_WORDS));
    const float* scs = wd + W_SC;
    const float l_min = scs[C_L_MIN], l_step = scs[C_L_STEP];
    const float dt = scs[C_DT];
    const int s = it.t * ts_rows + row;
    const bool active = row < ts_rows && s < S;
    const float* drow = dist + row * L;
    const float ds_g = wd[W_DSS];
    const float half_len = scs[C_LENGTH_VEH] * 0.5f;
    const float l_g = l_min + (float)l * l_step;
    // the l index each dl action's lateral sweep reads, per l
    for (int q = tid; q < L * NB; q += blockDim.x) {
      const float lq = l_min + (float)(q / NB) * l_step;
      const float at = rintf(((lq + wd[W_DL + q % NB] * dt) - l_min) / l_step);
      il2[q] = (int)fminf(fmaxf(at, 0.f), (float)(L - 1));
    }
    if (row < ts_rows) {
      // the dds term of this cell's staged nodes, w_ddds * (e_dds * e_dds)
      const float w_ddds = wd[W_CONSTS + 3];
      float4* mine = rows + (row * L + l) * NB;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float e_dds = mine[j].z - wd[W_DDS + j];
        mine[j].z = w_ddds * (e_dds * e_dds);
      }
    }
    // the first l offset to each side whose distance ahead is too short:
    // up to 32 lateral cells from the ballots of "drow[l] < mean_dist"
    const float mean_dist = fmaxf(ds_g * dt, half_len);
    const bool by_mask = L <= 32;
    if (by_mask) {
      const unsigned bal = __ballot_sync(0xffffffffu,
                                         active && drow[l] < mean_dist);
      if ((tid & 31) == 0) ballots[tid >> 5] = bal;
    }
    clk.stamp(P_STAGE);
    __syncthreads();   // il2, the dds terms, the ballots

    float cost = 0.f, constr = 0.f;
    float dfwd[NB] = {};
    if (active) {
      // backward_slice_kernel's producers, expression for expression
      const float s_g = scs[C_S_MIN] + (float)s * scs[C_S_STEP];
      const float t = scs[C_DT_START] + (float)(slice - 1) * dt;

      // the nearest reference-line row's words, staged
      const float* refr = ref_words(buf, ts_rows, L) + row * REF_WORDS;
      const float v_max_ref = refr[0];
      const float half_width = scs[C_WIDTH_VEH] * 0.5f;
      const float d_left_ref = refr[1] - half_width;
      const float d_right_ref = -(refr[2] - half_width);

      int i_left = 0, i_right = 0;
      bool found_left = false, found_right = false;
      if (by_mask) {
        // bit p of `mask`: drow[p] < mean_dist; the searches' clamped
        // reads repeat the edge cell, which the mask already holds
        const int g = row * L;
        const unsigned long long win =
            (unsigned long long)ballots[(g >> 5) + 1] << 32 | ballots[g >> 5];
        const unsigned mask = (unsigned)(win >> (g & 31))
                              & (L == 32 ? 0xffffffffu : (1u << L) - 1);
        const unsigned ahead = mask >> l, behind = mask & ((2u << l) - 1);
        found_left = ahead != 0;
        i_left = found_left ? __ffs(ahead) - 1 : 0;
        found_right = behind != 0;
        i_right = found_right ? l - (31 - __clz(behind)) : 0;
      } else {
        for (int q = 0; q < L; ++q)
          if (drow[clampi(l + q, 0, L - 1)] < mean_dist) {
            i_left = q;
            found_left = true;
            break;
          }
        for (int q = 0; q < L; ++q)
          if (drow[clampi(l - q, 0, L - 1)] < mean_dist) {
            i_right = q;
            found_right = true;
            break;
          }
      }
      const float l_left = found_left ? l_g + (float)i_left * l_step : 0.f;
      const float l_right = found_right ? l_g - (float)i_right * l_step : 0.f;
      const float mid = l_right + (l_left - l_right) * 0.5f;
      const float mid_y = fminf(l_right + scs[C_D_LAT_COMF], mid);
      const float mid_z = fmaxf(l_left - scs[C_D_LAT_COMF], mid);
      const float l_trg = scs[C_L_TRG];
      const float mid_x =
          l_trg < l_right ? mid_y : (l_trg > l_left ? mid_z : l_trg);

      // the state cost and constraint, term by term
      cost = 1000.f * max_nan(l_g - d_left_ref, 0.f);
      cost = cost + 1000.f * max_nan(d_right_ref - l_g, 0.f);
      float e = mid_x - l_g;
      cost = cost + scs[C_W_L] * (e * e);
      e = mid_y - l_g;
      cost = cost + (l_g < mid_y ? scs[C_W_LAT_DIST] * (e * e) : 0.f);
      e = mid_z - l_g;
      cost = cost + (l_g > mid_z ? scs[C_W_LAT_DIST] * (e * e) : 0.f);
      cost = cost + scs[C_W_PROGRESS] * (1000.f - s_g);
      constr = ds_g > v_max_ref ? ds_g - v_max_ref : 0.f;
      const float s_st = scs[C_S_ST], w_st = scs[C_W_ST];
      cost = cost + (t < scs[C_T_ST_MIN] ? w_st * fmaxf(s_g - s_st, 0.f)
                                         : 0.f);
      cost = cost + (t > scs[C_T_ST_MAX] ? w_st * fmaxf(s_st - s_g, 0.f)
                                         : 0.f);

      // the forward distances: center, then the running minimum to each
      // side
      const int* il2_l = il2 + l * NB;
      dfwd[0] = drow[il2_l[0]];
#pragma unroll
      for (int m = 1; m < NB; ++m)
        dfwd[m] = min_nan(m == NB / 2 + 1 ? dfwd[0] : dfwd[m - 1],
                          drow[il2_l[m]]);
#pragma unroll
      for (int m = 0; m < NB; ++m) dfwd[m] = dfwd[m] - half_len;
    }
    clk.stamp(P_PRODUCERS);
    if (row < ts_rows) {
      // (a row past S in the last tile takes the actions too, for the
      // next item's row copies they issue, and stores nothing)
      const RowCopy copy = row_copy(buf_next, slot_next, in, next, row, l);
      const Pick p = best_action_staged(rows + row * L * NB, wd, dfwd, l, L,
                                        [&](int j) {
                                          if (more) copy(j);
                                        });
      clk.stamp(P_ACTIONS);
      if (active)
        out[((size_t)it.b * S + s) * DS * L + (size_t)it.ds * L + l] =
            make_float4(cost + p.cost, constr + p.constr,
                        wd[W_DDS + p.a % NB], wd[W_DL + p.a / NB]);
      clk.stamp(P_STORE);
    }
  }
  clk.flush(prof);
}

// an empty kernel, to time a launch of the same shape
__global__ void empty_kernel() {}

}  // namespace latlon_am

// The s rows of a block's tile at L lateral cells.  A block has one thread
// per cell of its tile, in whole warps, so the height is chosen to fill the
// warps' lanes (L = 21: 12 rows, 252 of 256 lanes; 8 rows would idle 24 of
// 192), the largest such within FEW_THREADS; 0 where even one row has too
// many cells.
extern "C" int latlon_action_min_tile_rows(int L) {
  using namespace latlon_am;
  int best = 0;
  float best_fill = 0.f;
  for (int rows = 1; rows <= MAX_ROWS; ++rows) {
    const int cells = rows * L;
    if (cells > MAX_THREADS || (best && cells > FEW_THREADS)) break;
    const float fill = (float)cells / (float)((cells + 31) / 32 * 32);
    if (fill >= best_fill) {
      best = rows;
      best_fill = fill;
    }
  }
  return best;
}

extern "C" int latlon_n_slice_consts() { return latlon_am::N_SLICE_CONST; }

#ifdef __CUDACC__
namespace latlon_am {

// the launch shape of a tile of ts_rows rows (0: the default height)
struct Shape {
  int ts_rows, threads;
  dim3 grid;
  bool few, ok;
};

inline Shape shape_of(int S, int DS, int L, int ts_rows) {
  Shape sh;
  sh.ts_rows = ts_rows > 0 ? ts_rows : latlon_action_min_tile_rows(L);
  sh.ok = sh.ts_rows > 0 && sh.ts_rows * L <= MAX_THREADS && DS <= 65535;
  if (!sh.ok) return sh;
  sh.grid = dim3((S + sh.ts_rows - 1) / sh.ts_rows, DS);
  sh.threads = (sh.ts_rows * L + 31) / 32 * 32;
  sh.few = sh.threads <= FEW_THREADS;
  return sh;
}

// the launchers' shared-memory limits set so far, by instantiation (few;
// the batch's also by profiling)
smem_limit::Marks action_min_marks[2], slice_marks[2], batch_marks[2][2];

inline Tables tables_of(const void* const* t) {
  return Tables{
      static_cast<const int*>(t[0]), static_cast<const int*>(t[1]),
      static_cast<const int*>(t[2]), static_cast<const float*>(t[3]),
      static_cast<const float*>(t[4]), static_cast<const float*>(t[5]),
      static_cast<const float*>(t[6]), static_cast<const float*>(t[7]),
      static_cast<const float*>(t[8]), static_cast<const float*>(t[9]),
      static_cast<const float*>(t[10])};
}

}  // namespace latlon_am

// Launches on `stream` with tiles of `ts_rows` s rows (0: the default,
// latlon_action_min_tile_rows) and returns cudaGetLastError() (0 on
// success).  Allocates nothing and does not synchronise.
extern "C" int latlon_action_min_tiled(
    const void* nodes_next, const void* state_cost, const void* state_constr,
    const void* d_fwd, const void* ids, const void* ks, const void* kl,
    const void* ca, const void* schg, const void* qdds, const void* qdl,
    const void* dds_vals, const void* dl_vals, const void* dss,
    const void* consts, void* out, int S, int DS, int L, int ts_rows,
    void* stream) {
  using namespace latlon_am;
  const Shape sh = shape_of(S, DS, L, ts_rows);
  if (!sh.ok) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(sh.ts_rows, L);
  auto kernel = sh.few ? action_min_kernel<FEW_THREADS>
                       : action_min_kernel<MAX_THREADS>;
  cudaError_t err = smem_limit::ensure(kernel, smem,
                                       action_min_marks[sh.few]);
  if (err != cudaSuccess) return (int)err;
  const void* const t[] = {ids, ks, kl, ca, schg, qdds, qdl, dds_vals,
                           dl_vals, dss, consts};
  const Tables tb = tables_of(t);
  kernel<<<sh.grid, sh.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes_next),
      static_cast<const float*>(state_cost),
      static_cast<const float*>(state_constr),
      static_cast<const float*>(d_fwd), tb.ids, tb.ks, tb.kl, tb.ca, tb.schg,
      tb.qdds, tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
      static_cast<float4*>(out), S, DS, L, sh.ts_rows);
  return static_cast<int>(cudaGetLastError());
}

namespace latlon_am {

// The batched kernel's launch: the resident blocks (SMs x blocks an SM
// with `smem` bytes, by cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// at most one a work item.  Kept per device and instantiation.
struct Resident {
  size_t smem = 0;
  int blocks = 0;
};
Resident resident_marks[2][2][smem_limit::MAX_DEVICES];

template <class K>
inline cudaError_t batch_grid(K kernel, const Shape& sh, size_t smem,
                              bool prof, long long items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Resident scratch;
  Resident& r = dev >= 0 && dev < smem_limit::MAX_DEVICES
                    ? resident_marks[sh.few][prof][dev] : scratch;
  if (r.blocks == 0 || r.smem != smem) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          sh.threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    r.smem = smem;
    r.blocks = sms * per_sm;
  }
  *grid = (int)(items < r.blocks ? items : r.blocks);
  return cudaSuccess;
}

// the batched launch's kernel, shape, shared memory and blocks
template <bool PROF>
inline cudaError_t batch_launch(
    const void* nodes_next, const void* dist_t, const void* ref_line,
    const void* ref_step, const void* slice_consts, const void* const* tables,
    void* out, unsigned long long* prof, int S, int DS, int L, int n_ref,
    int slice, int B, long long dist_stride, cudaStream_t stream) {
  const Shape sh = shape_of(S, DS, L, 0);
  if (!sh.ok || n_ref < 1 || B < 1) return cudaErrorInvalidValue;
  const size_t smem = batch_smem_bytes(sh.ts_rows, L);
  auto kernel = sh.few ? backward_slice_batch_kernel<FEW_THREADS, PROF>
                       : backward_slice_batch_kernel<MAX_THREADS, PROF>;
  cudaError_t err = smem_limit::ensure(kernel, smem,
                                       batch_marks[sh.few][PROF]);
  int grid = 0;
  if (err == cudaSuccess)
    err = batch_grid(kernel, sh, smem, PROF,
                     (long long)sh.grid.x * sh.grid.y * B, &grid);
  if (err != cudaSuccess) return err;
  const Tables tb = tables_of(tables);
  kernel<<<grid, sh.threads, smem, stream>>>(
      static_cast<const float4*>(nodes_next),
      static_cast<const float*>(dist_t), static_cast<const float*>(ref_line),
      static_cast<const float*>(ref_step),
      static_cast<const float*>(slice_consts), tb.ids, tb.ks, tb.kl, tb.ca,
      tb.schg, tb.qdds, tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
      static_cast<float4*>(out), prof, S, DS, L, n_ref, slice, sh.ts_rows, B,
      dist_stride);
  return cudaGetLastError();
}

}  // namespace latlon_am

// Backward slice i of B scenarios in one launch at the default tile:
// `tables` holds the 11 table pointers in the order of latlon_am::Tables,
// each table B copies one after the other; nodes_next / out (B, S, DS, L)
// x 4, ref_line (B, n_ref, 8), slice_consts (B, N_SLICE_CONST),
// contiguous; scenario b's distance map (S, L) at dist_t + b * dist_stride;
// `slice` is the slice's index i (its time is dt_start + (i - 1) dt).  One
// scenario (B = 1) runs backward_slice_kernel (a block a tile and ds), a
// batch backward_slice_batch_kernel (the resident blocks walking the
// items).
extern "C" int latlon_backward_slice(
    const void* nodes_next, const void* dist_t, const void* ref_line,
    const void* ref_step, const void* slice_consts, const void* const* tables,
    void* out, int S, int DS, int L, int n_ref, int slice, int B,
    long long dist_stride, void* stream) {
  using namespace latlon_am;
  if (B > 1)
    return (int)batch_launch<false>(
        nodes_next, dist_t, ref_line, ref_step, slice_consts, tables, out,
        nullptr, S, DS, L, n_ref, slice, B, dist_stride,
        static_cast<cudaStream_t>(stream));
  const Shape sh = shape_of(S, DS, L, 0);
  if (!sh.ok || n_ref < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = slice_smem_bytes(sh.ts_rows, L);
  auto kernel = sh.few ? backward_slice_kernel<FEW_THREADS>
                       : backward_slice_kernel<MAX_THREADS>;
  cudaError_t err = smem_limit::ensure(kernel, smem, slice_marks[sh.few]);
  if (err != cudaSuccess) return (int)err;
  const Tables tb = tables_of(tables);
  kernel<<<sh.grid, sh.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes_next),
      static_cast<const float*>(dist_t), static_cast<const float*>(ref_line),
      static_cast<const float*>(ref_step),
      static_cast<const float*>(slice_consts), tb.ids, tb.ks, tb.kl, tb.ca,
      tb.schg, tb.qdds, tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
      static_cast<float4*>(out), S, DS, L, n_ref, slice, sh.ts_rows);
  return static_cast<int>(cudaGetLastError());
}

// The batched slice (B > 1) through its profiling instantiation: the same
// nodes, and per phase (latlon_am::Phase) thread 0's clock64() cycles of
// every block added into prof[N_PHASE].
extern "C" int latlon_backward_slice_profile(
    const void* nodes_next, const void* dist_t, const void* ref_line,
    const void* ref_step, const void* slice_consts, const void* const* tables,
    void* out, int S, int DS, int L, int n_ref, int slice, int B,
    long long dist_stride, unsigned long long* prof, void* stream) {
  if (B < 2) return (int)cudaErrorInvalidValue;
  return (int)latlon_am::batch_launch<true>(
      nodes_next, dist_t, ref_line, ref_step, slice_consts, tables, out, prof,
      S, DS, L, n_ref, slice, B, dist_stride,
      static_cast<cudaStream_t>(stream));
}

extern "C" int latlon_backward_slice_n_phases() { return latlon_am::N_PHASE; }

// The blocks of latlon_backward_slice's launch of B scenarios (a batch:
// the resident blocks on the current device, at most one an item), or -1.
extern "C" int latlon_backward_slice_grid(int S, int DS, int L, int B) {
  using namespace latlon_am;
  const Shape sh = shape_of(S, DS, L, 0);
  if (!sh.ok || B < 1) return -1;
  const long long items = (long long)sh.grid.x * sh.grid.y * B;
  if (B == 1) return (int)items;
  const size_t smem = batch_smem_bytes(sh.ts_rows, L);
  auto kernel = sh.few ? backward_slice_batch_kernel<FEW_THREADS, false>
                       : backward_slice_batch_kernel<MAX_THREADS, false>;
  int grid = -1;
  if (smem_limit::ensure(kernel, smem, batch_marks[sh.few][0]) !=
          cudaSuccess ||
      batch_grid(kernel, sh, smem, false, items, &grid) != cudaSuccess)
    return -1;
  return grid;
}

// numRegs and localSizeBytes (cudaFuncGetAttributes) of the one-scenario
// kernel (which 0), the batched one (1) and its profiling instantiation (2)
// at FEW_THREADS; returns the CUDA error code.
extern "C" int latlon_backward_slice_attributes(int which, int* regs,
                                                int* local_bytes) {
  using namespace latlon_am;
  const void* fn =
      which == 0 ? (const void*)backward_slice_kernel<FEW_THREADS>
      : which == 1
          ? (const void*)backward_slice_batch_kernel<FEW_THREADS, false>
          : (const void*)backward_slice_batch_kernel<FEW_THREADS, true>;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// The same at the default tile.
extern "C" int latlon_action_min(
    const void* nodes_next, const void* state_cost, const void* state_constr,
    const void* d_fwd, const void* ids, const void* ks, const void* kl,
    const void* ca, const void* schg, const void* qdds, const void* qdl,
    const void* dds_vals, const void* dl_vals, const void* dss,
    const void* consts, void* out, int S, int DS, int L, void* stream) {
  return latlon_action_min_tiled(nodes_next, state_cost, state_constr, d_fwd,
                                 ids, ks, kl, ca, schg, qdds, qdl, dds_vals,
                                 dl_vals, dss, consts, out, S, DS, L, 0,
                                 stream);
}

// Launches an empty kernel of `blocks` x `threads` on `stream`.
extern "C" int latlon_empty_launch(int blocks, int threads, void* stream) {
  latlon_am::empty_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Loads the kernels onto the current device and raises their shared-memory
// limits, so that the first launch pays for neither (the wrapper calls it
// when it binds the library).  Returns the CUDA error code.
extern "C" int latlon_action_min_prepare() {
  using namespace latlon_am;
  using smem_limit::prepare;
  cudaError_t err =
      prepare(action_min_kernel<FEW_THREADS>, action_min_marks[1]);
  if (err == cudaSuccess)
    err = prepare(action_min_kernel<MAX_THREADS>, action_min_marks[0]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_kernel<FEW_THREADS>, slice_marks[1]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_kernel<MAX_THREADS>, slice_marks[0]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_batch_kernel<FEW_THREADS, false>,
                  batch_marks[1][0]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_batch_kernel<MAX_THREADS, false>,
                  batch_marks[0][0]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_batch_kernel<FEW_THREADS, true>,
                  batch_marks[1][1]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_batch_kernel<MAX_THREADS, true>,
                  batch_marks[0][1]);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, empty_kernel);
  return (int)err;
}
#endif

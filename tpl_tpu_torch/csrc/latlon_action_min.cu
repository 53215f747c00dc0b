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

// waits for every copy16_async of the calling thread
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
// BATCHED: blockIdx.z is the scenario of a batch (the JAX package vmaps its
// whole solve over a scenario batch, tpl_tpu/parallel/kernels.py
// sharded_latlon_batch): scenario z reads its own next nodes and writes its
// own out at z * S * DS * L cells, its distance map at z * dist_stride
// floats, its n_ref reference rows at z * n_ref * 8, its slice constants
// and every table at z times the table's size; ref_step and the slice index
// are shared.  A block computes exactly what it computes for one scenario,
// so every scenario of a batch has the bits of its own launch.  The
// one-scenario instantiation (BATCHED false) leaves the kernel parameters
// as they arrive: offset pointers live in registers, and at 80 of them
// (FEW_THREADS) the batched instantiation spills 8 bytes.
template <int THREADS, bool BATCHED = false>
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
    int S, int DS, int L, int n_ref, int slice, int ts_rows,
    long long dist_stride) {
  if constexpr (BATCHED) {   // the block's scenario
    const size_t z = blockIdx.z;
    const size_t cells = (size_t)S * DS * L;
    nodes_next += z * cells;
    out += z * cells;
    dist_t += z * dist_stride;
    ref_line += z * n_ref * 8;
    sc += z * N_SLICE_CONST;
    ids += z * DS * NB;
    ks += z * DS * NB;
    kl += z * NB;
    ca += z * DS * NB * NB;
    schg += z * DS * NB;
    qdds += z * NB;
    qdl += z * NB;
    dds_vals += z * NB;
    dl_vals += z * NB;
    dss += z * DS;
    consts += z * N_CONSTS;
  }
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

// the launchers' shared-memory limits set so far, by instantiation (few)
smem_limit::Marks action_min_marks[2], slice_marks[2], batch_marks[2];

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

// Backward slice i of B scenarios in one launch (backward_slice_kernel) at
// the default tile: `tables` holds the 11 table pointers in the order of
// latlon_am::Tables, each table B copies one after the other; nodes_next /
// out (B, S, DS, L) x 4, ref_line (B, n_ref, 8), slice_consts
// (B, N_SLICE_CONST), contiguous; scenario b's distance map (S, L) at
// dist_t + b * dist_stride; `slice` is the slice's index i (its time is
// dt_start + (i - 1) dt).  One scenario (B = 1) runs the one-scenario
// instantiation, a batch the batched one (blockIdx.z the scenario).
extern "C" int latlon_backward_slice(
    const void* nodes_next, const void* dist_t, const void* ref_line,
    const void* ref_step, const void* slice_consts, const void* const* tables,
    void* out, int S, int DS, int L, int n_ref, int slice, int B,
    long long dist_stride, void* stream) {
  using namespace latlon_am;
  Shape sh = shape_of(S, DS, L, 0);
  if (!sh.ok || n_ref < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  sh.grid.z = B;
  const bool batched = B > 1;
  const size_t smem = slice_smem_bytes(sh.ts_rows, L);
  auto kernel = batched ? (sh.few ? backward_slice_kernel<FEW_THREADS, true>
                                  : backward_slice_kernel<MAX_THREADS, true>)
                        : (sh.few ? backward_slice_kernel<FEW_THREADS>
                                  : backward_slice_kernel<MAX_THREADS>);
  cudaError_t err = smem_limit::ensure(
      kernel, smem, batched ? batch_marks[sh.few] : slice_marks[sh.few]);
  if (err != cudaSuccess) return (int)err;
  const Tables tb = tables_of(tables);
  kernel<<<sh.grid, sh.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes_next),
      static_cast<const float*>(dist_t), static_cast<const float*>(ref_line),
      static_cast<const float*>(ref_step),
      static_cast<const float*>(slice_consts), tb.ids, tb.ks, tb.kl, tb.ca,
      tb.schg, tb.qdds, tb.qdl, tb.dds_vals, tb.dl_vals, tb.dss, tb.consts,
      static_cast<float4*>(out), S, DS, L, n_ref, slice, sh.ts_rows,
      dist_stride);
  return static_cast<int>(cudaGetLastError());
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
    err = prepare(backward_slice_kernel<FEW_THREADS, true>, batch_marks[1]);
  if (err == cudaSuccess)
    err = prepare(backward_slice_kernel<MAX_THREADS, true>, batch_marks[0]);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, empty_kernel);
  return (int)err;
}
#endif

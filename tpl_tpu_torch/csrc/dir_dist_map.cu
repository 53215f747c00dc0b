// The directional distance field of the graph DP planner, for Hopper
// (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/dyn_prog/dp_environment.py _dir_dist_map (:205-246).
// The reference is env.cu:160-214 updateDirDistMap.
//
// A ray from cell (s, l) in direction d samples ss + ds * i, ls + dl * i
// (each operation rounded on its own; ds, dl from the host table,
// tpl_tpu_torch/planning/dyn_prog/dp_environment.py ray_table).  A sample
// blocks a time slice when its float indices (x - min) / step leave the
// open grid (<= 0 or >= n) or its cell trunc(clip(f, 0, n - 1)) is
// occupied in that slice; the slice's distance is the first blocking
// sample's index times the spacing, or 10000 when none of the ray_steps
// samples blocks.  ray_steps is a launch argument.
//
// Only the occupancy read depends on the slice: a sample's position, its
// float indices, the grid test and its cell are the same in every slice.
// So a ray is marched once for a group of up to 32 slices.  The block
// stages the occupancy of the rows its rays can reach as one mask word a
// cell (bit t: slice t of the group occupied); a sample reads its cell's
// word and records its distance for every slice still alive that the word
// blocks (a sample outside the grid blocks them all); the ray stops when
// no slice of the group is alive.  It marches the longest ray of each
// (s, l, d) over the slices: a tenth of the samples of one march a slice
// on the JAX test scene, a fifth on seeded random occupancy.
//
// One block per (station s, group of slices), one thread per ray (l, d),
// l fastest: a warp's lanes march neighbouring rays of one direction,
// whose lengths are alike (a warp runs as long as its longest lane).  The
// distances are staged in shared memory as the group's (t, l, d) rows,
// which are contiguous in the field, and written out coalesced.  The rows
// a block stages are exact: a sample's row index is monotone in i (each
// rounded operation is), so every row the block's rays read lies between
// the rows of their first and last samples, which warp 0 computes with the
// march's own operations.  In a block of one station a sample's station
// side (its row, or outside the grid) depends only on (d, i): the block
// tabulates it once (D x R ints), and a sample divides once, for its
// lateral index.  When two blocks share an SM the march is bound by the
// rate at which the SM's schedulers dispatch its instructions, so its cost
// is counted in instructions a sample.
//
// What bounds it: at the demo widths the field's 3.55 MB written (bytes),
// and the longest ray's chain of dependent samples (a division each).
//
// The operations of a sample and their order are the plain version's
// (dp_environment.dir_dist_reference), so the two agree cell for cell.
// Build with --fmad=false.

#include <cuda_runtime.h>
#include <stddef.h>

#include "smem_limit.cuh"

namespace dir_dist {

constexpr int MAX_THREADS = 512;
constexpr int WARP = 32;
constexpr int GROUP = 32;   // the slices one mask word holds
constexpr unsigned FULL = 0xffffffffu;
constexpr float FREE_DIST = 10000.0f;

// the profiling instantiation's phases, thread 0's cycles from barrier to
// barrier summed over the blocks: the row range, the FREE_DIST fill and
// the mask; the march; the write-out
enum Phase { PH_STAGE, PH_MARCH, PH_WRITE, N_PHASE };

// a thread a ray of one station, in whole warps
__host__ __device__ inline int block_threads(int L, int D) {
  const int n = (L * D + WARP - 1) / WARP * WARP;
  return n < MAX_THREADS ? n : MAX_THREADS;
}

// a block's dynamic shared memory: the group's distances (at most 32
// slices of L x D floats), a mask word a cell of the S x L grid, each
// sample's staged row (D x R), the staged row range
__host__ __device__ inline size_t smem_bytes(int T, int S, int L, int D,
                                             int R) {
  const int tg = T < GROUP ? T : GROUP;
  return 4 * ((size_t)tg * L * D + (size_t)S * L + (size_t)D * R + 2);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// the float station index of sample i of a ray from ss along rds
__device__ __forceinline__ float station_f(float ss, float rds, int i,
                                           float s_min, float s_step) {
  return (ss + rds * (float)i - s_min) / s_step;
}

// a float index's cell along an axis of n cells, clipped to the grid
__device__ __forceinline__ int cell_of(float f, float n) {
  return (int)fminf(fmaxf(f, 0.0f), n - 1.0f);
}

template <bool PROF>
__global__ void __launch_bounds__(MAX_THREADS) dir_dist_kernel(
    const float* __restrict__ occ, const float* __restrict__ ray,
    float s_min, float s_step, float l_min, float l_step, float step,
    float* __restrict__ out, unsigned long long* __restrict__ prof, int T,
    int S, int L, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.x;
  const int g0 = blockIdx.y * GROUP;
  const int tg = T - g0 < GROUP ? T - g0 : GROUP;
  const int LD = L * D;
  float* dist = reinterpret_cast<float*>(smem_raw);      // (tg, L, D)
  unsigned* mask = reinterpret_cast<unsigned*>(dist + (size_t)tg * LD);
  int* row_of = reinterpret_cast<int*>(mask + (size_t)S * L);  // (D, R)
  int* rows = row_of + (size_t)D * R;                         // lo, hi
  long long clk[N_PHASE + 1] = {};
  if (PROF && threadIdx.x == 0) clk[0] = clock64();
  const float fS = (float)S, fL = (float)L;
  const float ss = s_min + (float)s * s_step;

  // the rows the block's rays can read: between those of their first and
  // last samples
  if (threadIdx.x < WARP) {
    int lo = S - 1, hi = 0;
    for (int d = threadIdx.x; d < D; d += WARP) {
      const float rds = ray[2 * d];
      const int a = cell_of(station_f(ss, rds, 0, s_min, s_step), fS);
      const int b = cell_of(station_f(ss, rds, R - 1, s_min, s_step), fS);
      lo = imin(lo, imin(a, b));
      hi = imax(hi, imax(a, b));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = imin(lo, __shfl_xor_sync(FULL, lo, off));
      hi = imax(hi, __shfl_xor_sync(FULL, hi, off));
    }
    if (threadIdx.x == 0) {
      rows[0] = lo;
      rows[1] = hi;
    }
  }
  for (int k = threadIdx.x; k < tg * LD; k += blockDim.x) dist[k] = FREE_DIST;
  __syncthreads();
  const int lo = rows[0];
  const int n_cells = (rows[1] - lo + 1) * L;
  const float* occ_g = occ + ((size_t)g0 * S + lo) * L;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
    unsigned w = 0;
#pragma unroll 4
    for (int t = 0; t < tg; ++t)
      w |= (occ_g[(size_t)t * S * L + c] > 0.0f ? 1u : 0u) << t;
    mask[c] = w;
  }
  // the station's side of every sample: its staged row, or -1 where its
  // station index leaves the open grid
  for (int k = threadIdx.x; k < D * R; k += blockDim.x) {
    const int d = k / R;
    const float is_f = station_f(ss, ray[2 * d], k - d * R, s_min, s_step);
    row_of[k] = is_f <= 0.0f || is_f >= fS ? -1 : cell_of(is_f, fS) - lo;
  }
  __syncthreads();
  if (PROF && threadIdx.x == 0) clk[1] = clock64();

  const unsigned all = tg == GROUP ? FULL : (1u << tg) - 1u;
  for (int k = threadIdx.x; k < LD; k += blockDim.x) {
    const int l = k % L, d = k / L;
    const float ls = l_min + (float)l * l_step;
    const float rdl = ray[2 * d + 1];
    const int* row_d = row_of + d * R;
    float* dist_ld = dist + l * D + d;
    unsigned alive = all;
    for (int i = 0; i < R && alive; ++i) {
      const float fi = (float)i;
      const int row = row_d[i];
      const float il_f = (ls + rdl * fi - l_min) / l_step;
      unsigned hit = alive;
      if (!(row < 0 || il_f <= 0.0f || il_f >= fL)) {
        hit &= mask[row * L + cell_of(il_f, fL)];
      }
      if (hit) {
        const float di = fi * step;
        alive &= ~hit;
        do {
          dist_ld[(size_t)(__ffs(hit) - 1) * LD] = di;
          hit &= hit - 1;
        } while (hit);
      }
    }
  }
  __syncthreads();
  if (PROF && threadIdx.x == 0) clk[2] = clock64();

  // the group's rows (t, s): runs of L x D floats
  for (int t = 0; t < tg; ++t) {
    float* row = out + ((size_t)(g0 + t) * S + s) * LD;
    const float* src = dist + t * LD;
    for (int k = threadIdx.x; k < LD; k += blockDim.x) row[k] = src[k];
  }
  if (PROF) {
    __syncthreads();
    if (threadIdx.x == 0) {
      clk[3] = clock64();
      for (int p = 0; p < N_PHASE; ++p)
        atomicAdd(prof + p, (unsigned long long)(clk[p + 1] - clk[p]));
    }
  }
}

}  // namespace dir_dist

#ifdef __CUDACC__
namespace {

// the dynamic shared-memory limit of each instantiation, raised once per
// device and size (smem_limit.cuh)
smem_limit::Marks marks[2];

template <bool PROF>
int launch(const float* occ, const float* ray, float s_min, float s_step,
           float l_min, float l_step, float step, float* out,
           unsigned long long* prof, int T, int S, int L, int D,
           int ray_steps, void* stream) {
  using namespace dir_dist;
  if (T < 1 || S < 1 || L < 1 || D < 1 || ray_steps < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = dir_dist_kernel<PROF>;
  const size_t smem = smem_bytes(T, S, L, D, ray_steps);
  cudaError_t err = smem_limit::ensure(kernel, smem, marks[PROF]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, (T + GROUP - 1) / GROUP);
  kernel<<<grid, block_threads(L, D), smem, (cudaStream_t)stream>>>(
      occ, ray, s_min, s_step, l_min, l_step, step, out, prof, T, S, L, D,
      ray_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dir_dist_map_n_phases() { return dir_dist::N_PHASE; }

// The field (T, S, L, D) float32 from the occupancy (T, S, L), the ray
// table (D, 2) [ds, dl], the grid's origin and spacings, the sample
// spacing and the samples a ray takes.  A grid of S x ceil(T / 32) blocks.
extern "C" int dir_dist_map(const float* occ, const float* ray, float s_min,
                            float s_step, float l_min, float l_step,
                            float step, float* out, int T, int S, int L,
                            int D, int ray_steps, void* stream) {
  return launch<false>(occ, ray, s_min, s_step, l_min, l_step, step, out,
                       nullptr, T, S, L, D, ray_steps, stream);
}

// the profiling instantiation: the same field, and thread 0's clock64()
// cycles per phase (dir_dist::Phase) summed over the blocks, added into
// prof[N_PHASE]
extern "C" int dir_dist_map_profile(const float* occ, const float* ray,
                                    float s_min, float s_step, float l_min,
                                    float l_step, float step, float* out,
                                    unsigned long long* prof, int T, int S,
                                    int L, int D, int ray_steps,
                                    void* stream) {
  return launch<true>(occ, ray, s_min, s_step, l_min, l_step, step, out,
                      prof, T, S, L, D, ray_steps, stream);
}

// Loads both instantiations onto the current device and sets their
// shared-memory limits, so that the first field launches at once (the
// wrapper calls it when it binds the library).  Returns the CUDA error
// code.
extern "C" int dir_dist_map_prepare() {
  cudaError_t err =
      smem_limit::prepare(dir_dist::dir_dist_kernel<false>, marks[0]);
  if (err == cudaSuccess)
    err = smem_limit::prepare(dir_dist::dir_dist_kernel<true>, marks[1]);
  return (int)err;
}
#endif

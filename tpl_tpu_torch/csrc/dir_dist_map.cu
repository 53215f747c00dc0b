// The directional distance field of the graph DP planner, for Hopper
// (sm_90a).
//
// Replaces an XLA program of the JAX package (no Pallas kernel):
// tpl_tpu/planning/dyn_prog/dp_environment.py _dir_dist_map (:205-246).
// The reference is env.cu:160-214 updateDirDistMap.
//
// One block per (tile of S_TILE stations, time slice t): the block stages
// the slice's occupancy as bytes (occ > 0, S x L bytes: 4,221 at the demo
// grid) in shared memory, then each thread takes (s, l, d) cells of the
// tile, d fastest (consecutive threads write consecutive floats), and
// marches the ray from cell (s, l) in direction d: sample i sits at
// ss + ds * i, ls + dl * i (each operation rounded on its own; ds, dl from
// the host table, tpl_tpu_torch/planning/dyn_prog/dp_environment.py
// ray_table).  A sample blocks when its float indices (x - min) / step
// leave the open grid (<= 0 or >= n) or its cell trunc(clip(f, 0, n - 1))
// is occupied; the march stops there, and the distance is the sample's
// index times the spacing, or 10000 when none of the ray_steps samples
// blocks.  ray_steps is a launch argument.
//
// The operations and their order are the plain version's
// (dp_environment.dir_dist_reference), so the two agree cell for cell.
// Build with --fmad=false.

#include <cuda_runtime.h>
#include <stddef.h>

namespace dir_dist {

constexpr int THREADS = 256;
constexpr int S_TILE = 4;
constexpr float FREE_DIST = 10000.0f;

__host__ __device__ inline size_t smem_bytes(int S, int L) {
  return (size_t)S * L;
}

__global__ void __launch_bounds__(THREADS) dir_dist_kernel(
    const float* __restrict__ occ, const float* __restrict__ ray,
    float s_min, float s_step, float l_min, float l_step, float step,
    float* __restrict__ out, int S, int L, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* blocked = smem_raw;  // (S, L): the slice's occ > 0
  const int t = blockIdx.y;
  const float* occ_t = occ + (size_t)t * S * L;
  for (int c = threadIdx.x; c < S * L; c += blockDim.x)
    blocked[c] = occ_t[c] > 0.0f;
  __syncthreads();

  const int s0 = blockIdx.x * S_TILE;
  const int rows = S - s0 < S_TILE ? S - s0 : S_TILE;
  const int n = rows * L * D;
  const float fS = (float)S, fL = (float)L;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int d = k % D;
    const int l = (k / D) % L;
    const int s = s0 + k / (D * L);
    const float ss = s_min + (float)s * s_step;
    const float ls = l_min + (float)l * l_step;
    const float rds = ray[2 * d], rdl = ray[2 * d + 1];
    float dist = FREE_DIST;
    for (int i = 0; i < R; ++i) {
      const float fi = (float)i;
      const float is_f = (ss + rds * fi - s_min) / s_step;
      const float il_f = (ls + rdl * fi - l_min) / l_step;
      bool hit = is_f <= 0.0f || is_f >= fS || il_f <= 0.0f || il_f >= fL;
      if (!hit) {
        const int si = (int)fminf(fmaxf(is_f, 0.0f), fS - 1.0f);
        const int li = (int)fminf(fmaxf(il_f, 0.0f), fL - 1.0f);
        hit = blocked[si * L + li] != 0;
      }
      if (hit) {
        dist = fi * step;
        break;
      }
    }
    out[(((size_t)t * S + s) * L + l) * D + d] = dist;
  }
}

}  // namespace dir_dist

#ifdef __CUDACC__
// The field (T, S, L, D) float32 from the occupancy (T, S, L), the ray
// table (D, 2) [ds, dl], the grid's origin and spacings, the sample
// spacing and the samples a ray takes.
extern "C" int dir_dist_map(const float* occ, const float* ray, float s_min,
                            float s_step, float l_min, float l_step,
                            float step, float* out, int T, int S, int L,
                            int D, int ray_steps, void* stream) {
  using namespace dir_dist;
  if (T < 1 || S < 1 || L < 1 || D < 1 || ray_steps < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, L);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + S_TILE - 1) / S_TILE, T);
  dir_dist_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      occ, ray, s_min, s_step, l_min, l_step, step, out, S, L, D, ray_steps);
  return (int)cudaGetLastError();
}
#endif

// One level's whole plane-fit loop in one launch.
//
// Replaces patchwork_tpu/kernels/fit_pallas.py fit_level_megakernel ->
// _mega_kernel (399-514, wrapper 523-560): a moments sweep of the seeded
// mask (can = 0), then, while the mask changed and it < max_iter, a plane
// table (centroid, _plane_rows normal, can = gcnt >= 3) and an apply sweep
// (exact mode adds a centered-moment sweep per table; fast mode accumulates
// 12 rows and centers them with _centered_m2); the final can = 0 sweep runs
// only on a max_iter exit.  The generic level engine takes it through
// _fused_fit_resid (segment/engine.py) where the fit gate admits the level.
//
// Points use the fit layout p (B, 8, N) rows [x, y, z, tau, amask, seg, 0,
// 0] and a mask g (B, 1, N); stats (B, 8, Sp) rows [cnt, sx, sy, sz,
// distsum (old mask), changed, 0, 0].
//
// The TPU keeps the whole cloud in VMEM and sums with bf16x3 one-hot
// matmuls.  Here one block of PW_FIT_GROUPS x PW_TILE threads owns one scan
// and loops on the device, so a level's fit is one launch with no host read
// per iteration.  The points stay in device memory (the L2 holds a batch of
// packed scans); the per-node sums, the centered moments and the plane table
// live in shared memory.  Sums keep the sweeps' order: a tile of PW_TILE
// points is summed per node in point order, and tile partials are added to
// the running sums in tile order (PW_FIT_GROUPS tiles are staged at once;
// their partials are added group by group).  So the kernel equals
// fit_cuda.fit_level_plain bit for bit, and the fit equals the level path's
// on the same nodes.  What bounds it: one block per scan leaves most SMs idle
// at small batches, and each staged tile costs PW_TILE shared-memory passes
// of the threads that own its nodes.
#include "common.cuh"

#define PW_FIT_GROUPS 4
#define PW_FIT_THREADS (PW_FIT_GROUPS * PW_TILE)

// Add the staged tiles' per-node sums to acc (R, sp), tiles in order.  Group
// g of the block staged tile g of the step; `live` groups hold points.
template <int R>
__device__ __forceinline__ void pw_fit_accumulate(const float* vals,
                                                  const int* segs, float* acc,
                                                  int sp, int live) {
  int grp = threadIdx.x / PW_TILE, lane = threadIdx.x % PW_TILE;
  const float* V = vals + grp * R * PW_TILE;
  const int* Sg = segs + grp * PW_TILE;
  for (int base = 0; base < sp; base += PW_TILE) {
    int s = base + lane;
    bool mine = s < sp && grp < live;
    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = 0.f;
    if (mine) {
      for (int t = 0; t < PW_TILE; ++t) {
        if (Sg[t] == s) {
#pragma unroll
          for (int r = 0; r < R; ++r) a[r] += V[r * PW_TILE + t];
        }
      }
    }
    for (int g = 0; g < PW_FIT_GROUPS; ++g) {
      if (grp == g && mine) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r * sp + s] += a[r];
      }
      __syncthreads();
    }
  }
}

// Apply sweep with the plane table tab (7, sp) [cx, cy, cz, nx, ny, nz, can]
// (_mega_kernel's `sweep`, fit_pallas.py:405-443): re-threshold where
// amask * can, write the mask, sum the rows per node into acc (R, sp).
template <bool FAST>
__device__ void pw_fit_apply(const float* __restrict__ P, float* __restrict__ G,
                             const float* tab, float* vals, int* segs,
                             float* acc, int N, int sp) {
  constexpr int R = FAST ? 12 : 6;
  int grp = threadIdx.x / PW_TILE, lane = threadIdx.x % PW_TILE;
  for (int j = threadIdx.x; j < R * sp; j += blockDim.x) acc[j] = 0.f;
  for (int t0 = 0; t0 < N; t0 += PW_FIT_THREADS) {
    int live = min(PW_FIT_GROUPS, (N - t0) / PW_TILE);
    if (grp < live) {
      int i = t0 + threadIdx.x;
      float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
      float tau = P[3 * (size_t)N + i], am = P[4 * (size_t)N + i];
      int s = (int)P[5 * (size_t)N + i];
      float g = G[i];
      float dx = x - tab[s], dy = y - tab[sp + s], dz = z - tab[2 * sp + s];
      float dist = fabsf(dx * tab[3 * sp + s] + dy * tab[4 * sp + s] +
                         dz * tab[5 * sp + s]);
      float apply_m = am * tab[6 * sp + s];
      float new_g = dist < tau ? 1.f : 0.f;
      float g2 = apply_m * new_g + (1.f - apply_m) * g;
      G[i] = g2;
      float xg = x * g2, yg = y * g2, zg = z * g2;
      float* V = vals + grp * R * PW_TILE;
      V[lane] = g2;
      V[PW_TILE + lane] = xg;
      V[2 * PW_TILE + lane] = yg;
      V[3 * PW_TILE + lane] = zg;
      V[4 * PW_TILE + lane] = dist * g;
      V[5 * PW_TILE + lane] = apply_m * fabsf(new_g - g);
      if constexpr (FAST) {
        V[6 * PW_TILE + lane] = x * xg;
        V[7 * PW_TILE + lane] = y * xg;
        V[8 * PW_TILE + lane] = z * xg;
        V[9 * PW_TILE + lane] = y * yg;
        V[10 * PW_TILE + lane] = z * yg;
        V[11 * PW_TILE + lane] = z * zg;
      }
      segs[grp * PW_TILE + lane] = s;
    }
    __syncthreads();
    pw_fit_accumulate<R>(vals, segs, acc, sp, live);
  }
}

// Centered second moments of the mask about the centroids tab[0:3]
// (_mega_kernel's `m2_sweep`, fit_pallas.py:445-467) into acc (6, sp).
__device__ void pw_fit_m2(const float* __restrict__ P,
                          const float* __restrict__ G, const float* tab,
                          float* vals, int* segs, float* acc, int N, int sp) {
  int grp = threadIdx.x / PW_TILE, lane = threadIdx.x % PW_TILE;
  for (int j = threadIdx.x; j < 6 * sp; j += blockDim.x) acc[j] = 0.f;
  for (int t0 = 0; t0 < N; t0 += PW_FIT_THREADS) {
    int live = min(PW_FIT_GROUPS, (N - t0) / PW_TILE);
    if (grp < live) {
      int i = t0 + threadIdx.x;
      int s = (int)P[5 * (size_t)N + i];
      float g = G[i];
      float dx = (P[i] - tab[s]) * g;
      float dy = (P[(size_t)N + i] - tab[sp + s]) * g;
      float dz = (P[2 * (size_t)N + i] - tab[2 * sp + s]) * g;
      float* V = vals + grp * 6 * PW_TILE;
      V[lane] = dx * dx;
      V[PW_TILE + lane] = dx * dy;
      V[2 * PW_TILE + lane] = dx * dz;
      V[3 * PW_TILE + lane] = dy * dy;
      V[4 * PW_TILE + lane] = dy * dz;
      V[5 * PW_TILE + lane] = dz * dz;
      segs[grp * PW_TILE + lane] = s;
    }
    __syncthreads();
    pw_fit_accumulate<6>(vals, segs, acc, sp, live);
  }
}

// make_tab (fit_pallas.py:472-485): the plane table of the sums m1.
template <bool FAST>
__device__ void pw_fit_table(const float* __restrict__ P,
                             const float* __restrict__ G, const float* m1,
                             float* m2, float* tab, float* vals, int* segs,
                             int N, int sp, bool with_can) {
  for (int s = threadIdx.x; s < sp; s += blockDim.x) {
    float n = pw_clamp_lo(m1[s], 1.f);
    tab[s] = m1[sp + s] / n;
    tab[sp + s] = m1[2 * sp + s] / n;
    tab[2 * sp + s] = m1[3 * sp + s] / n;
  }
  __syncthreads();
  if constexpr (!FAST) pw_fit_m2(P, G, tab, vals, segs, m2, N, sp);
  for (int s = threadIdx.x; s < sp; s += blockDim.x) {
    float m[6];
    if constexpr (FAST) {
      pw_centered_m2(m1, sp, s, m);
    } else {
      for (int k = 0; k < 6; ++k) m[k] = m2[k * sp + s];
    }
    float gcnt = m1[s];
    pw_normal(m, gcnt, &tab[3 * sp + s], &tab[4 * sp + s], &tab[5 * sp + s]);
    tab[6 * sp + s] = (with_can && gcnt >= 3.f) ? 1.f : 0.f;
  }
  __syncthreads();
}

template <bool FAST>
__global__ void __launch_bounds__(PW_FIT_THREADS, 1)
    pw_fit_level_kernel(const float* __restrict__ p,
                        const float* __restrict__ g0, float* __restrict__ g,
                        float* __restrict__ stats, int N, int sp,
                        int max_iter) {
  constexpr int R = FAST ? 12 : 6;
  extern __shared__ float sh[];
  float* vals = sh;                                            // (G, R, TILE)
  int* segs = (int*)(vals + PW_FIT_GROUPS * R * PW_TILE);      // (G, TILE)
  float* m1 = (float*)(segs + PW_FIT_GROUPS * PW_TILE);        // (R, sp)
  float* m2 = m1 + R * sp;                                     // (6, sp) exact
  float* tab = m2 + (FAST ? 0 : 6 * sp);                       // (7, sp)
  int b = blockIdx.x;
  const float* P = p + (size_t)b * 8 * N;
  float* G = g + (size_t)b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) G[i] = g0[(size_t)b * N + i];
  for (int j = threadIdx.x; j < 7 * sp; j += blockDim.x) tab[j] = 0.f;
  __syncthreads();

  pw_fit_apply<FAST>(P, G, tab, vals, segs, m1, N, sp);  // seeded moments
  int changed = 1;
  for (int it = 0; changed && it < max_iter; ++it) {
    pw_fit_table<FAST>(P, G, m1, m2, tab, vals, segs, N, sp, true);
    pw_fit_apply<FAST>(P, G, tab, vals, segs, m1, N, sp);
    int any = 0;
    for (int s = threadIdx.x; s < sp; s += blockDim.x)
      any |= m1[5 * sp + s] > 0.f;
    changed = __syncthreads_or(any);
  }
  // final fit of the converged mask (can = 0): on a convergence exit its
  // sums are bitwise those of the last sweep, so only max_iter needs it
  if (changed) {
    pw_fit_table<FAST>(P, G, m1, m2, tab, vals, segs, N, sp, false);
    pw_fit_apply<FAST>(P, G, tab, vals, segs, m1, N, sp);
  }
  float* O = stats + (size_t)b * 8 * sp;
  for (int j = threadIdx.x; j < 8 * sp; j += blockDim.x)
    O[j] = j < 6 * sp ? m1[j] : 0.f;
}

template <bool FAST>
static int pw_fit_level_launch(const float* p, const float* g0, float* g,
                               float* stats, int B, int N, int sp,
                               int max_iter, cudaStream_t st) {
  constexpr int R = FAST ? 12 : 6;
  int floats = PW_FIT_GROUPS * R * PW_TILE + PW_FIT_GROUPS * PW_TILE +
               R * sp + (FAST ? 0 : 6 * sp) + 7 * sp;
  int smem = floats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pw_fit_level_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  pw_fit_level_kernel<FAST><<<B, PW_FIT_THREADS, smem, st>>>(
      p, g0, g, stats, N, sp, max_iter);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_fit_level(const float* p, const float* g0, float* g,
                           float* stats, int B, int N, int sp, int max_iter,
                           int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return fast ? pw_fit_level_launch<true>(p, g0, g, stats, B, N, sp,
                                          max_iter, st)
              : pw_fit_level_launch<false>(p, g0, g, stats, B, N, sp,
                                           max_iter, st);
}

// One engine level as a short sequence of kernels, driven from Python
// (segment/engine.py _level) around the sweeps of sweeps.cu and the order
// statistic of orderstat.cu.
//
// Replaces patchwork_tpu/kernels/fit_pallas.py level_megakernel ->
// _level_kernel (789-1462, wrapper 1465-1558): the remap prologue R1-R5
// (856-1010), node stats (1012-1054), early-outs (1104-1118), the deficient
// "3 lowest-z" fallback (1120-1193), seed init fused with the first sweep
// (1371-1409), the plane table of every fit iteration (_plane_rows,
// 311-377; make_tab, 1357-1369), the split decision (1427-1439) and the
// finishing of non-split nodes (1441-1462).
//
// The TPU runs the whole level as one launch over a VMEM-resident cloud.
// Here the cloud stays in device memory and each phase is one kernel:
// per-point kernels are one pass over the packed points each and bound by
// memory bandwidth; per-node kernels run one thread per node (the remap
// prefix one thread per scan) and are bound by launch latency.  Min, max
// and counts use integer atomics on order-preserving keys, exact in any
// order; sums use the fixed-order tile scheme.  The TPU's dirty-tile
// caches and live-tile skip are left out: every sweep is dense.
#include "common.cuh"

#include <limits.h>

#define PW_STATS_CHUNK 4096
#define PW_BIG 3.0e38f

static inline dim3 pw_point_grid(int N, int B) {
  return dim3((N + 255) / 256, B);
}

// ---------------------------------------------------------------------------
// R1: per-parent sums [cnt, sx, sy] (+ raw [xx, yy] in fast mode)
// ---------------------------------------------------------------------------
template <bool FAST>
__global__ void pw_r1_partials(const float* __restrict__ pts,
                               float* __restrict__ partial, int N, int sp,
                               int trash) {
  constexpr int R = FAST ? 5 : 3;
  __shared__ float vals[R][PW_TILE];
  __shared__ int segs[PW_TILE];
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  float x = P[i], y = P[(size_t)N + i];
  float pseg = P[3 * (size_t)N + i];
  float a = pseg < (float)trash ? 1.f : 0.f;
  float xa = x * a, ya = y * a;
  vals[0][t] = a;
  vals[1][t] = xa;
  vals[2][t] = ya;
  if constexpr (FAST) {
    vals[3][t] = x * xa;
    vals[4][t] = y * ya;
  }
  segs[t] = (int)pseg;
  __syncthreads();
  pw_tile_accumulate<R>(vals, segs, sp,
                        partial + ((size_t)b * nt + tile) * R * sp);
}

// R1, exact mode's second pass: centered [sum dx^2, sum dy^2] per parent.
__global__ void pw_r1b_partials(const float* __restrict__ pts,
                                const float* __restrict__ cxy,
                                float* __restrict__ partial, int N, int sp,
                                int trash) {
  __shared__ float vals[2][PW_TILE];
  __shared__ int segs[PW_TILE];
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  const float* C = cxy + (size_t)b * 2 * sp;
  float pseg = P[3 * (size_t)N + i];
  int s = (int)pseg;
  float a = pseg < (float)trash ? 1.f : 0.f;
  float dx = (P[i] - C[s]) * a;
  float dy = (P[(size_t)N + i] - C[sp + s]) * a;
  vals[0][t] = dx * dx;
  vals[1][t] = dy * dy;
  segs[t] = s;
  __syncthreads();
  pw_tile_accumulate<2>(vals, segs, sp,
                        partial + ((size_t)b * nt + tile) * 2 * sp);
}

// ---------------------------------------------------------------------------
// R3 + R4: compact child slots and inherited tau/zth, one thread per scan
// ---------------------------------------------------------------------------
__global__ void pw_remap_nodes_kernel(const float* __restrict__ tables,
                                      const float* __restrict__ median,
                                      const float* __restrict__ axis,
                                      float* __restrict__ pnode,
                                      float* __restrict__ tz, int sp,
                                      int trash) {
  if (threadIdx.x != 0) return;
  int b = blockIdx.x;
  const float* T = tables + (size_t)b * 8 * sp;
  const float* M = median + (size_t)b * sp;
  const float* A = axis + (size_t)b * sp;
  float* Q = pnode + (size_t)b * 4 * sp;
  float* Z = tz + (size_t)b * 2 * sp;
  for (int s = 0; s < 2 * sp; ++s) Z[s] = 0.f;
  float rank = 0.f;  // #{earlier split parents}
  for (int j = 0; j < sp; ++j) {
    float split = T[6 * sp + j];
    float base = 2.f * rank;
    float ok = split * ((base + 1.f) < (float)trash ? 1.f : 0.f);
    Q[j] = M[j];
    Q[sp + j] = ok;
    Q[2 * sp + j] = base;
    Q[3 * sp + j] = A[j];
    if (ok > 0.5f) {
      int d = (int)base;
      Z[d] = T[j];
      Z[d + 1] = T[j];
      Z[sp + d] = T[sp + j];
      Z[sp + d + 1] = T[sp + j];
    }
    rank += split;
  }
}

// R5: move each live point to its parent's left/right child slot.
__global__ void pw_remap_points_kernel(const float* __restrict__ pts,
                                       float* __restrict__ state,
                                       const float* __restrict__ pnode, int N,
                                       int sp, int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int b = blockIdx.y;
  const float* P = pts + (size_t)b * 8 * N;
  float* S = state + (size_t)b * 4 * N;
  const float* Q = pnode + (size_t)b * 4 * sp;
  float pseg = P[3 * (size_t)N + i];
  int s = (int)pseg;
  float tr = (float)trash;
  float a = pseg < tr ? 1.f : 0.f;
  float med = Q[s], okg = Q[sp + s], slot = Q[2 * sp + s], ax = Q[3 * sp + s];
  float v = ax * P[i] + (1.f - ax) * P[(size_t)N + i];
  float gr = v > med ? 1.f : 0.f;
  float newseg = okg * (slot + gr) + (1.f - okg) * tr;
  S[3 * (size_t)N + i] = a * newseg + (1.f - a) * tr;
  S[(size_t)N + i] = fmaxf(S[(size_t)N + i], a * (1.f - okg));
}

// ---------------------------------------------------------------------------
// phase 1: node stats [cnt, seed_cnt, xmin, ymin, zmin, xmax, ymax, zmax]
// ---------------------------------------------------------------------------
__device__ __forceinline__ int pw_stats_init_value(int row) {
  return row < 2 ? 0 : (row < 5 ? PW_KEY_POS_INF : PW_KEY_NEG_INF);
}

__global__ void pw_stats_init(int* __restrict__ work, int n, int sp) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) work[idx] = pw_stats_init_value((idx / sp) % 8);
}

__global__ void pw_stats_points(const float* __restrict__ pts,
                                const float* __restrict__ state,
                                const float* __restrict__ zth,
                                int* __restrict__ work, int N, int sp,
                                int trash) {
  extern __shared__ int sh[];  // (8, sp)
  for (int j = threadIdx.x; j < 8 * sp; j += blockDim.x)
    sh[j] = pw_stats_init_value(j / sp);
  __syncthreads();
  int b = blockIdx.y;
  const float* P = pts + (size_t)b * 8 * N;
  const float* S = state + (size_t)b * 4 * N;
  const float* Zt = zth ? zth + (size_t)b * sp : nullptr;
  int start = blockIdx.x * PW_STATS_CHUNK;
  int end = min(start + PW_STATS_CHUNK, N);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    float segf = S[3 * (size_t)N + i];
    if (!(segf < (float)trash)) continue;
    int s = (int)segf;
    float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
    atomicAdd(&sh[s], 1);
    if (Zt && z < Zt[s]) atomicAdd(&sh[sp + s], 1);
    int kx = pw_f32_key(x), ky = pw_f32_key(y), kz = pw_f32_key(z);
    atomicMin(&sh[2 * sp + s], kx);
    atomicMin(&sh[3 * sp + s], ky);
    atomicMin(&sh[4 * sp + s], kz);
    atomicMax(&sh[5 * sp + s], kx);
    atomicMax(&sh[6 * sp + s], ky);
    atomicMax(&sh[7 * sp + s], kz);
  }
  __syncthreads();
  int* W = work + (size_t)b * 8 * sp;
  for (int s = threadIdx.x; s < sp; s += blockDim.x) {
    if (sh[s] == 0) continue;
    atomicAdd(&W[s], sh[s]);
    atomicAdd(&W[sp + s], sh[sp + s]);
    for (int r = 2; r < 5; ++r) atomicMin(&W[r * sp + s], sh[r * sp + s]);
    for (int r = 5; r < 8; ++r) atomicMax(&W[r * sp + s], sh[r * sp + s]);
  }
}

__global__ void pw_stats_finish(const int* __restrict__ work,
                                float* __restrict__ out, int n, int sp) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int row = (idx / sp) % 8;
  out[idx] = row < 2 ? (float)work[idx] : pw_key_f32(work[idx]);
}

// ---------------------------------------------------------------------------
// phase 2: early-outs in the reference's order (cpp:111-140)
// ---------------------------------------------------------------------------
__global__ void pw_early_outs_kernel(const float* __restrict__ nstats,
                                     const float* __restrict__ tables,
                                     const float* __restrict__ zth,
                                     float* __restrict__ flags,
                                     int* __restrict__ any_def, int B, int sp,
                                     int is_level0, float flat_area,
                                     float flat_dz, int flat_minpts,
                                     int min_seed) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * sp) return;
  int b = idx / sp, s = idx % sp;
  const float* NS = nstats + (size_t)b * 8 * sp;
  const float* T = tables + (size_t)b * 8 * sp;
  float* F = flags + (size_t)b * 5 * sp;
  float cnt = NS[s], seed = NS[sp + s];
  float xmin = NS[2 * sp + s], ymin = NS[3 * sp + s], zmin = NS[4 * sp + s];
  float xmax = NS[5 * sp + s], ymax = NS[6 * sp + s], zmax = NS[7 * sp + s];
  bool real = T[2 * sp + s] > 0.5f;
  bool too_small = cnt < 3.f;
  float area = (xmax - xmin) * (ymax - ymin);
  bool flat_a = is_level0 ? false : ((area < flat_area) && !too_small);
  bool flat_z = ((zmax - zmin) < flat_dz) && (cnt > (float)flat_minpts) &&
                !too_small && !flat_a;
  bool finished = real && (too_small || flat_a || flat_z);
  bool fit = real && !finished;
  bool def = fit && (seed < (float)min_seed);
  F[s] = finished ? 1.f : 0.f;
  F[sp + s] = (flat_a || flat_z) ? 1.f : 0.f;
  F[2 * sp + s] = fit ? 1.f : 0.f;
  F[3 * sp + s] = def ? 1.f : 0.f;
  F[4 * sp + s] = zth[(size_t)b * sp + s];
  if (def) atomicOr(&any_def[b], 1);
}

// ---------------------------------------------------------------------------
// phase 3: one round of the deficient-node "lowest-z" pick (cpp:171-182)
// ---------------------------------------------------------------------------
__global__ void pw_def_init(int* __restrict__ zmin, int* __restrict__ imin,
                            int n) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  zmin[idx] = PW_KEY_POS_INF;
  imin[idx] = INT_MAX;
}

// Candidate: live, of a deficient node, not chosen yet.  Returns the node.
__device__ __forceinline__ int pw_def_cand(const float* P, const float* S,
                                           const float* F, size_t N, int i,
                                           int sp, int trash) {
  float segf = S[3 * N + i];
  if (!(segf < (float)trash)) return -1;
  int s = (int)segf;
  if (!(F[3 * sp + s] > 0.5f) || !(S[2 * N + i] < 0.5f)) return -1;
  return s;
}

__device__ __forceinline__ float pw_min_z(const int* zmin, int s) {
  float m = pw_key_f32(zmin[s]);
  return isfinite(m) ? m : PW_BIG;
}

__global__ void pw_def_min(const float* __restrict__ pts,
                           const float* __restrict__ state,
                           const float* __restrict__ flags,
                           const int* __restrict__ any_def,
                           int* __restrict__ zmin, int N, int sp, int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int b = blockIdx.y;
  if (i >= N || !any_def[b]) return;
  const float* P = pts + (size_t)b * 8 * N;
  int s = pw_def_cand(P, state + (size_t)b * 4 * N, flags + (size_t)b * 5 * sp,
                      N, i, sp, trash);
  if (s < 0) return;
  atomicMin(&zmin[(size_t)b * sp + s], pw_f32_key(P[2 * (size_t)N + i]));
}

__global__ void pw_def_imin(const float* __restrict__ pts,
                            const float* __restrict__ state,
                            const float* __restrict__ flags,
                            const int* __restrict__ any_def,
                            const int* __restrict__ zmin,
                            int* __restrict__ imin, int N, int sp, int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int b = blockIdx.y;
  if (i >= N || !any_def[b]) return;
  const float* P = pts + (size_t)b * 8 * N;
  int s = pw_def_cand(P, state + (size_t)b * 4 * N, flags + (size_t)b * 5 * sp,
                      N, i, sp, trash);
  if (s < 0) return;
  if (P[2 * (size_t)N + i] == pw_min_z(zmin + (size_t)b * sp, s))
    atomicMin(&imin[(size_t)b * sp + s], (int)P[6 * (size_t)N + i]);
}

__global__ void pw_def_pick(const float* __restrict__ pts,
                            float* __restrict__ state,
                            const float* __restrict__ flags,
                            const int* __restrict__ any_def,
                            const int* __restrict__ zmin,
                            const int* __restrict__ imin, int N, int sp,
                            int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int b = blockIdx.y;
  if (i >= N || !any_def[b]) return;
  const float* P = pts + (size_t)b * 8 * N;
  float* S = state + (size_t)b * 4 * N;
  int s = pw_def_cand(P, S, flags + (size_t)b * 5 * sp, N, i, sp, trash);
  if (s < 0) return;
  int mi = imin[(size_t)b * sp + s];
  float mi_f = mi == INT_MAX ? PW_BIG : (float)mi;
  if (P[2 * (size_t)N + i] == pw_min_z(zmin + (size_t)b * sp, s) &&
      P[6 * (size_t)N + i] == mi_f)
    S[2 * (size_t)N + i] = 1.f;
}

// ---------------------------------------------------------------------------
// phase 4: early-out labels + seed init, fused with the first moment sweep
// ---------------------------------------------------------------------------
template <bool FAST>
__global__ void pw_seed_partials(const float* __restrict__ pts,
                                 float* __restrict__ state,
                                 const float* __restrict__ flags,
                                 float* __restrict__ partial, int N, int sp,
                                 int trash) {
  constexpr int R = FAST ? 12 : 6;
  __shared__ float vals[R][PW_TILE];
  __shared__ int segs[PW_TILE];
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  float* S = state + (size_t)b * 4 * N;
  const float* F = flags + (size_t)b * 5 * sp;
  float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
  float segf = S[3 * (size_t)N + i];
  int s = (int)segf;
  float act = segf < (float)trash ? 1.f : 0.f;
  float fin = F[s], lab = F[sp + s], fit = F[2 * sp + s];
  float def = F[3 * sp + s], zth = F[4 * sp + s];
  float seed = act * (z < zth ? 1.f : 0.f);
  float chosen = S[2 * (size_t)N + i];
  seed = (def * chosen + (1.f - def) * seed) * act;
  float g = S[i];
  float w_fin = act * fin;
  g = w_fin * lab + (1.f - w_fin) * g;
  float w_fit = act * fit;
  g = w_fit * seed + (1.f - w_fit) * g;
  S[i] = g;
  S[(size_t)N + i] = fmaxf(S[(size_t)N + i], w_fin);
  float gm = g * act;
  float xg = x * gm, yg = y * gm, zg = z * gm;
  vals[0][t] = gm;
  vals[1][t] = xg;
  vals[2][t] = yg;
  vals[3][t] = zg;
  vals[4][t] = 0.f;
  vals[5][t] = 0.f;
  if constexpr (FAST) {
    vals[6][t] = x * xg;
    vals[7][t] = y * xg;
    vals[8][t] = z * xg;
    vals[9][t] = y * yg;
    vals[10][t] = z * yg;
    vals[11][t] = z * zg;
  }
  segs[t] = s;
  __syncthreads();
  pw_tile_accumulate<R>(vals, segs, sp,
                        partial + ((size_t)b * nt + tile) * R * sp);
}

// ---------------------------------------------------------------------------
// per-node plane table (make_tab, fit_pallas.py:1357-1369)
// ---------------------------------------------------------------------------
__global__ void pw_plane_table_kernel(const float* __restrict__ m1,
                                      const float* __restrict__ c,
                                      const float* __restrict__ m2,
                                      const float* __restrict__ fit,
                                      const float* __restrict__ tau,
                                      float* __restrict__ tab, int B, int sp,
                                      int R, int fast) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * sp) return;
  int b = idx / sp, s = idx % sp;
  const float* M1 = m1 + (size_t)b * R * sp;
  const float* C = c + (size_t)b * 3 * sp;
  float gcnt = M1[s];
  float m[6];
  if (fast) {
    pw_centered_m2(M1, sp, s, m);
  } else {
    const float* M2 = m2 + (size_t)b * 6 * sp;
    for (int k = 0; k < 6; ++k) m[k] = M2[k * sp + s];
  }
  float nx, ny, nz;
  pw_normal(m, gcnt, &nx, &ny, &nz);
  float can = fit ? fit[(size_t)b * sp + s] * (gcnt >= 3.f ? 1.f : 0.f) : 0.f;
  float* Tb = tab + (size_t)b * 8 * sp;
  Tb[s] = C[s];
  Tb[sp + s] = C[sp + s];
  Tb[2 * sp + s] = C[2 * sp + s];
  Tb[3 * sp + s] = nx;
  Tb[4 * sp + s] = ny;
  Tb[5 * sp + s] = nz;
  Tb[6 * sp + s] = can;
  Tb[7 * sp + s] = tau[(size_t)b * sp + s];
}

// ---------------------------------------------------------------------------
// phase 6: residual + split decision; phase 7: finish non-split nodes
// ---------------------------------------------------------------------------
__global__ void pw_split_kernel(const float* __restrict__ sf,
                                const float* __restrict__ nstats,
                                const float* __restrict__ flags,
                                const float* __restrict__ tables,
                                float* __restrict__ out, int B, int sp,
                                int R) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * sp) return;
  int b = idx / sp, s = idx % sp;
  const float* SF = sf + (size_t)b * R * sp;
  const float* T = tables + (size_t)b * 8 * sp;
  float gcnt = SF[s];
  float resid = SF[4 * sp + s] / pw_clamp_lo(gcnt, 1.f);
  if (!(gcnt >= 3.f)) resid = INFINITY;
  bool split = flags[((size_t)b * 5 + 2) * sp + s] > 0.5f &&
               resid > T[3 * sp + s] &&
               nstats[(size_t)b * 8 * sp + s] >= T[4 * sp + s] &&
               T[5 * sp + s] > 0.5f;
  float* O = out + (size_t)b * 3 * sp;
  O[s] = split ? 1.f : 0.f;
  O[sp + s] = gcnt;
  O[2 * sp + s] = resid;
}

__global__ void pw_finish_kernel(float* __restrict__ state,
                                 const float* __restrict__ flags,
                                 const float* __restrict__ sd, int N, int sp,
                                 int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int b = blockIdx.y;
  float* S = state + (size_t)b * 4 * N;
  float segf = S[3 * (size_t)N + i];
  if (!(segf < (float)trash)) return;
  int s = (int)segf;
  if (flags[((size_t)b * 5 + 2) * sp + s] > 0.5f &&
      sd[(size_t)b * 3 * sp + s] < 0.5f)
    S[(size_t)N + i] = 1.f;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
PW_EXPORT int pw_remap_r1(const float* pts, float* partial, float* out, int B,
                          int N, int sp, int trash, int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  if (fast)
    pw_r1_partials<true><<<grid, PW_TILE, 0, st>>>(pts, partial, N, sp, trash);
  else
    pw_r1_partials<false><<<grid, PW_TILE, 0, st>>>(pts, partial, N, sp, trash);
  pw_reduce_tiles(partial, out, B, N / PW_TILE, fast ? 5 : 3, sp, st);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_remap_r1b(const float* pts, const float* cxy, float* partial,
                           float* out, int B, int N, int sp, int trash,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  pw_r1b_partials<<<grid, PW_TILE, 0, st>>>(pts, cxy, partial, N, sp, trash);
  pw_reduce_tiles(partial, out, B, N / PW_TILE, 2, sp, st);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_remap_nodes(const float* tables, const float* median,
                             const float* axis, float* pnode, float* tz, int B,
                             int sp, int trash, void* stream) {
  pw_remap_nodes_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      tables, median, axis, pnode, tz, sp, trash);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_remap_points(const float* pts, float* state,
                              const float* pnode, int B, int N, int sp,
                              int trash, void* stream) {
  pw_remap_points_kernel<<<pw_point_grid(N, B), 256, 0,
                           (cudaStream_t)stream>>>(pts, state, pnode, N, sp,
                                                   trash);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_node_stats(const float* pts, const float* state,
                            const float* zth, int* work, float* out, int B,
                            int N, int sp, int trash, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int n = B * 8 * sp;
  int smem = 8 * sp * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      pw_stats_points, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  pw_stats_init<<<(n + 255) / 256, 256, 0, st>>>(work, n, sp);
  dim3 grid((N + PW_STATS_CHUNK - 1) / PW_STATS_CHUNK, B);
  pw_stats_points<<<grid, 256, smem, st>>>(pts, state, zth, work, N, sp,
                                           trash);
  pw_stats_finish<<<(n + 255) / 256, 256, 0, st>>>(work, out, n, sp);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_early_outs(const float* nstats, const float* tables,
                            const float* zth, float* flags, int* any_def,
                            int B, int sp, int is_level0, float flat_area,
                            float flat_dz, int flat_minpts, int min_seed,
                            void* stream) {
  pw_early_outs_kernel<<<(B * sp + 127) / 128, 128, 0,
                         (cudaStream_t)stream>>>(
      nstats, tables, zth, flags, any_def, B, sp, is_level0, flat_area,
      flat_dz, flat_minpts, min_seed);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_deficient_round(const float* pts, float* state,
                                 const float* flags, const int* any_def,
                                 int* zmin, int* imin, int B, int N, int sp,
                                 int trash, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int n = B * sp;
  dim3 grid = pw_point_grid(N, B);
  pw_def_init<<<(n + 127) / 128, 128, 0, st>>>(zmin, imin, n);
  pw_def_min<<<grid, 256, 0, st>>>(pts, state, flags, any_def, zmin, N, sp,
                                   trash);
  pw_def_imin<<<grid, 256, 0, st>>>(pts, state, flags, any_def, zmin, imin, N,
                                    sp, trash);
  pw_def_pick<<<grid, 256, 0, st>>>(pts, state, flags, any_def, zmin, imin, N,
                                    sp, trash);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_seed_init(const float* pts, float* state, const float* flags,
                           float* partial, float* out, int B, int N, int sp,
                           int trash, int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  if (fast)
    pw_seed_partials<true><<<grid, PW_TILE, 0, st>>>(pts, state, flags,
                                                     partial, N, sp, trash);
  else
    pw_seed_partials<false><<<grid, PW_TILE, 0, st>>>(pts, state, flags,
                                                      partial, N, sp, trash);
  pw_reduce_tiles(partial, out, B, N / PW_TILE, fast ? 12 : 6, sp, st);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_plane_table(const float* m1, const float* c, const float* m2,
                             const float* fit, const float* tau, float* tab,
                             int B, int sp, int R, int fast, void* stream) {
  pw_plane_table_kernel<<<(B * sp + 127) / 128, 128, 0,
                          (cudaStream_t)stream>>>(m1, c, m2, fit, tau, tab, B,
                                                  sp, R, fast);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_split_decision(const float* sf, const float* nstats,
                                const float* flags, const float* tables,
                                float* out, int B, int sp, int R,
                                void* stream) {
  pw_split_kernel<<<(B * sp + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      sf, nstats, flags, tables, out, B, sp, R);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_finish_nodes(float* state, const float* flags,
                              const float* sd, int B, int N, int sp, int trash,
                              void* stream) {
  pw_finish_kernel<<<pw_point_grid(N, B), 256, 0, (cudaStream_t)stream>>>(
      state, flags, sd, N, sp, trash);
  return (int)cudaGetLastError();
}

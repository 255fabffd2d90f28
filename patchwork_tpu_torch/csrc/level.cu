// One engine level's phases as kernels of their own, and the remap's
// per-parent sums.
//
// Replaces patchwork_tpu/kernels/fit_pallas.py level_megakernel ->
// _level_kernel (789-1462, wrapper 1465-1558), with the level layout of
// pw_fit_level_kernel (fitloop.cu): the remap prologue R1-R5 (856-1010),
// node stats (1012-1054), early-outs (1104-1118), the deficient "3
// lowest-z" fallback (1120-1193), seed init fused with the first sweep
// (1371-1409), the plane table of every fit iteration (_plane_rows,
// 311-377; make_tab, 1357-1369), the split decision (1427-1439) and the
// finishing of non-split nodes (1441-1462).
//
// The TPU runs the whole level as one launch over a VMEM-resident cloud;
// so does the card, in one co-operative launch (pw_level_core), wherever
// a block holds the node table in shared memory.  The kernels here are the
// same phases one launch each, with the same device code (level.cuh): they
// run where that launch cannot hold the table (Sp above ~2700), around the
// loop of sweeps (fit_cuda.level_sequence), and, for percentile seeds, the
// node stats and (on remap levels) R3-R5 ahead of the one launch.
// Per-point kernels are one pass over the packed points and bound by
// memory; per-node kernels one thread per node, bound by launch latency.
//
// R1 and R1b sum over the parent ids, new on every call and used once.
// Each is one launch with pw_seg_sum's device code (pw_dense_sum_tile,
// tile_sums.cuh): a block finds its tile's runs in shared memory, writes
// each present parent's partial and the scan's last block adds them in tile
// order.  A plan built for the call was measured slower for such ids
// (PERF.md, the no-binding segment sum).  The seed sums above the card's
// gate add over the level's sweep plan, as the apply sweep does.
#include "level.cuh"

#define PW_STATS_CHUNK 4096

static inline dim3 pw_point_grid(int N, int B) {
  return dim3((N + 255) / 256, B);
}

// ---------------------------------------------------------------------------
// R1 (fit_pallas.py:885-903): per-parent sums [cnt, sx, sy] (+ raw [xx, yy]
// in fast mode) of the live points; parent id = pts row 3
// ---------------------------------------------------------------------------
template <bool FAST>
__global__ void __launch_bounds__(PW_TILE)
    pw_r1_kernel(const float* __restrict__ pts, float* partial, unsigned* ws,
                 float* __restrict__ out, int N, int sp, int trash) {
  constexpr int R = FAST ? 5 : 3;
  __shared__ PwDenseSmem<R> sm;
  extern __shared__ int ids[];
  size_t i = (size_t)blockIdx.x * PW_TILE + threadIdx.x;
  const float* P = pts + (size_t)blockIdx.y * 8 * N;
  float x = P[i], y = P[(size_t)N + i];
  float pseg = P[3 * (size_t)N + i];
  float a = pseg < (float)trash ? 1.f : 0.f;
  float xa = x * a, ya = y * a;
  float v[R];
  v[0] = a;
  v[1] = xa;
  v[2] = ya;
  if constexpr (FAST) {
    v[3] = x * xa;
    v[4] = y * ya;
  }
  pw_dense_sum_tile<R>(sm, ids, v, (int)pseg, partial, ws, out, sp);
}

// R1, exact mode's second pass (fit_pallas.py:910-928): centered [sum dx^2,
// sum dy^2] per parent about the parent centroids cxy (B, 2, sp).
__global__ void __launch_bounds__(PW_TILE)
    pw_r1b_kernel(const float* __restrict__ pts,
                  const float* __restrict__ cxy, float* partial, unsigned* ws,
                  float* __restrict__ out, int N, int sp, int trash) {
  __shared__ PwDenseSmem<2> sm;
  extern __shared__ int ids[];
  int b = blockIdx.y;
  size_t i = (size_t)blockIdx.x * PW_TILE + threadIdx.x;
  const float* P = pts + (size_t)b * 8 * N;
  const float* C = cxy + (size_t)b * 2 * sp;
  float pseg = P[3 * (size_t)N + i];
  int s = (int)pseg;
  float a = pseg < (float)trash ? 1.f : 0.f;
  float dx = (P[i] - C[s]) * a;
  float dy = (P[(size_t)N + i] - C[sp + s]) * a;
  float v[2] = {dx * dx, dy * dy};
  pw_dense_sum_tile<2>(sm, ids, v, s, partial, ws, out, sp);
}

// ---------------------------------------------------------------------------
// R3 + R4, one block per scan; R5, a thread per point
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(PW_TILE)
    pw_remap_nodes_kernel(const float* __restrict__ tables,
                          const float* __restrict__ median,
                          const float* __restrict__ axis,
                          float* __restrict__ pnode, float* __restrict__ tz,
                          int sp, int trash) {
  __shared__ int ws[33];
  size_t b = blockIdx.x;
  pw_remap_nodes_block(tables + b * 8 * sp, median + b * sp, axis + b * sp,
                       pnode + b * 4 * sp, tz + b * 2 * sp, sp, trash, ws);
}

__global__ void pw_remap_points_kernel(const float* __restrict__ pts,
                                       float* __restrict__ state,
                                       const float* __restrict__ pnode, int N,
                                       int sp, int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  size_t b = blockIdx.y;
  pw_remap_point(pts + b * 8 * N, state + b * 4 * N, pnode + b * 4 * sp, N,
                 i, sp, trash);
}

// ---------------------------------------------------------------------------
// node stats: a block's chunk into a shared table, merged into the scan's
// zeroed table, then the floats
// ---------------------------------------------------------------------------
__global__ void pw_stats_points(const float* __restrict__ pts,
                                const float* __restrict__ state,
                                const float* __restrict__ zth,
                                unsigned* __restrict__ work, int N, int sp,
                                int trash) {
  extern __shared__ unsigned sh[];  // (8, sp)
  for (int j = threadIdx.x; j < 8 * sp; j += blockDim.x) sh[j] = 0u;
  __syncthreads();
  size_t b = blockIdx.y;
  const float* P = pts + b * 8 * N;
  const float* S = state + b * 4 * N;
  const float* Zt = zth ? zth + b * sp : nullptr;
  int start = blockIdx.x * PW_STATS_CHUNK;
  int end = min(start + PW_STATS_CHUNK, N);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x)
    pw_stats_point(P, S, Zt, sh, N, i, sp, trash);
  __syncthreads();
  pw_stats_merge(sh, work + b * 8 * sp, sp);
}

__global__ void pw_stats_finish(const unsigned* __restrict__ work,
                                float* __restrict__ out, int n, int sp) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int s = idx % sp, r = (idx / sp) % 8;
  out[idx] = pw_stats_value(work + (size_t)(idx / (8 * sp)) * 8 * sp, sp, r,
                            s);
}

// ---------------------------------------------------------------------------
// early-outs, one thread per node
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
  float v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = NS[r * sp + s];
  if (pw_early_out_node(v, tables[((size_t)b * 8 + 2) * sp + s],
                        zth[(size_t)b * sp + s], flags + (size_t)b * 5 * sp,
                        sp, s, is_level0, flat_area, flat_dz, flat_minpts,
                        min_seed))
    atomicOr(&any_def[b], 1);
}

// ---------------------------------------------------------------------------
// one deficient round: its three steps, a thread per point; D (B, 2, sp)
// ---------------------------------------------------------------------------
template <int STEP>
__global__ void pw_def_step(const float* __restrict__ pts,
                            float* __restrict__ state,
                            const float* __restrict__ flags,
                            const int* __restrict__ any_def,
                            unsigned* __restrict__ D, int N, int sp,
                            int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  size_t b = blockIdx.y;
  if (i >= N || !any_def[b]) return;
  const float* P = pts + b * 8 * N;
  float* S = state + b * 4 * N;
  const float* F = flags + b * 5 * sp;
  unsigned* Db = D + b * 2 * sp;
  if (STEP == 0) pw_def_min_point(P, S, F, Db, N, i, sp, trash);
  if (STEP == 1) pw_def_imin_point(P, S, F, Db, N, i, sp, trash);
  if (STEP == 2) pw_def_pick_point(P, S, F, Db, N, i, sp, trash);
}

// ---------------------------------------------------------------------------
// labels, seeds and the first sums over the level's sweep plan, one tile of
// one scan per block (the apply sweep's scheme, sweeps.cu)
// ---------------------------------------------------------------------------
template <bool FAST>
__global__ void __launch_bounds__(PW_TILE)
    pw_seed_kernel(const float* __restrict__ pts, float* __restrict__ state,
                   const float* __restrict__ flags, PwPlan plan,
                   float* partial, float* __restrict__ out, int* done, int N,
                   int sp, int cap, int trash) {
  constexpr int R = FAST ? 12 : 6;
  __shared__ float vals[R * PW_TILE];
  __shared__ int sstart[PW_TILE + 1];
  __shared__ int sdest[PW_TILE];
  __shared__ int full[PW_TILE];
  __shared__ int nfull;
  size_t b = blockIdx.y;
  int tile = blockIdx.x;
  size_t i = (size_t)tile * PW_TILE + threadIdx.x;
  PwPlan pl = pw_plan_scan_of(plan, b, N, sp, cap);
  float* part = partial + b * cap * R;
  int K = pw_tile_runs(tile, pl, sstart, sdest);
  float v[R];
  pw_seed_point<FAST>(pts + b * 8 * N, state + b * 4 * N, flags + b * 5 * sp,
                      N, i, sp, trash, v);
  pw_tile_compact_sums<R>(vals, sstart, sdest, v, (int)pl.pos[i], K, part);
  pw_tile_finish<R>(tile, K, pl, part, out + b * R * sp, done + b * sp, sp,
                    full, &nfull);
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
// split decision, one thread per node; finish, one thread per point
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
  pw_split_node(SF[s], SF[4 * sp + s], flags[((size_t)b * 5 + 2) * sp + s],
                nstats[(size_t)b * 8 * sp + s], tables + (size_t)b * 8 * sp,
                out + (size_t)b * 3 * sp, sp, s);
}

__global__ void pw_finish_kernel(float* __restrict__ state,
                                 const float* __restrict__ flags,
                                 const float* __restrict__ sd, int N, int sp,
                                 int trash) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  size_t b = blockIdx.y;
  pw_finish_point(state + b * 4 * N, flags + (b * 5 + 2) * sp,
                  sd + b * 3 * sp, N, i, trash);
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

// R1 and R1b: partial (B, N / PW_TILE, sp, R) scratch that is never filled,
// ws (B * (sp * W + 1)) u32 zero between launches (left zeroed), W the
// bitmap words of N / PW_TILE tiles.
PW_EXPORT int pw_remap_r1(const float* pts, float* partial, unsigned* ws,
                          float* out, int B, int N, int sp, int trash,
                          int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  size_t ids = sp <= PW_SLOT_TABLE_MAX ? sp * sizeof(int) : 0;
  if (fast)
    pw_r1_kernel<true><<<grid, PW_TILE, ids, st>>>(pts, partial, ws, out, N,
                                                   sp, trash);
  else
    pw_r1_kernel<false><<<grid, PW_TILE, ids, st>>>(pts, partial, ws, out, N,
                                                    sp, trash);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_remap_r1b(const float* pts, const float* cxy, float* partial,
                           unsigned* ws, float* out, int B, int N, int sp,
                           int trash, void* stream) {
  dim3 grid(N / PW_TILE, B);
  size_t ids = sp <= PW_SLOT_TABLE_MAX ? sp * sizeof(int) : 0;
  pw_r1b_kernel<<<grid, PW_TILE, ids, (cudaStream_t)stream>>>(
      pts, cxy, partial, ws, out, N, sp, trash);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_remap_nodes(const float* tables, const float* median,
                             const float* axis, float* pnode, float* tz, int B,
                             int sp, int trash, void* stream) {
  pw_remap_nodes_kernel<<<B, PW_TILE, 0, (cudaStream_t)stream>>>(
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

// work (B, 8, sp) u32 scratch, zeroed here.
PW_EXPORT int pw_node_stats(const float* pts, const float* state,
                            const float* zth, unsigned* work, float* out,
                            int B, int N, int sp, int trash, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int n = B * 8 * sp;
  int smem = 8 * sp * (int)sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      pw_stats_points, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(work, 0, (size_t)n * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
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

// D (B, 2, sp) u32 scratch, zeroed here.
PW_EXPORT int pw_deficient_round(const float* pts, float* state,
                                 const float* flags, const int* any_def,
                                 unsigned* D, int B, int N, int sp, int trash,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(D, 0, (size_t)B * 2 * sp * sizeof(unsigned),
                                  st);
  if (e != cudaSuccess) return (int)e;
  dim3 grid = pw_point_grid(N, B);
  pw_def_step<0><<<grid, 256, 0, st>>>(pts, state, flags, any_def, D, N, sp,
                                       trash);
  pw_def_step<1><<<grid, 256, 0, st>>>(pts, state, flags, any_def, D, N, sp,
                                       trash);
  pw_def_step<2><<<grid, 256, 0, st>>>(pts, state, flags, any_def, D, N, sp,
                                       trash);
  return (int)cudaGetLastError();
}

// Over the sweep plan of state row 3 (its done counts and partials, shared
// in stream order with the sweeps of the fit that follows).
PW_EXPORT int pw_seed_init(const float* pts, float* state, const float* flags,
                           unsigned char* pos, unsigned char* start,
                           int* tile_node, int* tile_off, int* node_off,
                           int* dest, int* done, float* partial, float* out,
                           int B, int N, int sp, int cap, int trash, int fast,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PwPlan plan = {pos, start, tile_node, tile_off, nullptr, node_off, dest};
  dim3 grid(N / PW_TILE, B);
  if (fast)
    pw_seed_kernel<true><<<grid, PW_TILE, 0, st>>>(
        pts, state, flags, plan, partial, out, done, N, sp, cap, trash);
  else
    pw_seed_kernel<false><<<grid, PW_TILE, 0, st>>>(
        pts, state, flags, plan, partial, out, done, N, sp, cap, trash);
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

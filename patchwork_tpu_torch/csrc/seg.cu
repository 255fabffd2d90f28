// The "pallas" segment-op backend of the generic level engine
// (segment/segops.py SegOps): segment sum, gather and masked min/max.
//
// Replace (patchwork_tpu/kernels/seg_pallas.py):
//   pw_seg_sum, pw_seg_sum_planned        seg_sum_pallas -> _seg_sum_kernel
//                                         (52-93)
//   pw_seg_gather                         seg_gather_pallas -> _gather_kernel
//                                         (100-128)
//   pw_seg_minmax                         seg_minmax_pallas -> _minmax_kernel
//                                         (135-199)
//
// On the TPU all three are one-hot contractions over a VMEM tile of points.
// On the H100:
//
// A gather is an indexed load, bound by the point-sized traffic: 4 bytes of
// id in and 4 C bytes out per point.  So the kernel moves those bytes 16 at
// a time: a thread takes four consecutive points, one 16-byte load of ids
// and one 16-byte store per channel, and the scan's (C, S) table (3 KB on
// the main path) is staged once per block in shared memory, where the
// indexed reads cost no memory transaction.  A block takes 1024 points, so
// B = 8 scans of 131072 points are 1024 blocks, the 132 SMs' resident
// blocks once over.  Where N is not a multiple of 4 (or a pointer is not
// 16-byte aligned) the rows are not aligned and the same block takes its
// 1024 points one per thread, four times; a table above 48 KB is read
// through the read-only cache instead.  The result is exact in any order.
//
// The segment sum adds in a fixed order (common.cuh): inside a tile of
// PW_TILE points the points of node s in point order from +0.0, then the
// tiles' partials in tile order from +0.0.  A segment binding fixes its ids
// for several calls, so it builds the tile plan of tile_sums.cuh once
// (pw_seg_plan, sweeps.cu) and every sum of the binding is one launch over
// it, the apply sweep's scheme: a block stages its tile's rows at the
// planned places, one thread per (run, row) adds a run in point order, the
// block writes K x R partials and the block that writes a node's last
// partial adds its chain.  A call with no binding takes one launch that
// finds its tile's runs in shared memory itself (pw_tile_slots), writes
// each present node's partial at (tile, node) of a dense buffer it never
// fills and marks the tile in the node's bitmap row; the last block of a
// scan (a count per scan) walks each node's marked tiles in order, 32 loads
// in flight.  Bound by reading the rows once (4 R bytes a point) and, below
// that, by the in-order adds; no float atomics.
//
// Min and max are exact in any order, so they are integer atomics on
// order-preserving keys (common.cuh), kept as distances from the identity
// (+inf's key for a min, -inf's for a max): zero is the identity, the table
// is a zeroed scratch that the kernel zeroes again, and no launch fills it.
// A block reduces a chunk of 2048 points of a scan into a shared (2, C, S)
// table (global memory where it exceeds 48 KB, so no launch asks for
// more), updates the scan's table once per touched entry, and the last
// block of a scan writes its results.  A warp whose live lanes hold one
// node (points come in azimuth order, so most do) reduces first and updates
// once, any other warp lane by lane.  One launch a call; a binding calls it
// without its plan: a version over the plan (a thread per run and channel)
// was slower on every input measured, its blocks waiting tile after tile
// for the plan's loads.
// -0.0 orders below +0.0, as in a total order; NaN keys order where their
// bits put them.
#include "common.cuh"
#include "tile_sums.cuh"

// points a min/max block takes (device time at B=8 x 153600, C=3, on an
// H100: 2048 points 17.0-17.2 us, 4096 25.7-27.1, 1024 18.2-21.4)
#define PW_MINMAX_CHUNK 2048

#define PW_GATHER_THREADS 256
#define PW_GATHER_POINTS (4 * PW_GATHER_THREADS)   // per block
#define PW_GATHER_SMEM_LIMIT (48 * 1024)

// table (B, C, S), seg (B, N) -> out (B, C, N).  VEC: N % 4 == 0 and seg,
// out 16-byte aligned.  STAGE: the scan's table in shared memory.
template <bool VEC, bool STAGE>
__global__ void __launch_bounds__(PW_GATHER_THREADS)
    pw_gather_kernel(const float* __restrict__ table,
                     const int* __restrict__ seg, float* __restrict__ out,
                     int C, int N, int S) {
  extern __shared__ float stab[];  // (C, S) when STAGE
  int b = blockIdx.y, t = threadIdx.x;
  const float* T = table + (size_t)b * C * S;
  const int* G = seg + (size_t)b * N;
  float* O = out + (size_t)b * C * N;
  if (STAGE) {
    for (int j = t; j < C * S; j += PW_GATHER_THREADS) stab[j] = T[j];
    __syncthreads();
  }
  auto row = [&](int c, int s) {
    return STAGE ? stab[c * S + s] : __ldg(T + (size_t)c * S + s);
  };
  int base = blockIdx.x * PW_GATHER_POINTS;
  if (VEC) {
    int i = base + 4 * t;
    if (i >= N) return;
    int4 s = *reinterpret_cast<const int4*>(G + i);
    for (int c = 0; c < C; ++c) {
      float4 v = make_float4(row(c, s.x), row(c, s.y), row(c, s.z),
                             row(c, s.w));
      *reinterpret_cast<float4*>(O + (size_t)c * N + i) = v;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int i = base + q * PW_GATHER_THREADS + t;
      if (i >= N) break;
      int s = G[i];
      for (int c = 0; c < C; ++c) O[(size_t)c * N + i] = row(c, s);
    }
  }
}

PW_EXPORT int pw_seg_gather(const float* table, const int* seg, float* out,
                            int B, int C, int N, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N + PW_GATHER_POINTS - 1) / PW_GATHER_POINTS, B);
  bool vec = N % 4 == 0 && (uintptr_t)seg % 16 == 0 && (uintptr_t)out % 16 == 0;
  size_t smem = (size_t)C * S * sizeof(float);
  bool stage = smem <= PW_GATHER_SMEM_LIMIT;
  if (!stage) smem = 0;
  if (vec && stage)
    pw_gather_kernel<true, true><<<grid, PW_GATHER_THREADS, smem, st>>>(
        table, seg, out, C, N, S);
  else if (vec)
    pw_gather_kernel<true, false><<<grid, PW_GATHER_THREADS, 0, st>>>(
        table, seg, out, C, N, S);
  else if (stage)
    pw_gather_kernel<false, true><<<grid, PW_GATHER_THREADS, smem, st>>>(
        table, seg, out, C, N, S);
  else
    pw_gather_kernel<false, false><<<grid, PW_GATHER_THREADS, 0, st>>>(
        table, seg, out, C, N, S);
  return (int)cudaGetLastError();
}

// R in 1..8 as the constant RR of the statement; any other R returns
// cudaErrorInvalidValue from the enclosing entry point.
#define PW_FOR_ROWS(R, ...)                                    \
  switch (R) {                                                 \
    case 1: { constexpr int RR = 1; __VA_ARGS__; } break;      \
    case 2: { constexpr int RR = 2; __VA_ARGS__; } break;      \
    case 3: { constexpr int RR = 3; __VA_ARGS__; } break;      \
    case 4: { constexpr int RR = 4; __VA_ARGS__; } break;      \
    case 5: { constexpr int RR = 5; __VA_ARGS__; } break;      \
    case 6: { constexpr int RR = 6; __VA_ARGS__; } break;      \
    case 7: { constexpr int RR = 7; __VA_ARGS__; } break;      \
    case 8: { constexpr int RR = 8; __VA_ARGS__; } break;      \
    default: return (int)cudaErrorInvalidValue;               \
  }

// ---------------------------------------------------------------------------
// segment sum
// ---------------------------------------------------------------------------

// Over a binding's plan, one tile of one scan per block: rows (B, R, N);
// partial (B, cap, R) scratch; done (B, S), zero between launches; out
// (B, R, S).
template <int R>
__global__ void __launch_bounds__(PW_TILE)
    pw_seg_sum_planned_kernel(const float* __restrict__ rows, PwPlan plan,
                              float* partial, float* __restrict__ out,
                              int* done, int N, int S, int cap) {
  __shared__ float vals[R * PW_TILE];
  __shared__ int sstart[PW_TILE + 1];
  __shared__ int sdest[PW_TILE];
  __shared__ int full[PW_TILE];   // nodes whose last partial this block wrote
  __shared__ int nfull;
  int b = blockIdx.y, tile = blockIdx.x;
  size_t i = (size_t)tile * PW_TILE + threadIdx.x;
  PwPlan pl = pw_plan_scan_of(plan, b, N, S, cap);
  float* part = partial + (size_t)b * cap * R;
  int K = pw_tile_runs(tile, pl, sstart, sdest);
  const float* X = rows + (size_t)b * R * N + i;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = X[(size_t)r * N];
  pw_tile_compact_sums<R>(vals, sstart, sdest, v, (int)pl.pos[i], K, part);
  pw_tile_finish<R, 32>(tile, K, pl, part, out + (size_t)b * R * S,
                        done + (size_t)b * S, S, full, &nfull);
}

// With no binding, one tile of one scan per block (pw_dense_sum_tile,
// tile_sums.cuh): rows (B, R, N), seg (B, N).
template <int R>
__global__ void __launch_bounds__(PW_TILE)
    pw_seg_sum_kernel(const float* __restrict__ rows,
                      const int* __restrict__ seg, float* partial,
                      unsigned* ws, float* __restrict__ out, int N, int S) {
  __shared__ PwDenseSmem<R> sm;
  extern __shared__ int ids[];     // S ints when S <= PW_SLOT_TABLE_MAX
  int b = blockIdx.y;
  size_t i = (size_t)blockIdx.x * PW_TILE + threadIdx.x;
  const float* X = rows + (size_t)b * R * N + i;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = X[(size_t)r * N];
  pw_dense_sum_tile<R>(sm, ids, v, seg[(size_t)b * N + i], partial, ws, out,
                       S);
}

PW_EXPORT int pw_seg_sum(const float* rows, const int* seg, float* partial,
                         unsigned* ws, float* out, int B, int R, int N, int S,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  size_t table = S <= PW_SLOT_TABLE_MAX ? S * sizeof(int) : 0;
  PW_FOR_ROWS(R, pw_seg_sum_kernel<RR><<<grid, PW_TILE, table, st>>>(
                     rows, seg, partial, ws, out, N, S));
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_seg_sum_planned(const float* rows, unsigned char* pos,
                                 unsigned char* start, int* tile_node,
                                 int* tile_off, int* node_off, int* dest,
                                 int* done, float* partial, float* out, int B,
                                 int R, int N, int S, int cap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PwPlan plan = {pos, start, tile_node, tile_off, nullptr, node_off, dest};
  dim3 grid(N / PW_TILE, B);
  PW_FOR_ROWS(R, pw_seg_sum_planned_kernel<RR><<<grid, PW_TILE, 0, st>>>(
                     rows, plan, partial, out, done, N, S, cap));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// masked segment min and max
// ---------------------------------------------------------------------------

#define PW_MINMAX_THREADS 256
// dynamic shared memory a launch may take beside its static arrays without
// an opt-in (48 KB in all)
#define PW_MINMAX_SMEM_LIMIT (48 * 1024 - 64)

// Min and max are kept as key distances (pw_min_dist, pw_max_dist,
// common.cuh): zero is the identity.

// PW_MINMAX_CHUNK points of one scan per block: ws holds the scans' key
// distances (B, 2, C, S) and a count per scan (B), zero between launches;
// the last block of a scan writes its mins and maxs and zeroes its part
// again.  SHARED: the block gathers its distances in a shared (2, C, S)
// table first (at most 48 KB, so no launch needs an opt-in).
template <bool SHARED>
__global__ void __launch_bounds__(PW_MINMAX_THREADS)
    pw_minmax_kernel(const float* __restrict__ vals,
                     const int* __restrict__ seg,
                     const unsigned char* __restrict__ mask, unsigned* ws,
                     float* __restrict__ mins, float* __restrict__ maxs,
                     int C, int N, int S) {
  extern __shared__ unsigned sh[];
  __shared__ int last;
  int b = blockIdx.y, t = threadIdx.x, lane = t & 31, cs = C * S;
  unsigned* G = ws + (size_t)b * 2 * cs;
  unsigned* count = ws + (size_t)gridDim.y * 2 * cs + b;
  unsigned* T = SHARED ? sh : G;
  if (SHARED) {
    for (int j = t; j < 2 * cs; j += PW_MINMAX_THREADS) sh[j] = 0u;
    __syncthreads();
  }
  const float* V = vals + (size_t)b * C * N;
  int start = blockIdx.x * PW_MINMAX_CHUNK;
  int end = min(start + PW_MINMAX_CHUNK, N);
  for (int base = start; base < end; base += PW_MINMAX_THREADS) {
    int i = base + t;
    bool on = i < end && mask[(size_t)b * N + i];
    int s = on ? seg[(size_t)b * N + i] : -1;
    // a warp whose live lanes hold one node reduces first and updates once
    unsigned live = __ballot_sync(0xffffffffu, on);
    int s0 = __shfl_sync(0xffffffffu, s, live ? __ffs(live) - 1 : 0);
    bool one = live && __all_sync(0xffffffffu, !on || s == s0);
    for (int c = 0; c < C; ++c) {
      int k = on ? pw_f32_key(V[(size_t)c * N + i]) : 0;
      unsigned lo = on ? pw_min_dist(k) : 0u;
      unsigned hi = on ? pw_max_dist(k) : 0u;
      if (one) {
        lo = __reduce_max_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane != __ffs(live) - 1) lo = hi = 0u;
      }
      if (lo) atomicMax(&T[c * S + s], lo);
      if (hi) atomicMax(&T[cs + c * S + s], hi);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int j = t; j < 2 * cs; j += PW_MINMAX_THREADS)
      if (sh[j]) atomicMax(&G[j], sh[j]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(count, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* mn = mins + (size_t)b * cs;
  float* mx = maxs + (size_t)b * cs;
  for (int j = t; j < cs; j += PW_MINMAX_THREADS) {
    unsigned lo = atomicExch(&G[j], 0u), hi = atomicExch(&G[cs + j], 0u);
    mn[j] = pw_min_of_dist(lo);
    mx[j] = pw_max_of_dist(hi);
  }
  if (t == 0) *count = 0u;
}

PW_EXPORT int pw_seg_minmax(const float* vals, const int* seg,
                            const unsigned char* mask, unsigned* ws,
                            float* mins, float* maxs, int B, int C, int N,
                            int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = 2 * (size_t)C * S * sizeof(unsigned);
  dim3 grid(N > 0 ? (N + PW_MINMAX_CHUNK - 1) / PW_MINMAX_CHUNK : 1, B);
  if (smem <= PW_MINMAX_SMEM_LIMIT)
    pw_minmax_kernel<true><<<grid, PW_MINMAX_THREADS, smem, st>>>(
        vals, seg, mask, ws, mins, maxs, C, N, S);
  else
    pw_minmax_kernel<false><<<grid, PW_MINMAX_THREADS, 0, st>>>(
        vals, seg, mask, ws, mins, maxs, C, N, S);
  return (int)cudaGetLastError();
}

// Sums of runs of consecutive rows, each run added in row order from +0.0
// (the voxel-grid filter's centroids, ops/sampling.py: a sorted cloud's
// voxels are runs).  Not a port of a TPU kernel: the JAX package leaves
// this sum to XLA.  It stands in for index_add_, whose float atomics on the
// card fix no order.  rows (N, C), C <= 4; a run starts at i where first[i]
// and goes on while the next row is live and starts no run; its sums go to
// sums[run[i]] and its length to cnts[run[i]], both zeroed by the caller.
// The thread of a run's first row walks the run: bound by the longest run,
// not by bytes, which is the price of the fixed order.
__global__ void pw_run_sum_kernel(const float* __restrict__ rows,
                                  const unsigned char* __restrict__ first,
                                  const unsigned char* __restrict__ live,
                                  const int* __restrict__ run,
                                  float* __restrict__ sums,
                                  float* __restrict__ cnts, int N, int C) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !first[i]) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int j = i;
  do {
    for (int c = 0; c < C; ++c) acc[c] += rows[(size_t)j * C + c];
    ++j;
  } while (j < N && live[j] && !first[j]);
  int r = run[i];
  for (int c = 0; c < C; ++c) sums[(size_t)r * C + c] = acc[c];
  cnts[r] = (float)(j - i);
}

PW_EXPORT int pw_run_sum(const float* rows, const unsigned char* first,
                         const unsigned char* live, const int* run,
                         float* sums, float* cnts, int N, int C,
                         void* stream) {
  if (C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  if (N > 0)
    pw_run_sum_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        rows, first, live, run, sums, cnts, N, C);
  return (int)cudaGetLastError();
}

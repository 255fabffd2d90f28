// Segment gather and masked segment min/max: the "pallas" segment-op
// backend of the generic level engine (segment/segops.py SegOps).
//
// Replace (patchwork_tpu/kernels/seg_pallas.py):
//   pw_seg_gather  seg_gather_pallas -> _gather_kernel (100-128)
//   pw_seg_minmax  seg_minmax_pallas -> _minmax_kernel (135-199)
//
// On the TPU both are one-hot contractions over a VMEM tile of points.  On
// the H100 a gather is an indexed load, bound by the point-sized traffic:
// 4 bytes of id in and 4 C bytes out per point.  So the kernel moves those
// bytes 16 at a time: a thread takes four consecutive points, one 16-byte
// load of ids and one 16-byte store per channel, and the scan's (C, S)
// table (3 KB on the main path) is staged once per block in shared memory,
// where the indexed reads cost no memory transaction.  A block takes 1024
// points, so B = 8 scans of 131072 points are 1024 blocks, the 132 SMs'
// resident blocks once over.  Where N is not a multiple of 4 (or a pointer
// is not 16-byte aligned) the rows are not aligned and the same block takes
// its 1024 points one per thread, four times; a table above 48 KB is read
// through the read-only cache instead.  The result is exact in any order.
// Min and max are integer atomics on order-preserving keys
// (common.cuh), which are exact in any order: each block reduces a chunk of
// one scan's points into a shared-memory (2, C, S) table and then updates
// global memory once per touched bin.  Bound by the shared atomics, 2 C per
// masked point.  -0.0 orders below +0.0, as in a total order.
#include "common.cuh"

#define PW_MINMAX_CHUNK 4096

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

// work (B, 2, C, S) int keys: row block 0 the mins, 1 the maxs
__global__ void pw_minmax_init(int* __restrict__ work, int n, int cs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) work[idx] = (idx / cs) % 2 == 0 ? PW_KEY_POS_INF : PW_KEY_NEG_INF;
}

__global__ void pw_minmax_points(const float* __restrict__ vals,
                                 const int* __restrict__ seg,
                                 const unsigned char* __restrict__ mask,
                                 int* __restrict__ work, int C, int N, int S) {
  extern __shared__ int sh[];  // (2, C, S)
  int cs = C * S;
  for (int j = threadIdx.x; j < 2 * cs; j += blockDim.x)
    sh[j] = j < cs ? PW_KEY_POS_INF : PW_KEY_NEG_INF;
  __syncthreads();
  int b = blockIdx.y;
  const float* V = vals + (size_t)b * C * N;
  int start = blockIdx.x * PW_MINMAX_CHUNK;
  int end = min(start + PW_MINMAX_CHUNK, N);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    if (!mask[(size_t)b * N + i]) continue;
    int s = seg[(size_t)b * N + i];
    for (int c = 0; c < C; ++c) {
      int k = pw_f32_key(V[(size_t)c * N + i]);
      atomicMin(&sh[c * S + s], k);
      atomicMax(&sh[cs + c * S + s], k);
    }
  }
  __syncthreads();
  int* W = work + (size_t)b * 2 * cs;
  for (int j = threadIdx.x; j < cs; j += blockDim.x) {
    if (sh[j] != PW_KEY_POS_INF) atomicMin(&W[j], sh[j]);
    if (sh[cs + j] != PW_KEY_NEG_INF) atomicMax(&W[cs + j], sh[cs + j]);
  }
}

__global__ void pw_minmax_finish(const int* __restrict__ work,
                                 float* __restrict__ mins,
                                 float* __restrict__ maxs, int n, int cs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int b = idx / cs, j = idx % cs;
  mins[idx] = pw_key_f32(work[(size_t)b * 2 * cs + j]);
  maxs[idx] = pw_key_f32(work[(size_t)b * 2 * cs + cs + j]);
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

PW_EXPORT int pw_seg_minmax(const float* vals, const int* seg,
                            const unsigned char* mask, int* work, float* mins,
                            float* maxs, int B, int C, int N, int S,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int cs = C * S;
  int smem = 2 * cs * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      pw_minmax_points, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int nw = B * 2 * cs;
  pw_minmax_init<<<(nw + 255) / 256, 256, 0, st>>>(work, nw, cs);
  dim3 grid((N + PW_MINMAX_CHUNK - 1) / PW_MINMAX_CHUNK, B);
  if (N > 0)
    pw_minmax_points<<<grid, 256, smem, st>>>(vals, seg, mask, work, C, N, S);
  int no = B * cs;
  pw_minmax_finish<<<(no + 255) / 256, 256, 0, st>>>(work, mins, maxs, no,
                                                     cs);
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

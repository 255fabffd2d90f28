// Segment gather and masked segment min/max: the "pallas" segment-op
// backend of the generic level engine (segment/segops.py SegOps).
//
// Replace (patchwork_tpu/kernels/seg_pallas.py):
//   pw_seg_gather  seg_gather_pallas -> _gather_kernel (100-128)
//   pw_seg_minmax  seg_minmax_pallas -> _minmax_kernel (135-199)
//
// On the TPU both are one-hot contractions over a VMEM tile of points.  On
// the H100 a gather is an indexed load: one thread per point reads its
// segment's C table entries (the table is a few KB and stays in L1/L2), so
// it is bound by the point-sized traffic, 4 bytes of id in and 4 C bytes
// out per point.  Min and max are integer atomics on order-preserving keys
// (common.cuh), which are exact in any order: each block reduces a chunk of
// one scan's points into a shared-memory (2, C, S) table and then updates
// global memory once per touched bin.  Bound by the shared atomics, 2 C per
// masked point.  -0.0 orders below +0.0, as in a total order.
#include "common.cuh"

#define PW_MINMAX_CHUNK 4096

// table (B, C, S), seg (B, N) -> out (B, C, N)
__global__ void pw_gather_kernel(const float* __restrict__ table,
                                 const int* __restrict__ seg,
                                 float* __restrict__ out, int C, int N, int S) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int b = blockIdx.y;
  int s = seg[(size_t)b * N + i];
  const float* T = table + (size_t)b * C * S;
  float* O = out + (size_t)b * C * N;
  for (int c = 0; c < C; ++c) O[(size_t)c * N + i] = T[(size_t)c * S + s];
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
  dim3 grid((N + 255) / 256, B);
  pw_gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(table, seg, out,
                                                          C, N, S);
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

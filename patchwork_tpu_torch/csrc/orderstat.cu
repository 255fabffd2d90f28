// Exact per-segment order statistic: the k-th smallest value of each
// segment, sorted(vals of seg)[k], with no sort.
//
// Replaces patchwork_tpu/kernels/fit_pallas.py seg_order_stat ->
// _orderstat_kernel (664-731), with _orderstat_rounds (606-643), _f32_key /
// _key_f32 (590-599) and _bucket_onehot (652-661).  It is the split median
// (R2) and the percentile seed threshold (phase 1b) of the level kernel.
//
// Five rounds over order-preserving int32 keys, each resolving 7 key bits
// (4 in the last, shifts 25, 18, 11, 4, 0): a histogram pass counts each
// segment's candidates into 128 buckets of the current key interval, and
// a select pass (one thread per segment) finds the bucket that holds rank k
// and narrows the interval.  After round 5 the interval is one key: the
// answer, exact for ties, -0.0, denormals and +-3e38.
//
// On the TPU the counts are bf16 one-hot matmuls.  Here a block counts a
// chunk of one scan's points into a shared-memory (segment, bucket)
// histogram with integer atomics (exact, order-free) and adds its nonzero
// bins to global memory.  What bounds it on the H100 is the shared-memory
// atomics of the counting pass (one per point per round) and, for few
// points per block, zeroing and flushing the Sp x 128 bins; PW_OS_CHUNK
// points per block keeps the flush small next to the counting.
#include "common.cuh"

#define PW_OS_CHUNK 8192

__global__ void pw_os_init(const int* __restrict__ k, int* __restrict__ kw,
                           int* __restrict__ lo, int n) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  kw[idx] = k[idx];
  lo[idx] = 0;
}

__global__ void pw_os_hist(const float* __restrict__ vals,
                           const int* __restrict__ seg,
                           const unsigned char* __restrict__ valid,
                           const int* __restrict__ lo, int* __restrict__ hist,
                           int N, int S, int shift, int first) {
  extern __shared__ int sh[];  // (S, 128)
  for (int j = threadIdx.x; j < S * 128; j += blockDim.x) sh[j] = 0;
  __syncthreads();
  int b = blockIdx.y;
  size_t base = (size_t)b * N;
  int start = blockIdx.x * PW_OS_CHUNK;
  int end = min(start + PW_OS_CHUNK, N);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    if (!valid[base + i]) continue;
    int s = seg[base + i];
    if (s < 0 || s >= S) continue;
    int key = pw_f32_key(vals[base + i]);
    int bkt;
    if (first) {
      bkt = (key >> 25) + 64;
    } else {
      int l = lo[(size_t)b * S + s];
      if (key < l) continue;
      unsigned d = (unsigned)key - (unsigned)l;
      if (d >= (128u << shift)) continue;
      bkt = (int)(d >> shift);
    }
    atomicAdd(&sh[s * 128 + bkt], 1);
  }
  __syncthreads();
  int* h = hist + (size_t)b * S * 128;
  for (int j = threadIdx.x; j < S * 128; j += blockDim.x) {
    int c = sh[j];
    if (c) atomicAdd(&h[j], c);
  }
}

__global__ void pw_os_select(int* __restrict__ hist, int* __restrict__ kw,
                             int* __restrict__ lo, float* __restrict__ out,
                             int n, int shift, int first, int last) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int* h = hist + (size_t)idx * 128;
  int k = kw[idx];
  int cum = 0, j = 0;
  for (; j < 128; ++j) {  // first bucket whose inclusive count exceeds k
    int c = h[j];
    if (cum + c > k) break;
    cum += c;
  }
  kw[idx] = k - (j < 128 ? cum : 0);
  unsigned l = (unsigned)lo[idx];
  l = first ? ((unsigned)(j - 64) << 25) : (l + ((unsigned)j << shift));
  lo[idx] = (int)l;
  for (int q = 0; q < 128; ++q) h[q] = 0;  // ready for the next round
  if (last) out[idx] = pw_key_f32((int)l);
}

PW_EXPORT int pw_seg_order_stat(const float* vals, const int* seg,
                                const unsigned char* valid, const int* k,
                                float* out, int* hist, int* lo, int* kw,
                                int B, int N, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int smem = S * 128 * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      pw_os_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int n = B * S;
  pw_os_init<<<(n + 127) / 128, 128, 0, st>>>(k, kw, lo, n);
  const int shifts[5] = {25, 18, 11, 4, 0};
  dim3 grid((N + PW_OS_CHUNK - 1) / PW_OS_CHUNK, B);
  for (int r = 0; r < 5; ++r) {
    pw_os_hist<<<grid, 256, smem, st>>>(vals, seg, valid, lo, hist, N, S,
                                        shifts[r], r == 0);
    pw_os_select<<<(n + 127) / 128, 128, 0, st>>>(hist, kw, lo, out, n,
                                                  shifts[r], r == 0, r == 4);
  }
  return (int)cudaGetLastError();
}

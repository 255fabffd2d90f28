// Exact per-segment order statistic: the k-th smallest value of each
// segment, sorted(vals of seg)[k], with no sort.
//
// Replaces patchwork_tpu/kernels/fit_pallas.py seg_order_stat ->
// _orderstat_kernel (664-731), with _orderstat_rounds (606-643), _f32_key /
// _key_f32 (590-599) and _bucket_onehot (652-661).  It is the split median
// (R2) and the percentile seed threshold (phase 1b) of the level kernel.
//
// The answer comes from five rounds over order-preserving int32 keys, each
// resolving 7 key bits (4 in the last, shifts 25, 18, 11, 4, 0): a histogram
// counts a segment's candidates into 128 buckets of the current key
// interval, and a select finds the bucket that holds rank k and narrows the
// interval.  After round 5 the interval is one key: the answer, exact for
// ties, -0.0, denormals and +-3e38.  Counts are integers, so the result is
// the same in whatever order the points are counted.
//
// On the TPU the counts are bf16 one-hot matmuls over the whole cloud, five
// times.  Five passes over all points on this card would need a (segment,
// bucket) histogram of 128 KB of shared memory a block (one block an SM)
// and a launch or a device-wide step between the rounds: what bounds the
// function here is not its bytes (9 a point) but the latency of its passes.
// So the points are first brought together by segment, which needs no order
// inside a segment:
//
//   1. pw_os_count    a block counts its chunk's points per segment in
//                     shared memory (Sp ints, not Sp x 128) and adds the
//                     counts to the scan's;
//   2. pw_os_scatter  a block turns the scan's counts into offsets (a prefix
//                     sum over Sp), takes a range per segment with one
//                     integer atomic per present segment, and writes each
//                     point's key into its segment's part of a (B, N) buffer;
//   3. pw_os_select   a block per (scan, segment) runs all five rounds over
//                     its own keys, which lie next to each other: a
//                     128-bucket histogram in shared memory, a prefix scan
//                     over the buckets by four warps, no launch and no
//                     device-wide step between the rounds.
//
// A warp whose points all fall into one segment (passes 1, 2: a scan in
// azimuth order) or one bucket (pass 3: ties) adds once.  In the first round
// of pass 3, which sorts by sign and exponent only, __match_any_sync groups
// a warp's few buckets and each group adds once; elsewhere a warp spreads
// over many keys, where the match (a step per distinct key) was measured to
// cost more than the adds it saves.  Three launches a call, every point read twice and its
// key five times out of the L2.
//
// The per-round entry (pw_os_prepare, pw_os_round, pw_os_final) splits pass 3
// at its rounds, so that a collective can add the ranks' histograms between
// them when a scan's points lie on several processes: passes 1 and 2 once,
// then one launch a round that first selects from the previous round's
// summed histogram (as pass 3 does in shared memory) and then counts this
// process's keys into the current interval's 128 buckets, and a last launch
// that selects from round 5's.  Counts are integers, so whatever order the
// histograms are added in, every process picks the same key.
#include "common.cuh"

#define PW_OS_THREADS 256
#define PW_OS_PER 8                       // points per thread, passes 1 and 2
#define PW_OS_CHUNK (PW_OS_THREADS * PW_OS_PER)
#define PW_OS_SEL_THREADS 256
#define PW_OS_SEL_LOADS 8                 // loads a thread keeps in flight

// The lanes of the warp whose `key` equals this lane's add `1` to
// counter[key] once; returns this lane's place among them plus the
// counter's value before (a slot).  Lanes with key < 0 take no part in the
// add.  Every lane of the warp calls it.
__device__ __forceinline__ int pw_warp_add(int* counter, int key) {
  unsigned peers = __match_any_sync(0xffffffffu, key);
  int lane = threadIdx.x & 31;
  int leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader) base = atomicAdd(&counter[key], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// As pw_warp_add for keys that are either the same in the whole warp (a
// scan in azimuth order) or mostly differ (a shuffled one), where the match
// would take a step per distinct key: one add for a warp of one key, else
// every lane adds on its own.  Returns the lane's slot.
__device__ __forceinline__ int pw_slot_add(int* counter, int key) {
  int lane = threadIdx.x & 31;
  int k0 = __shfl_sync(0xffffffffu, key, 0);
  if (__all_sync(0xffffffffu, key == k0)) {
    int base = 0;
    if (lane == 0 && key >= 0) base = atomicAdd(&counter[key], 32);
    return __shfl_sync(0xffffffffu, base, 0) + lane;
  }
  return key >= 0 ? atomicAdd(&counter[key], 1) : 0;
}

// A histogram add for buckets that mostly differ inside a warp (rounds 2 to
// 5, where __match_any_sync would take a step per distinct value, up to
// 32): lanes add on their own, unless the whole warp holds one bucket
// (ties), which adds once.
__device__ __forceinline__ void pw_hist_add(int* hist, int bkt) {
  int b0 = __shfl_sync(0xffffffffu, bkt, 0);
  if (__all_sync(0xffffffffu, bkt == b0)) {
    if ((threadIdx.x & 31) == 0 && bkt >= 0) atomicAdd(&hist[bkt], 32);
  } else if (bkt >= 0) {
    atomicAdd(&hist[bkt], 1);
  }
}

// The segment of point i of the scan, or -1 where it does not count.
__device__ __forceinline__ int pw_os_segment(const int* seg,
                                             const unsigned char* valid,
                                             size_t i, int S) {
  if (!valid[i]) return -1;
  int s = seg[i];
  return (s < 0 || s >= S) ? -1 : s;
}

__global__ void __launch_bounds__(PW_OS_THREADS)
    pw_os_count(const int* __restrict__ seg,
                const unsigned char* __restrict__ valid, int* __restrict__ cnt,
                int N, int S) {
  extern __shared__ int sh[];  // (S,)
  int b = blockIdx.y, t = threadIdx.x;
  for (int j = t; j < S; j += PW_OS_THREADS) sh[j] = 0;
  __syncthreads();
  size_t base = (size_t)b * N;
  int start = blockIdx.x * PW_OS_CHUNK;
#pragma unroll
  for (int q = 0; q < PW_OS_PER; ++q) {
    int i = start + q * PW_OS_THREADS + t;
    int s = i < N ? pw_os_segment(seg, valid, base + i, S) : -1;
    pw_slot_add(sh, s);
  }
  __syncthreads();
  for (int j = t; j < S; j += PW_OS_THREADS) {
    int c = sh[j];
    if (c) atomicAdd(&cnt[(size_t)b * S + j], c);
  }
}

// cnt (B, S): the scan's counts; cursor (B, S), zeroed: what of each
// segment's range is taken; first (B, S), out: the exclusive prefix sum of
// cnt; keys (B, N): segment s's keys lie from first[s] on, in no order.
__global__ void __launch_bounds__(PW_OS_THREADS)
    pw_os_scatter(const float* __restrict__ vals, const int* __restrict__ seg,
                  const unsigned char* __restrict__ valid,
                  const int* __restrict__ cnt, int* __restrict__ cursor,
                  int* __restrict__ first, int* __restrict__ keys, int N,
                  int S) {
  extern __shared__ int sh[];  // (S,) local counts, then (S,) range starts
  __shared__ int ws[PW_OS_THREADS / 32];
  __shared__ int carry;
  int* local = sh;
  int* at = sh + S;
  int b = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = t; j < S; j += PW_OS_THREADS) local[j] = 0;
  if (t == 0) carry = 0;
  __syncthreads();
  size_t base = (size_t)b * N;
  int start = blockIdx.x * PW_OS_CHUNK;
  int s[PW_OS_PER], slot[PW_OS_PER], key[PW_OS_PER];
#pragma unroll
  for (int q = 0; q < PW_OS_PER; ++q) {
    int i = start + q * PW_OS_THREADS + t;
    s[q] = i < N ? pw_os_segment(seg, valid, base + i, S) : -1;
    key[q] = s[q] >= 0 ? pw_f32_key(vals[base + i]) : 0;
    slot[q] = pw_slot_add(local, s[q]);
  }
  __syncthreads();
  // segment j's range starts at the scan's exclusive prefix sum of cnt; the
  // block takes local[j] places of it
  for (int j0 = 0; j0 < S; j0 += PW_OS_THREADS) {
    int j = j0 + t;
    int c = j < S ? cnt[(size_t)b * S + j] : 0;
    int inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int n = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += n;
    }
    if (lane == 31) ws[warp] = inc;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += ws[w];
    if (j < S) {
      int mine = local[j];
      at[j] = before + inc - c +
              (mine ? atomicAdd(&cursor[(size_t)b * S + j], mine) : 0);
      if (blockIdx.x == 0) first[(size_t)b * S + j] = before + inc - c;
    }
    __syncthreads();
    if (t == PW_OS_THREADS - 1) carry = before + inc;
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < PW_OS_PER; ++q)
    if (s[q] >= 0) keys[base + at[s[q]] + slot[q]] = key[q];
}

// The bucket of a key in round r (shift = the round's), or -1 where the key
// lies outside the segment's current interval [lo, lo + 128 << shift).
__device__ __forceinline__ int pw_os_bucket(int key, bool first, unsigned lo,
                                            int shift) {
  if (first) return (key >> 25) + 64;
  if (key < (int)lo) return -1;
  unsigned d = (unsigned)key - lo;
  return d < (128u << shift) ? (int)(d >> shift) : -1;
}

// One block per (segment, scan): the five rounds over the segment's keys.
// Measured: what a block pays is latency, about 5 us for its five rounds
// whatever it holds (dependent loads, three barriers and a scan a round) and
// 1.3 us more per round and 4096 keys, so the kernel's time is its number
// of waves times that, plus its largest segment's passes.  Blocks of 256
// threads keep eight to an SM (blocks of 1024 served one large segment
// better and many small ones far worse), a thread keeps PW_OS_SEL_LOADS
// loads in flight, and an empty segment, which took the 5 us too, is
// answered by one thread at once.
__global__ void __launch_bounds__(PW_OS_SEL_THREADS)
    pw_os_select(const int* __restrict__ keys, const int* __restrict__ cnt,
                 const int* __restrict__ first, const int* __restrict__ k,
                 float* __restrict__ out, int N, int S) {
  __shared__ int hist[128];
  __shared__ int ws[4];
  __shared__ int s_kw, s_lo;
  constexpr int T = PW_OS_SEL_THREADS, L = PW_OS_SEL_LOADS;
  int b = blockIdx.y, sg = blockIdx.x, t = threadIdx.x;
  int lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_kw = k[(size_t)b * S + sg];
    s_lo = 0;
  }
  int n = cnt[(size_t)b * S + sg];
  const int shifts[5] = {25, 18, 11, 4, 0};
  if (n == 0) {
    // what the rounds below give with every count zero
    if (t == 0) {
      int kw = k[(size_t)b * S + sg];
      unsigned lo = kw < 0 ? ((unsigned)(0 - 64) << 25) : (64u << 25);
      for (int r = 1; r < 5; ++r)
        if (kw >= 0) lo += 128u << shifts[r];
      out[(size_t)b * S + sg] = pw_key_f32((int)lo);
    }
    return;
  }
  const int* mine = keys + (size_t)b * N + first[(size_t)b * S + sg];
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < 5; ++r) {
    int shift = shifts[r];
    if (t < 128) hist[t] = 0;
    unsigned lo = (unsigned)s_lo;
    int kw = s_kw;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += L * T) {
      int key[L];
#pragma unroll
      for (int q = 0; q < L; ++q) {
        int i = i0 + q * T + t;
        key[q] = i < n ? mine[i] : 0;
      }
#pragma unroll
      for (int q = 0; q < L; ++q) {
        if (i0 + q * T < n) {     // the same for the whole block
          int i = i0 + q * T + t;
          int bkt = i < n ? pw_os_bucket(key[q], r == 0, lo, shift) : -1;
          // round 1 sorts by sign and exponent: a few buckets a warp
          if (r == 0) pw_warp_add(hist, bkt);
          else pw_hist_add(hist, bkt);
        }
      }
    }
    __syncthreads();
    // the first bucket whose inclusive count exceeds kw; 128 where none
    // does (k out of range), and kw then stays.  Four warps scan the 128
    // buckets.
    int c = 0, inc = 0;
    if (t < 128) {
      c = hist[t];
      inc = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int m = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += m;
      }
      if (lane == 31) ws[warp] = inc;
    }
    __syncthreads();
    if (t < 128) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += ws[w];
      int cum = before + inc - c;                 // exclusive count below t
      bool hit = cum + c > kw && (t == 0 || cum <= kw);   // at most one
      if (t == 0 && ws[0] + ws[1] + ws[2] + ws[3] <= kw)
        s_lo = (int)(r == 0 ? ((unsigned)(128 - 64) << 25)
                            : (lo + (128u << shift)));
      if (hit) {
        s_kw = kw - cum;
        s_lo = (int)(r == 0 ? ((unsigned)(t - 64) << 25)
                            : (lo + ((unsigned)t << shift)));
      }
    }
    __syncthreads();
  }
  if (t == 0) out[(size_t)b * S + sg] = pw_key_f32(s_lo);
}

// The select of one round over a summed 128-bucket histogram `hist`
// (global), by the first 128 threads of the block: the first bucket whose
// inclusive count exceeds *kw; where none does (k out of range) *kw stays and
// the interval moves past its end, as in pw_os_select.  Every thread of the
// block calls it; *lo and *kw are shared.
__device__ __forceinline__ void pw_os_pick(const int* hist, int r, int* lo,
                                           int* kw, int* ws) {
  const int shifts[5] = {25, 18, 11, 4, 0};
  int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int shift = shifts[r];
  unsigned lo0 = (unsigned)*lo;
  int kw0 = *kw;
  int c = 0, inc = 0;
  if (t < 128) {
    c = hist[t];
    inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int m = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += m;
    }
    if (lane == 31) ws[warp] = inc;
  }
  __syncthreads();
  if (t < 128) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += ws[w];
    int cum = before + inc - c;
    bool hit = cum + c > kw0 && (t == 0 || cum <= kw0);
    if (t == 0 && ws[0] + ws[1] + ws[2] + ws[3] <= kw0)
      *lo = (int)(r == 0 ? ((unsigned)(128 - 64) << 25)
                         : (lo0 + (128u << shift)));
    if (hit) {
      *kw = kw0 - cum;
      *lo = (int)(r == 0 ? ((unsigned)(t - 64) << 25)
                         : (lo0 + ((unsigned)t << shift)));
    }
  }
  __syncthreads();
}

// Round r of the per-round entry, a block per selected segment m: sel (M,)
// holds b * S + s of the segments counted, the same on every process; state
// (M, 2) [lo, kw]; hist_in (M, 128) round r - 1's summed histogram (r > 0);
// hist_out (M, 128) this process's counts of round r.
__global__ void __launch_bounds__(PW_OS_SEL_THREADS)
    pw_os_round(const int* __restrict__ keys, const int* __restrict__ cnt,
                const int* __restrict__ first, const int* __restrict__ sel,
                const int* __restrict__ k, const int* __restrict__ hist_in,
                int* __restrict__ state, int* __restrict__ hist_out, int N,
                int S, int r) {
  __shared__ int hist[128];
  __shared__ int ws[4];
  __shared__ int s_kw, s_lo;
  constexpr int T = PW_OS_SEL_THREADS, L = PW_OS_SEL_LOADS;
  const int shifts[5] = {25, 18, 11, 4, 0};
  int m = blockIdx.x, t = threadIdx.x;
  int bs = sel[m];
  if (t == 0) {
    s_lo = r == 0 ? 0 : state[2 * m];
    s_kw = r == 0 ? k[bs] : state[2 * m + 1];
  }
  if (t < 128) hist[t] = 0;
  __syncthreads();
  if (r > 0) pw_os_pick(hist_in + (size_t)m * 128, r - 1, &s_lo, &s_kw, ws);
  if (t == 0) {
    state[2 * m] = s_lo;
    state[2 * m + 1] = s_kw;
  }
  int shift = shifts[r];
  unsigned lo = (unsigned)s_lo;
  int n = cnt[bs];
  const int* mine = keys + (size_t)(bs / S) * N + first[bs];
  for (int i0 = 0; i0 < n; i0 += L * T) {
    int key[L];
#pragma unroll
    for (int q = 0; q < L; ++q) {
      int i = i0 + q * T + t;
      key[q] = i < n ? mine[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if (i0 + q * T < n) {     // the same for the whole block
        int i = i0 + q * T + t;
        int bkt = i < n ? pw_os_bucket(key[q], r == 0, lo, shift) : -1;
        if (r == 0) pw_warp_add(hist, bkt);
        else pw_hist_add(hist, bkt);
      }
    }
  }
  __syncthreads();
  if (t < 128) hist_out[(size_t)m * 128 + t] = hist[t];
}

// The last select, from round 5's summed histogram: out[sel[m]] is the key's
// value.
__global__ void __launch_bounds__(128)
    pw_os_final(const int* __restrict__ sel, const int* __restrict__ hist_in,
                const int* __restrict__ state, float* __restrict__ out) {
  __shared__ int ws[4];
  __shared__ int s_kw, s_lo;
  int m = blockIdx.x;
  if (threadIdx.x == 0) {
    s_lo = state[2 * m];
    s_kw = state[2 * m + 1];
  }
  __syncthreads();
  pw_os_pick(hist_in + (size_t)m * 128, 4, &s_lo, &s_kw, ws);
  if (threadIdx.x == 0) out[sel[m]] = pw_key_f32(s_lo);
}

// Passes 1 and 2 of the per-round entry: cnt and cursor (B, S) zeroed by
// the caller; first (B, S) and keys (B, N) out.
PW_EXPORT int pw_os_prepare(const float* vals, const int* seg,
                            const unsigned char* valid, int* cnt, int* cursor,
                            int* first, int* keys, int B, int N, int S,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N + PW_OS_CHUNK - 1) / PW_OS_CHUNK, B);
  pw_os_count<<<grid, PW_OS_THREADS, S * sizeof(int), st>>>(seg, valid, cnt,
                                                            N, S);
  pw_os_scatter<<<grid, PW_OS_THREADS, 2 * S * sizeof(int), st>>>(
      vals, seg, valid, cnt, cursor, first, keys, N, S);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_os_round_launch(const int* keys, const int* cnt,
                                 const int* first, const int* sel, const int* k,
                                 const int* hist_in, int* state, int* hist_out,
                                 int M, int N, int S, int r, void* stream) {
  pw_os_round<<<M, PW_OS_SEL_THREADS, 0, (cudaStream_t)stream>>>(
      keys, cnt, first, sel, k, hist_in, state, hist_out, N, S, r);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_os_final_launch(const int* sel, const int* hist_in,
                                 const int* state, float* out, int M,
                                 void* stream) {
  pw_os_final<<<M, 128, 0, (cudaStream_t)stream>>>(sel, hist_in, state, out);
  return (int)cudaGetLastError();
}

// cnt and cursor (B, S) are zeroed by the caller; first (B, S) and keys
// (B, N) are scratch.
PW_EXPORT int pw_seg_order_stat(const float* vals, const int* seg,
                                const unsigned char* valid, const int* k,
                                float* out, int* cnt, int* cursor, int* first,
                                int* keys, int B, int N, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N + PW_OS_CHUNK - 1) / PW_OS_CHUNK, B);
  pw_os_count<<<grid, PW_OS_THREADS, S * sizeof(int), st>>>(seg, valid, cnt,
                                                            N, S);
  pw_os_scatter<<<grid, PW_OS_THREADS, 2 * S * sizeof(int), st>>>(
      vals, seg, valid, cnt, cursor, first, keys, N, S);
  pw_os_select<<<dim3(S, B), PW_OS_SEL_THREADS, 0, st>>>(keys, cnt, first, k,
                                                         out, N, S);
  return (int)cudaGetLastError();
}

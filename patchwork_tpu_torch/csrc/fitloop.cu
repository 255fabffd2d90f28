// One level's whole plane-fit loop in one launch, across the whole card.
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
// matmuls on one core.  Here the loop is bound by latency, not by bytes: a
// sweep moves 32 bytes a point, but up to 101 sweeps follow one another and
// each needs every node's sums of the one before.  So every scan gets G
// blocks of PW_TILE threads that are resident together (a co-operative
// launch, G = the card's co-resident blocks / B, at most one per tile) and
// loop on the device, with one barrier per scan in device memory between
// the phases of a sweep: no host read, and each scan leaves the loop on its
// own.  A co-operative launch with per-scan barriers was taken over a
// thread-block cluster per scan because a cluster holds at most 16 blocks,
// which leaves 116 of 132 SMs idle at B = 1, while the barrier serves any G.
//
// A block owns a contiguous range of tiles for the whole launch, so a
// point's mask is read and written by one thread only.  The sweep plan
// (tile_sums.cuh) is built in the kernel, the node ids being fixed.  Per
// sweep each block writes its tiles' compact partials (they stay in the
// L2, a node's next to each other); after the barrier node s, owned by
// block s % G, gets its chain in tile order, its centroid and normal (one
// acosf per node and table, by the
// owner only) and its table row; after the next barrier every block reads
// the table into shared memory and sweeps again.  Sums keep the sweeps'
// order, so the kernel equals fit_cuda.fit_level_plain bit for bit, run
// after run, and a scan's result does not depend on the batch it is in.
//
// What one block writes and another reads (partials, table, flag, plan) is
// read with __ldcg after a __threadfence and the barrier.
//
// A block walks its tiles in sequence with plain coalesced loads.  A ring of
// tiles in shared memory filled by asynchronous copies (the next tile in
// flight during the sums of the one before, a share of one or two tiles
// kept for the whole launch) was built and measured: the exact fit got
// slower under this kernel's 48-register cap and the fast fit gained 3-6 %,
// so it was not kept.  The barriers, the chains and the in-order runs bound
// an iteration, not the loads.
#include "common.cuh"
#include "tile_sums.cuh"

struct PwFitArgs {
  const float* p;
  const float* g0;
  float* g;
  float* stats;
  PwPlan plan;
  float* partial;   // (B, cap, R) compact tile partials
  float* tab;       // (B, 7, sp) [cx, cy, cz, nx, ny, nz, gcnt >= 3]
  int* flag;        // (B,) number of the last sweep that changed the mask
  int* bar;         // (B,) arrivals at the scan's barrier, zeroed
  int* sweeps;      // (B,) out: apply sweeps the scan ran
  int N, sp, cap, max_iter, G;
};

// Barrier over the G blocks of one scan: arrivals only grow, the k-th
// barrier waits for k * G of them.
__device__ __forceinline__ void pw_scan_barrier(int* bar, int G, int* epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int target = ++*epoch * G;
    __threadfence();
    atomicAdd(bar, 1);
    while (*(volatile int*)bar < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// What a block keeps of its scan.
struct PwFitBlock {
  const float* P;   // the scan's points
  float* Gm;        // the scan's mask
  PwPlan pl;
  float* part;      // the scan's partials
  float* tabg;      // the scan's table in device memory
  float* vals;      // shared: R * PW_TILE staged rows
  float* tab;       // shared: (7, sp)
  int* sstart;      // shared: PW_TILE + 1
  int* sdest;       // shared: PW_TILE
  int t0, t1;       // its tiles
  int g, G, nloc;   // its nodes are g + q * G, q < nloc
  int N, sp;
};

// Apply sweep over the block's tiles with the table in shared memory
// (_mega_kernel's `sweep`, fit_pallas.py:405-443): re-threshold where
// amask * can, write the mask, write the tiles' compact partials.
template <bool FAST>
__device__ void pw_fit_apply(const PwFitBlock& k, bool with_can) {
  constexpr int R = FAST ? 12 : 6;
  int N = k.N, sp = k.sp;
  const float* P = k.P;
  const float* tab = k.tab;
  for (int tile = k.t0; tile < k.t1; ++tile) {
    size_t i = (size_t)tile * PW_TILE + threadIdx.x;
    int K = pw_tile_runs(tile, k.pl, k.sstart, k.sdest);
    float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
    float tau = P[3 * (size_t)N + i], am = P[4 * (size_t)N + i];
    int s = (int)P[5 * (size_t)N + i];
    float g = k.Gm[i];
    float dx = x - tab[s], dy = y - tab[sp + s], dz = z - tab[2 * sp + s];
    float dist = fabsf(dx * tab[3 * sp + s] + dy * tab[4 * sp + s] +
                       dz * tab[5 * sp + s]);
    float apply_m = am * (with_can ? tab[6 * sp + s] : 0.f);
    float new_g = dist < tau ? 1.f : 0.f;
    float g2 = apply_m * new_g + (1.f - apply_m) * g;
    k.Gm[i] = g2;
    float xg = x * g2, yg = y * g2, zg = z * g2;
    float v[R];
    v[0] = g2;
    v[1] = xg;
    v[2] = yg;
    v[3] = zg;
    v[4] = dist * g;
    v[5] = apply_m * fabsf(new_g - g);
    if constexpr (FAST) {
      v[6] = x * xg;
      v[7] = y * xg;
      v[8] = z * xg;
      v[9] = y * yg;
      v[10] = z * yg;
      v[11] = z * zg;
    }
    pw_tile_compact_sums<R>(k.vals, k.sstart, k.sdest, v,
                            (int)__ldcg(k.pl.pos + i), K, k.part);
  }
}

// Centered second moments of the mask about the centroids tab[0:3]
// (_mega_kernel's `m2_sweep`, fit_pallas.py:445-467), as compact partials.
__device__ void pw_fit_m2(const PwFitBlock& k) {
  int N = k.N, sp = k.sp;
  const float* P = k.P;
  const float* tab = k.tab;
  for (int tile = k.t0; tile < k.t1; ++tile) {
    size_t i = (size_t)tile * PW_TILE + threadIdx.x;
    int K = pw_tile_runs(tile, k.pl, k.sstart, k.sdest);
    int s = (int)P[5 * (size_t)N + i];
    float g = k.Gm[i];
    float dx = (P[i] - tab[s]) * g;
    float dy = (P[(size_t)N + i] - tab[sp + s]) * g;
    float dz = (P[2 * (size_t)N + i] - tab[2 * sp + s]) * g;
    float v[6] = {dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz};
    pw_tile_compact_sums<6>(k.vals, k.sstart, k.sdest, v,
                            (int)__ldcg(k.pl.pos + i), K, k.part);
  }
}

// The chains of the block's nodes over RC rows of the partials into dst
// (nloc, RC) in shared memory.  Ends with a barrier of the block.
template <int RC>
__device__ void pw_fit_chains(const PwFitBlock& k, float* dst) {
  for (int j = threadIdx.x; j < k.nloc * RC; j += PW_TILE) {
    int q = j / RC, r = j - q * RC;
    int s = k.g + q * k.G;
    dst[j] = pw_chain(k.part, __ldcg(k.pl.node_off + s),
                      __ldcg(k.pl.node_off + s + 1), RC, r);
  }
  __syncthreads();
}

// Rows [r0, r1) of the scan's table into the block's copy in shared memory.
__device__ void pw_fit_read_table(const PwFitBlock& k, int r0, int r1) {
  for (int j = r0 * k.sp + threadIdx.x; j < r1 * k.sp; j += PW_TILE)
    k.tab[j] = __ldcg(k.tabg + j);
}

template <bool FAST>
__global__ void __launch_bounds__(PW_TILE, 5)
    pw_fit_level_kernel(PwFitArgs a) {
  constexpr int R = FAST ? 12 : 6;
  extern __shared__ float sh[];
  int N = a.N, sp = a.sp, G = a.G, nt = N / PW_TILE;
  int b = blockIdx.x / G, g = blockIdx.x % G, t = threadIdx.x;
  int nloc_max = (sp + G - 1) / G;
  PwFitBlock k;
  k.vals = sh;
  k.tab = k.vals + R * PW_TILE;
  float* m1s = k.tab + 7 * sp;               // (nloc, R) sums of the block's nodes
  float* m2s = m1s + nloc_max * R;           // (nloc, 6), exact mode
  k.sstart = (int*)(m2s + (FAST ? 0 : nloc_max * 6));
  k.sdest = k.sstart + PW_TILE + 1;
  int* iw = k.sdest + PW_TILE;               // PW_PLAN_SMEM_INTS
  k.P = a.p + (size_t)b * 8 * N;
  k.Gm = a.g + (size_t)b * N;
  k.pl = pw_plan_scan_of(a.plan, b, N, sp, a.cap);
  k.part = a.partial + (size_t)b * a.cap * R;
  k.tabg = a.tab + (size_t)b * 7 * sp;
  k.t0 = (int)((long long)g * nt / G);
  k.t1 = (int)((long long)(g + 1) * nt / G);
  k.g = g;
  k.G = G;
  k.nloc = g < sp ? (sp - g + G - 1) / G : 0;
  k.N = N;
  k.sp = sp;
  int* bar = a.bar + b;
  int* flag = a.flag + b;
  int epoch = 0;

  // the seeded mask and the plan of the block's tiles
  const float* g0 = a.g0 + (size_t)b * N;
  for (int tile = k.t0; tile < k.t1; ++tile) {
    size_t i = (size_t)tile * PW_TILE + t;
    k.Gm[i] = g0[i];
    pw_plan_tile(k.P + 5 * (size_t)N, tile, nt, k.pl, iw);
  }
  pw_scan_barrier(bar, G, &epoch);
  if (g == 0) pw_plan_offsets(nt, sp, k.pl, iw);
  pw_scan_barrier(bar, G, &epoch);
  for (int tile = k.t0; tile < k.t1; ++tile)
    pw_plan_places(tile, nt, k.pl);
  for (int j = t; j < 7 * sp; j += PW_TILE) k.tab[j] = 0.f;
  pw_scan_barrier(bar, G, &epoch);

  // sweep 0 is the seeded moments (zero table, can = 0); then the loop of
  // fit_pallas.py:487-514
  bool with_can = false, last_fit = false;
  int sweep = 0;
  for (int it = 0;; ++sweep) {
    pw_fit_apply<FAST>(k, with_can);
    pw_scan_barrier(bar, G, &epoch);
    // the block's nodes: sums, changed flag, centroid, gcnt >= 3 and, in
    // fast mode, the normal (make_tab, fit_pallas.py:472-485)
    pw_fit_chains<R>(k, m1s);
    for (int q = t; q < k.nloc; q += PW_TILE) {
      int s = g + q * G;
      const float* m = m1s + q * R;
      if (m[5] > 0.f) *(volatile int*)flag = sweep;
      float n = pw_clamp_lo(m[0], 1.f);
      k.tabg[s] = m[1] / n;
      k.tabg[sp + s] = m[2] / n;
      k.tabg[2 * sp + s] = m[3] / n;
      k.tabg[6 * sp + s] = m[0] >= 3.f ? 1.f : 0.f;
      if constexpr (FAST) {
        float c[6];
        pw_centered_m2(m, 1, 0, c);
        pw_normal(c, m[0], &k.tabg[3 * sp + s], &k.tabg[4 * sp + s],
                  &k.tabg[5 * sp + s]);
      }
    }
    pw_scan_barrier(bar, G, &epoch);
    if (last_fit) break;
    bool changed = sweep == 0 || __ldcg(flag) == sweep;
    if (!changed) break;
    // a max_iter exit fits the mask once more with can = 0
    with_can = it < a.max_iter;
    last_fit = !with_can;
    ++it;
    if constexpr (FAST) {
      pw_fit_read_table(k, 0, 7);
      __syncthreads();
    } else {
      pw_fit_read_table(k, 0, 3);
      __syncthreads();
      pw_fit_m2(k);
      pw_scan_barrier(bar, G, &epoch);
      pw_fit_chains<6>(k, m2s);
      for (int q = t; q < k.nloc; q += PW_TILE) {
        int s = g + q * G;
        pw_normal(m2s + q * 6, m1s[q * R], &k.tabg[3 * sp + s],
                  &k.tabg[4 * sp + s], &k.tabg[5 * sp + s]);
      }
      pw_scan_barrier(bar, G, &epoch);
      pw_fit_read_table(k, 3, 7);
      __syncthreads();
    }
  }
  if (g == 0 && t == 0) a.sweeps[b] = sweep + 1;
  float* O = a.stats + (size_t)b * 8 * sp;
  for (int q = t; q < k.nloc; q += PW_TILE) {
    int s = g + q * G;
#pragma unroll
    for (int r = 0; r < 8; ++r) O[r * sp + s] = r < 6 ? m1s[q * R + r] : 0.f;
  }
}

template <bool FAST>
static int pw_fit_smem_bytes(int sp) {
  // the node sums are sized for one block per scan (every node its own)
  int R = FAST ? 12 : 6;
  int floats = R * PW_TILE + 7 * sp + sp * R + (FAST ? 0 : sp * 6);
  return (floats + 2 * PW_TILE + 1 + PW_PLAN_SMEM_INTS) * 4;
}

// The blocks a scan gets when the caller names none: the co-resident blocks
// of the card divided by B, at most one per tile.  < 0: -(CUDA error).
template <bool FAST>
static int pw_fit_auto_blocks(int B, int N, int sp) {
  int smem = pw_fit_smem_bytes<FAST>(sp), dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      pw_fit_level_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pw_fit_level_kernel<FAST>, PW_TILE, smem);
  if (e != cudaSuccess) return -(int)e;
  int G = sms * per_sm / B;
  G = G < N / PW_TILE ? G : N / PW_TILE;
  return G > 1 ? G : 1;
}

template <bool FAST>
static int pw_fit_level_launch(PwFitArgs a, int B, cudaStream_t st) {
  if (a.G <= 0) a.G = pw_fit_auto_blocks<FAST>(B, a.N, a.sp);
  if (a.G < 0) return -a.G;
  int smem = pw_fit_smem_bytes<FAST>(a.sp);
  cudaError_t e = cudaFuncSetAttribute(
      pw_fit_level_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  // refused (and never run) where B * G blocks cannot be resident together
  e = cudaLaunchCooperativeKernel((const void*)pw_fit_level_kernel<FAST>,
                                  dim3(B * a.G), dim3(PW_TILE), args, smem,
                                  st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// blocks: blocks per scan, 0 for the card's co-resident blocks / B.  bitmap,
// flag and bar are zeroed by the caller; sweeps (B,) gets the apply sweeps
// each scan ran (an exact fit runs one moments sweep less).
PW_EXPORT int pw_fit_level(const float* p, const float* g0, float* g,
                           float* stats, unsigned char* pos,
                           unsigned char* start, int* tile_node, int* tile_off,
                           unsigned* bitmap, int* node_off, int* dest,
                           float* partial, float* tab, int* flag, int* bar,
                           int* sweeps, int B, int N, int sp, int cap,
                           int max_iter, int fast, int blocks, void* stream) {
  PwFitArgs a = {p, g0, g, stats,
                 {pos, start, tile_node, tile_off, bitmap, node_off, dest},
                 partial, tab, flag, bar, sweeps, N, sp, cap, max_iter, blocks};
  cudaStream_t st = (cudaStream_t)stream;
  return fast ? pw_fit_level_launch<true>(a, B, st)
              : pw_fit_level_launch<false>(a, B, st);
}

// Blocks per scan of an automatic launch (> 0), or -(CUDA error).
PW_EXPORT int pw_fit_level_blocks(int B, int N, int sp, int fast) {
  return fast ? pw_fit_auto_blocks<true>(B, N, sp)
              : pw_fit_auto_blocks<false>(B, N, sp);
}

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
// The same device code, with LEVEL set, is the fit loop of the level path
// (fit_pallas.py level_megakernel -> _level_kernel, the while-loop at
// 1357-1425; pw_level_fit below).  It reads the level layout: pts (B, 8, N)
// rows [x, y, z, ...], the node id in state row 3 and the mask in state row
// 0, which it updates in place.  There a point may change where its node is
// live and fitting (act * can, act = seg < trash, can = fit[s] * (gcnt >=
// 3)), tau is per node, every sum carries the factor act (the trash column
// is that of apply_sweep_plain, not the parked points' sums), and the first
// sums are seed_init's, handed in as m1 (B, R, Sp): sweep 0 is not run.  It
// returns all R rows of the final sums, (B, R, Sp), as the apply sweep does.
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
  const float* g0;  // fit layout: the seeded mask; level layout: unused
  float* g;         // fit layout: mask (B, 1, N); level layout: state (B, 4, N)
  float* stats;
  const float* m1;  // level layout: seed_init's sums (B, R, sp)
  const float* fit; // level layout: (B, sp) 0/1, the nodes that fit
  const float* tau; // level layout: (B, sp) tau per node
  PwPlan plan;
  float* partial;   // (B, cap, R) compact tile partials
  float* tab;       // (B, 7, sp) [cx, cy, cz, nx, ny, nz, gcnt >= 3]
  int* flag;        // (B,) number of the last sweep that changed the mask
  int* bar;         // (B,) arrivals at the scan's barrier, zeroed
  int* sweeps;      // (B,) out: apply sweeps the scan ran
  int N, sp, cap, max_iter, G;
  int trash;        // level layout: ids below it are live
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
  const float* segrow;  // the scan's node ids as floats
  PwPlan pl;
  float* part;      // the scan's partials
  float* tabg;      // the scan's table in device memory
  float* vals;      // shared: R * PW_TILE staged rows
  float* tab;       // shared: (7, sp); level layout (8, sp), row 7 tau
  int* sstart;      // shared: PW_TILE + 1
  int* sdest;       // shared: PW_TILE
  int t0, t1;       // its tiles
  int g, G, nloc;   // its nodes are g + q * G, q < nloc
  int N, sp;
  float trash;      // level layout
};

// Apply sweep over the block's tiles with the table in shared memory
// (_mega_kernel's `sweep`, fit_pallas.py:405-443): re-threshold where
// amask * can, write the mask, write the tiles' compact partials.  LEVEL:
// the level kernel's `sweep` (fit_pallas.py:1305-1336), the expressions of
// pw_apply_kernel (sweeps.cu) term for term.
template <bool FAST, bool LEVEL>
__device__ void pw_fit_apply(const PwFitBlock& k, bool with_can) {
  constexpr int R = FAST ? 12 : 6;
  int N = k.N, sp = k.sp;
  const float* P = k.P;
  const float* tab = k.tab;
  for (int tile = k.t0; tile < k.t1; ++tile) {
    size_t i = (size_t)tile * PW_TILE + threadIdx.x;
    int K = pw_tile_runs(tile, k.pl, k.sstart, k.sdest);
    float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
    float segf = k.segrow[i];
    int s = (int)segf;
    // am: who may change at all; the level layout's is its activity
    float tau, am;
    if constexpr (LEVEL) {
      tau = tab[7 * sp + s];
      am = segf < k.trash ? 1.f : 0.f;
    } else {
      tau = P[3 * (size_t)N + i];
      am = P[4 * (size_t)N + i];
    }
    float g = k.Gm[i];
    float dx = x - tab[s], dy = y - tab[sp + s], dz = z - tab[2 * sp + s];
    float dist = fabsf(dx * tab[3 * sp + s] + dy * tab[4 * sp + s] +
                       dz * tab[5 * sp + s]);
    float apply_m = am * (with_can ? tab[6 * sp + s] : 0.f);
    float new_g = dist < tau ? 1.f : 0.f;
    float g2 = apply_m * new_g + (1.f - apply_m) * g;
    k.Gm[i] = g2;
    float gm = LEVEL ? g2 * am : g2;
    float xg = x * gm, yg = y * gm, zg = z * gm;
    float v[R];
    v[0] = gm;
    v[1] = xg;
    v[2] = yg;
    v[3] = zg;
    v[4] = LEVEL ? dist * g * am : dist * g;
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
// LEVEL: of the live mask (the level kernel's, fit_pallas.py:1338-1355).
template <bool LEVEL>
__device__ void pw_fit_m2(const PwFitBlock& k) {
  int N = k.N, sp = k.sp;
  const float* P = k.P;
  const float* tab = k.tab;
  for (int tile = k.t0; tile < k.t1; ++tile) {
    size_t i = (size_t)tile * PW_TILE + threadIdx.x;
    int K = pw_tile_runs(tile, k.pl, k.sstart, k.sdest);
    float segf = k.segrow[i];
    int s = (int)segf;
    float g = k.Gm[i];
    if constexpr (LEVEL) g = g * (segf < k.trash ? 1.f : 0.f);
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

template <bool FAST, bool LEVEL>
__global__ void __launch_bounds__(PW_TILE, 5)
    pw_fit_level_kernel(PwFitArgs a) {
  constexpr int R = FAST ? 12 : 6;
  constexpr int TR = LEVEL ? 8 : 7;          // rows of the shared table
  extern __shared__ float sh[];
  int N = a.N, sp = a.sp, G = a.G, nt = N / PW_TILE;
  int b = blockIdx.x / G, g = blockIdx.x % G, t = threadIdx.x;
  int nloc_max = (sp + G - 1) / G;
  PwFitBlock k;
  k.vals = sh;
  k.tab = k.vals + R * PW_TILE;
  float* m1s = k.tab + TR * sp;              // (nloc, R) sums of the block's nodes
  float* m2s = m1s + nloc_max * R;           // (nloc, 6), exact mode
  k.sstart = (int*)(m2s + (FAST ? 0 : nloc_max * 6));
  k.sdest = k.sstart + PW_TILE + 1;
  int* iw = k.sdest + PW_TILE;               // PW_PLAN_SMEM_INTS
  k.P = a.p + (size_t)b * 8 * N;
  k.Gm = a.g + (size_t)b * (LEVEL ? 4 : 1) * N;
  k.segrow = LEVEL ? k.Gm + 3 * (size_t)N : k.P + 5 * (size_t)N;
  k.trash = (float)a.trash;
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

  // the seeded mask (the level layout's is in place already) and the plan
  // of the block's tiles
  for (int tile = k.t0; tile < k.t1; ++tile) {
    if constexpr (!LEVEL) {
      size_t i = (size_t)tile * PW_TILE + t;
      k.Gm[i] = a.g0[(size_t)b * N + i];
    }
    pw_plan_tile(k.segrow, tile, nt, k.pl, iw);
  }
  pw_scan_barrier(bar, G, &epoch);
  if (g == 0) pw_plan_offsets(nt, sp, k.pl, iw);
  pw_scan_barrier(bar, G, &epoch);
  for (int tile = k.t0; tile < k.t1; ++tile)
    pw_plan_places(tile, nt, k.pl);
  if constexpr (LEVEL) {
    for (int j = t; j < sp; j += PW_TILE)
      k.tab[7 * sp + j] = a.tau[(size_t)b * sp + j];
  } else {
    for (int j = t; j < 7 * sp; j += PW_TILE) k.tab[j] = 0.f;
  }
  pw_scan_barrier(bar, G, &epoch);

  // sweep 0 is the seeded moments (zero table, can = 0; the level layout
  // is handed seed_init's sums instead); then the loop of
  // fit_pallas.py:487-514
  bool with_can = false, last_fit = false;
  int sweep = 0;
  for (int it = 0;; ++sweep) {
    if (LEVEL && sweep == 0) {
      const float* M1 = a.m1 + (size_t)b * R * sp;
      for (int j = t; j < k.nloc * R; j += PW_TILE) {
        int q = j / R, r = j - q * R;
        m1s[j] = M1[r * sp + g + q * G];
      }
      __syncthreads();
    } else {
      pw_fit_apply<FAST, LEVEL>(k, with_can);
      pw_scan_barrier(bar, G, &epoch);
      pw_fit_chains<R>(k, m1s);
    }
    // the block's nodes: sums, changed flag, centroid, can and, in fast
    // mode, the normal (make_tab, fit_pallas.py:472-485 and 1357-1369)
    for (int q = t; q < k.nloc; q += PW_TILE) {
      int s = g + q * G;
      const float* m = m1s + q * R;
      if (m[5] > 0.f) *(volatile int*)flag = sweep;
      float n = pw_clamp_lo(m[0], 1.f);
      k.tabg[s] = m[1] / n;
      k.tabg[sp + s] = m[2] / n;
      k.tabg[2 * sp + s] = m[3] / n;
      float can = m[0] >= 3.f ? 1.f : 0.f;
      if constexpr (LEVEL) can = a.fit[(size_t)b * sp + s] * can;
      k.tabg[6 * sp + s] = can;
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
      pw_fit_m2<LEVEL>(k);
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
  // the level layout ran no sweep 0
  if (g == 0 && t == 0) a.sweeps[b] = LEVEL ? sweep : sweep + 1;
  constexpr int RO = LEVEL ? R : 8;          // rows of the sums handed back
  float* O = a.stats + (size_t)b * RO * sp;
  for (int q = t; q < k.nloc; q += PW_TILE) {
    int s = g + q * G;
#pragma unroll
    for (int r = 0; r < RO; ++r)
      O[r * sp + s] = (LEVEL || r < 6) ? m1s[q * R + r] : 0.f;
  }
}

// smem, everywhere below: the dynamic shared memory of one block in bytes,
// fit_cuda.fit_level_smem_bytes(sp, fast, level), which sizes the kernel's
// carve-up above (the node sums for one block per scan).  Above what the
// card grants a block, cudaFuncSetAttribute refuses it.

// The blocks a scan gets when the caller names none: the co-resident blocks
// of the card divided by B, at most one per tile.  < 0: -(CUDA error).
template <bool FAST, bool LEVEL>
static int pw_fit_auto_blocks(int B, int N, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      pw_fit_level_kernel<FAST, LEVEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pw_fit_level_kernel<FAST, LEVEL>, PW_TILE, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  int G = sms * per_sm / B;
  G = G < N / PW_TILE ? G : N / PW_TILE;
  return G > 1 ? G : 1;
}

template <bool FAST, bool LEVEL>
static int pw_fit_level_launch(PwFitArgs a, int B, int smem, cudaStream_t st) {
  // sets the kernel's shared-memory attribute too
  int G = pw_fit_auto_blocks<FAST, LEVEL>(B, a.N, smem);
  if (G < 0) return -G;
  if (a.G <= 0) a.G = G;
  void* args[] = {&a};
  // refused (and never run) where B * G blocks cannot be resident together
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pw_fit_level_kernel<FAST, LEVEL>, dim3(B * a.G),
      dim3(PW_TILE), args, smem, st);
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
                           int max_iter, int fast, int blocks, int smem,
                           void* stream) {
  PwFitArgs a = {p, g0, g, stats, nullptr, nullptr, nullptr,
                 {pos, start, tile_node, tile_off, bitmap, node_off, dest},
                 partial, tab, flag, bar, sweeps, N, sp, cap, max_iter, blocks,
                 0};
  cudaStream_t st = (cudaStream_t)stream;
  return fast ? pw_fit_level_launch<true, false>(a, B, smem, st)
              : pw_fit_level_launch<false, false>(a, B, smem, st);
}

// The level path's fit loop in one launch: pts (B, 8, N), state (B, 4, N)
// (row 0, the mask, updated in place; row 3 the node ids), m1 (B, R, sp)
// seed_init's sums, fit and tau (B, sp); stats (B, R, sp) gets the final
// sums, R = 12 in fast mode, else 6.  The rest as pw_fit_level.
PW_EXPORT int pw_level_fit(const float* pts, float* state, const float* m1,
                           const float* fit, const float* tau, float* stats,
                           unsigned char* pos, unsigned char* start,
                           int* tile_node, int* tile_off, unsigned* bitmap,
                           int* node_off, int* dest, float* partial,
                           float* tab, int* flag, int* bar, int* sweeps, int B,
                           int N, int sp, int cap, int trash, int max_iter,
                           int fast, int blocks, int smem, void* stream) {
  PwFitArgs a = {pts, nullptr, state, stats, m1, fit, tau,
                 {pos, start, tile_node, tile_off, bitmap, node_off, dest},
                 partial, tab, flag, bar, sweeps, N, sp, cap, max_iter, blocks,
                 trash};
  cudaStream_t st = (cudaStream_t)stream;
  return fast ? pw_fit_level_launch<true, true>(a, B, smem, st)
              : pw_fit_level_launch<false, true>(a, B, smem, st);
}

// Blocks per scan of an automatic launch (> 0), or -(CUDA error); level:
// of pw_level_fit, else of pw_fit_level.
PW_EXPORT int pw_fit_level_blocks(int B, int N, int fast, int level,
                                  int smem) {
  if (level)
    return fast ? pw_fit_auto_blocks<true, true>(B, N, smem)
                : pw_fit_auto_blocks<false, true>(B, N, smem);
  return fast ? pw_fit_auto_blocks<true, false>(B, N, smem)
              : pw_fit_auto_blocks<false, false>(B, N, smem);
}

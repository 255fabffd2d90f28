// One level's whole plane-fit loop in one launch, across the whole card;
// and one engine level, its phases around the fit included, in one launch.
//
// pw_fit_level replaces patchwork_tpu/kernels/fit_pallas.py
// fit_level_megakernel -> _mega_kernel (399-514, wrapper 523-560): a
// moments sweep of the seeded mask (can = 0), then, while the mask changed
// and it < max_iter, a plane table (centroid, _plane_rows normal, can = gcnt
// >= 3) and an apply sweep (exact mode adds a centered-moment sweep per
// table; fast mode accumulates 12 rows and centers them with _centered_m2);
// the final can = 0 sweep runs only on a max_iter exit.  The generic level
// engine takes it through _fused_fit_resid (segment/engine.py) where the
// fit gate admits the level.  Points use the fit layout p (B, 8, N) rows
// [x, y, z, tau, amask, seg, 0, 0] and a mask g (B, 1, N); stats (B, 8, Sp)
// rows [cnt, sx, sy, sz, distsum (old mask), changed, 0, 0].
//
// pw_level_core replaces fit_pallas.py level_megakernel -> _level_kernel
// (789-1462, wrapper 1465-1558), which the TPU runs as one launch a level:
// one co-operative launch runs, in order, R3-R5 of a remap level (the
// child-slot prefix in block 0 of the scan, then each block remaps its own
// tiles), the sweep plan of the new node ids and node stats (integer
// atomics into a shared table per block, then into the scan's table), the
// early-outs (by each node's owner), min_seed deficient rounds (only in a
// scan with a deficient node, a decision every block of the scan reads
// after the same barrier), the labels and seeds with their sums as sweep 0,
// the fit loop, the split decision (by the owners) and the finish (each
// block over its tiles).  The per-phase device code is level.cuh's, shared
// with the phase kernels of level.cu.  The level layout: pts (B, 8, N) rows
// [x, y, z, seg, ground, done, index, 0] (seg the parent id on a remap
// level), the node id in state row 3 and the mask in state row 0, updated
// in place.  There a point may change where its node is live and fitting
// (act * can, act = seg < trash, can = fit[s] * (gcnt >= 3)), tau is per
// node and every sum carries the factor act (the trash column is that of
// apply_sweep_plain).  Sweep 0 stages the seed rows themselves, [gm, x gm,
// y gm, z gm, 0, 0] (and six products in fast mode): a zero-table apply
// sweep would give NaN where a coordinate is not finite.  Percentile seeds
// (fit_cuda.level_core's nstats): node stats and, on a remap level, R3-R5
// ran as launches of their own ahead of it, and the launch starts at the
// early-outs.
//
// The TPU keeps the whole cloud in VMEM and sums with bf16x3 one-hot
// matmuls on one core.  Here the loop is bound by latency, not by bytes: a
// sweep moves 32 bytes a point, but up to 101 sweeps follow one another and
// each needs every node's sums of the one before; the phases around it are
// one pass over the points each and a few per-node steps, which as launches
// of their own cost a launch and a host call each.  So every scan gets G
// blocks of PW_TILE threads that are resident together (a co-operative
// launch, G = the card's co-resident blocks / B, at most one per tile) and
// loop on the device, with one barrier per scan in device memory between
// the phases: no host read, and each scan leaves the loop on its own.  A
// co-operative launch with per-scan barriers was taken over a thread-block
// cluster per scan because a cluster holds at most 16 blocks, which leaves
// 116 of 132 SMs idle at B = 1, while the barrier serves any G.
//
// A block owns a contiguous range of tiles for the whole launch, so a
// point's state is read and written by one thread only.  The sweep plan
// (tile_sums.cuh) is built in the kernel, the node ids being fixed.  Per
// sweep each block writes its tiles' compact partials (they stay in the
// L2, a node's next to each other); after the barrier node s, owned by
// block s % G, gets its chain in tile order, its centroid and normal (one
// acosf per node and table, by the owner only) and its table row; after the
// next barrier every block reads the table into shared memory and sweeps
// again.  Sums keep the sweeps' order, so the kernels equal their plain
// versions (fit_cuda.fit_level_plain, fit_cuda.level_core_plain) bit for
// bit, run after run, and a scan's result does not depend on the batch it
// is in.
//
// What one block writes and another reads (partials, tables, flags, plan)
// is read with __ldcg after a __threadfence and the barrier.
//
// A block walks its tiles in sequence with plain coalesced loads.  A ring of
// tiles in shared memory filled by asynchronous copies (the next tile in
// flight during the sums of the one before, a share of one or two tiles
// kept for the whole launch) was built and measured: the exact fit got
// slower under this kernel's 48-register cap and the fast fit gained 3-6 %,
// so it was not kept.  The barriers, the chains and the in-order runs bound
// an iteration, not the loads.
#include "common.cuh"
#include "level.cuh"
#include "tile_sums.cuh"

// What the level layout takes beyond the fit's arguments.
struct PwLevelArgs {
  const float* tz;       // (B, 2, sp) tau and zth handed in, or null
  const float* nstats;   // (B, 8, sp) node stats handed in, or null
  float* pnode;          // (B, 4, sp) scratch: R3's parent rows
  float* flags;          // (B, 5, sp) scratch: the early-out flags
  float* ns;             // (B, 8, sp) scratch: the node stats as floats
  unsigned* work;        // (B, 8, sp) zeroed: node stats as counts, keys
  int* any_def;          // (B,) zeroed
  unsigned* def;         // (min_seed, B, 2, sp) zeroed: the rounds' minima
  int B, is_level0, min_seed, flat_minpts;
  float flat_area, flat_dz;
};

// The fields the fit layout reads keep their places (ptxas allocates the
// fit layout's registers by them: moved, the same code ran 3 % slower).
struct PwFitArgs {
  const float* p;   // fit layout: (B, 8, N) fit rows; level layout: pts
  const float* g0;  // fit layout: the seeded mask; level layout: unused
  float* g;         // fit layout: mask (B, 1, N); level layout: state (B, 4, N)
  float* stats;     // out: fit layout the final sums (B, 8, sp); level
                    // layout the level's stats (B, 8, sp)
  const float* tables;  // level layout: (B, 8, sp)
  const float* median;  // level layout, remap level: (B, sp), else null
  const float* axis;    // level layout, remap level: (B, sp)
  PwPlan plan;
  float* partial;   // (B, cap, R) compact tile partials
  float* tab;       // (B, 7, sp) [cx, cy, cz, nx, ny, nz, gcnt >= 3]
  int* flag;        // (B,) number of the last sweep that changed the mask
  int* bar;         // (B,) arrivals at the scan's barrier, zeroed
  int* sweeps;      // (B,) out: the sweeps the scan ran, sweep 0 included
  int N, sp, cap, max_iter, G;
  int trash;        // level layout: ids below it are live
  PwLevelArgs lv;   // level layout
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


// The level layout's phases before the fit (R3-R5, the plan, node stats,
// early-outs, deficient rounds) and after it (split decision, finish) are
// the level kernel's own; the fit loop, and the setup and plan around it,
// are shared with the fit layout, so the fit layout's code is that of the
// fit loop alone.
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

  // level layout: the scan's tables, its early-out flags, its stats out;
  // tau and zth (2, sp) handed in, R4's (written into O rows 5-6), or the
  // tables' rows 0-1
  const PwLevelArgs& L = a.lv;
  int trash = a.trash;
  float* S = k.Gm;
  const float* T = LEVEL ? a.tables + (size_t)b * 8 * sp : nullptr;
  float* O = a.stats + (size_t)b * 8 * sp;
  float* F = LEVEL ? L.flags + (size_t)b * 5 * sp : nullptr;
  const float* TZ = L.tz ? L.tz + (size_t)b * 2 * sp
                         : (a.median ? O + 5 * sp : T);
  bool count = LEVEL && L.nstats == nullptr;
  const float* NS = LEVEL ? (count ? L.ns : L.nstats) + (size_t)b * 8 * sp
                          : nullptr;
  unsigned* st = (unsigned*)k.tab;           // node stats, before the fit

  if constexpr (LEVEL) {
    // R3 + R4 in block 0, then R5 over the block's tiles
    if (a.median) {
      float* Q = L.pnode + (size_t)b * 4 * sp;
      if (g == 0)
        pw_remap_nodes_block(T, a.median + (size_t)b * sp,
                             a.axis + (size_t)b * sp, Q, O + 5 * sp, sp,
                             trash, iw + 3 * PW_TILE);
      pw_scan_barrier(bar, G, &epoch);
      for (int tile = k.t0; tile < k.t1; ++tile)
        pw_remap_point(k.P, S, Q, N, (size_t)tile * PW_TILE + t, sp, trash);
    }
    if (count)
      for (int j = t; j < 8 * sp; j += PW_TILE) st[j] = 0u;
  }

  // the seeded mask (the level layout's is seeded below) and the plan of
  // the block's tiles; the level layout's node stats of its tiles, in a
  // shared table (the table's rows, free until the fit) merged into the
  // scan's
  for (int tile = k.t0; tile < k.t1; ++tile) {
    size_t i = (size_t)tile * PW_TILE + t;
    if constexpr (!LEVEL) k.Gm[i] = a.g0[(size_t)b * N + i];
    pw_plan_tile(k.segrow, tile, nt, k.pl, iw);
    if (count) pw_stats_point(k.P, S, TZ + sp, st, N, i, sp, trash);
  }
  if (count) {
    __syncthreads();
    pw_stats_merge(st, L.work + (size_t)b * 8 * sp, sp);
  }
  pw_scan_barrier(bar, G, &epoch);
  if (g == 0) pw_plan_offsets(nt, sp, k.pl, iw);
  if constexpr (LEVEL) {
    // the block's nodes: their stats and early-outs
    for (int q = t; q < k.nloc; q += PW_TILE) {
      int s = g + q * G;
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (count) {
          v[r] = pw_stats_value(L.work + (size_t)b * 8 * sp, sp, r, s);
          L.ns[((size_t)b * 8 + r) * sp + s] = v[r];
        } else {
          v[r] = NS[r * sp + s];
        }
      }
      if (pw_early_out_node(v, T[2 * sp + s], __ldcg(TZ + sp + s), F, sp, s,
                            L.is_level0, L.flat_area, L.flat_dz,
                            L.flat_minpts, L.min_seed))
        atomicOr(L.any_def + b, 1);
    }
  }
  pw_scan_barrier(bar, G, &epoch);
  for (int tile = k.t0; tile < k.t1; ++tile)
    pw_plan_places(tile, nt, k.pl);
  if constexpr (LEVEL) {
    for (int j = t; j < sp; j += PW_TILE) k.tab[7 * sp + j] = __ldcg(TZ + j);
    // the deficient rounds, in a scan with a deficient node
    if (__ldcg(L.any_def + b)) {
      for (int r = 0; r < L.min_seed; ++r) {
        unsigned* D = L.def + ((size_t)r * L.B + b) * 2 * sp;
        for (int tile = k.t0; tile < k.t1; ++tile)
          pw_def_min_point(k.P, S, F, D, N, (size_t)tile * PW_TILE + t, sp,
                           trash);
        pw_scan_barrier(bar, G, &epoch);
        for (int tile = k.t0; tile < k.t1; ++tile)
          pw_def_imin_point(k.P, S, F, D, N, (size_t)tile * PW_TILE + t, sp,
                            trash);
        pw_scan_barrier(bar, G, &epoch);
        for (int tile = k.t0; tile < k.t1; ++tile)
          pw_def_pick_point(k.P, S, F, D, N, (size_t)tile * PW_TILE + t, sp,
                            trash);
      }
    }
  } else {
    for (int j = t; j < 7 * sp; j += PW_TILE) k.tab[j] = 0.f;
  }
  pw_scan_barrier(bar, G, &epoch);

  // sweep 0 is the seeded moments (the fit layout: a zero table, can = 0;
  // the level layout: the labels, seeds and their sums); then the loop of
  // fit_pallas.py:487-514 (the level layout's 1357-1425)
  bool with_can = false, last_fit = false;
  int sweep = 0;
  for (int it = 0;; ++sweep) {
    if (LEVEL && sweep == 0) {
      for (int tile = k.t0; tile < k.t1; ++tile) {
        size_t i = (size_t)tile * PW_TILE + t;
        int K = pw_tile_runs(tile, k.pl, k.sstart, k.sdest);
        float v[R];
        pw_seed_point<FAST>(k.P, S, F, N, i, sp, trash, v);
        pw_tile_compact_sums<R>(k.vals, k.sstart, k.sdest, v,
                                (int)__ldcg(k.pl.pos + i), K, k.part);
      }
    } else {
      pw_fit_apply<FAST, LEVEL>(k, with_can);
    }
    pw_scan_barrier(bar, G, &epoch);
    pw_fit_chains<R>(k, m1s);
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
      if constexpr (LEVEL) can = __ldcg(F + 2 * sp + s) * can;
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
  if (g == 0 && t == 0) a.sweeps[b] = sweep + 1;

  if constexpr (LEVEL) {
    // split decision by the owners, then the finish over the block's tiles
    for (int q = t; q < k.nloc; q += PW_TILE) {
      int s = g + q * G;
      pw_split_node(m1s[q * R], m1s[q * R + 4], __ldcg(F + 2 * sp + s),
                    NS[s], T, O, sp, s);
    }
    pw_scan_barrier(bar, G, &epoch);
    for (int tile = k.t0; tile < k.t1; ++tile)
      pw_finish_point(S, F + 2 * sp, O, N, (size_t)tile * PW_TILE + t,
                      trash);
    for (int q = t; q < k.nloc; q += PW_TILE) {
      int s = g + q * G;
      O[3 * sp + s] = NS[s];
      O[4 * sp + s] = NS[sp + s];
      if (!a.median) {
        O[5 * sp + s] = TZ[s];
        O[6 * sp + s] = TZ[sp + s];
      }
      O[7 * sp + s] = 0.f;
    }
  } else {
    for (int q = t; q < k.nloc; q += PW_TILE) {
      int s = g + q * G;
#pragma unroll
      for (int r = 0; r < 8; ++r) O[r * sp + s] = r < 6 ? m1s[q * R + r] : 0.f;
    }
  }
}

// smem, everywhere below: the dynamic shared memory of one block in bytes,
// fit_cuda.fit_level_smem_bytes(sp, fast, level), which sizes the kernels'
// carve-up above (the node sums for one block per scan).  Above what the
// card grants a block, cudaFuncSetAttribute refuses it.

static const void* pw_fit_kernel(int fast, int level) {
  if (level)
    return fast ? (const void*)pw_fit_level_kernel<true, true>
                : (const void*)pw_fit_level_kernel<false, true>;
  return fast ? (const void*)pw_fit_level_kernel<true, false>
              : (const void*)pw_fit_level_kernel<false, false>;
}

// The blocks a scan gets when the caller names none: the co-resident blocks
// of the card divided by B, at most one per tile.  < 0: -(CUDA error).
static int pw_fit_auto_blocks(const void* kernel, int B, int N, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      PW_TILE, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  int G = sms * per_sm / B;
  G = G < N / PW_TILE ? G : N / PW_TILE;
  return G > 1 ? G : 1;
}

static int pw_fit_launch(const void* kernel, PwFitArgs a, int B, int smem,
                         cudaStream_t st) {
  // sets the kernel's shared-memory attribute too
  int G = pw_fit_auto_blocks(kernel, B, a.N, smem);
  if (G < 0) return -G;
  if (a.G <= 0) a.G = G;
  void* args[] = {&a};
  // refused (and never run) where B * G blocks cannot be resident together
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(B * a.G),
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
  PwFitArgs a = {};
  a.p = p;
  a.g0 = g0;
  a.g = g;
  a.stats = stats;
  a.plan = {pos, start, tile_node, tile_off, bitmap, node_off, dest};
  a.partial = partial;
  a.tab = tab;
  a.flag = flag;
  a.bar = bar;
  a.sweeps = sweeps;
  a.N = N;
  a.sp = sp;
  a.cap = cap;
  a.max_iter = max_iter;
  a.G = blocks;
  return pw_fit_launch(pw_fit_kernel(fast, 0), a, B, smem,
                       (cudaStream_t)stream);
}

// One engine level in one launch: pts (B, 8, N), state (B, 4, N) (rows 0-2
// seeded from pts, row 3 the node ids unless median is given; updated in
// place), tables (B, 8, sp); median and axis (B, sp) on a remap level, else
// null; tz (B, 2, sp) and nstats (B, 8, sp) handed in, or null; out (B, 8,
// sp) the level's stats.  pnode, flags and ns are scratch (see
// PwLevelArgs), work, any_def and def zeroed scratch; the rest as
// pw_fit_level, R = 12 in fast mode, else 6.
PW_EXPORT int pw_level_core(
    const float* pts, float* state, const float* tables, const float* median,
    const float* axis, const float* tz, const float* nstats, float* out,
    unsigned char* pos, unsigned char* start, int* tile_node, int* tile_off,
    unsigned* bitmap, int* node_off, int* dest, float* partial, float* tab,
    float* pnode, float* flags, float* ns, unsigned* work, int* any_def,
    unsigned* def, int* flag, int* bar, int* sweeps, int B, int N, int sp,
    int cap, int trash, int max_iter, int fast, int blocks, int smem,
    int is_level0, int min_seed, int flat_minpts, float flat_area,
    float flat_dz, void* stream) {
  PwFitArgs a = {};
  a.p = pts;
  a.g = state;
  a.stats = out;
  a.tables = tables;
  a.median = median;
  a.axis = axis;
  a.plan = {pos, start, tile_node, tile_off, bitmap, node_off, dest};
  a.partial = partial;
  a.tab = tab;
  a.flag = flag;
  a.bar = bar;
  a.sweeps = sweeps;
  a.N = N;
  a.sp = sp;
  a.cap = cap;
  a.max_iter = max_iter;
  a.G = blocks;
  a.trash = trash;
  a.lv = {tz, nstats, pnode, flags, ns, work, any_def, def, B, is_level0,
          min_seed, flat_minpts, flat_area, flat_dz};
  return pw_fit_launch(pw_fit_kernel(fast, 1), a, B, smem,
                       (cudaStream_t)stream);
}

// Blocks per scan of an automatic launch (> 0), or -(CUDA error); level:
// of pw_level_core, else of pw_fit_level.
PW_EXPORT int pw_fit_level_blocks(int B, int N, int fast, int level,
                                  int smem) {
  return pw_fit_auto_blocks(pw_fit_kernel(fast, level), B, N, smem);
}

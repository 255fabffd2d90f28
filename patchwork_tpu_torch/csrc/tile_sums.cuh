// Tile plan and compact tile sums, shared by the apply sweep, the moments2
// sweep and the seed sweep (sweeps.cu, level.cu), the one-launch fit loop
// and level (fitloop.cu) and the segment sums of a segment binding
// (seg.cu); and the sum with no plan (pw_dense_sum_tile, at the end) of
// binning's segment sum and the remap's per-parent sums.
//
// The order of every per-node sum is fixed (common.cuh): inside a tile the
// points of node s are added in point order from +0.0, then the tiles'
// partials in tile order from +0.0.  A tile that holds no point of s adds
// +0.0, which changes no bit of a chain that starts at +0.0 (the chain never
// holds -0.0), so a node's chain may skip every tile without it.  The node
// ids are fixed for a whole fit (or a segment binding), so which nodes occur
// in which tile is found once, as a plan, and every sweep of the fit (every
// sum of the binding) reuses it:
//
//   pos      (B, N)     u8   a point's place in its tile once the tile is
//                            stably sorted by the first occurrence of its
//                            node (its "slot"); a node's points keep their
//                            point order and lie next to each other
//   start    (B, N)     u8   [tile * PW_TILE + k]: where slot k's run starts
//   tile_off (B, nt+1)  i32  prefix sums of the tiles' slot counts: slot k
//                            of a tile is entry tile_off[tile] + k
//   tile_node (B, N)    i32  [tile * PW_TILE + k]: slot k's node
//   node_off (B, sp+1)  i32  prefix sums of the nodes' entry counts
//   dest     (B, cap)   i32  an entry's place among all partials: those of
//                            node s lie from node_off[s] on, in tile order
//
// and, as build scratch, bitmap (B, sp, W) u32, zeroed by the caller: bit
// `tile` of node s is set where the tile holds s.  An entry's place among
// its node's is the count of set bits below the tile's, so the places come
// out in tile order without a sort and without an atomic that hands them
// out.  Where wpre (B, sp, W) is given, step 2 stores each word's count of
// set bits before it, so step 3 reads one count instead of counting a row
// (which, for a node in every tile, is most of the step's L2 traffic).
// Integer atomics (OR, ADD on counts) give the same result in any order.
//
// A sweep then stages each point's rows at vals[pos][r], one thread per
// (slot, row) adds its run in order and writes one float of the tile's K x R
// partials at the entry's place, and a chain per (node, row) adds that
// node's partials, which lie next to each other.  Nothing of size
// (tiles, R, Sp) exists.  All kernels here run PW_TILE threads a block.
#pragma once

#include "common.cuh"

struct PwPlan {
  unsigned char* pos;
  unsigned char* start;
  int* tile_node;
  int* tile_off;
  unsigned* bitmap;
  int* node_off;
  int* dest;
  int* wpre;    // null, or build scratch (B, sp, W): set bits before a word
};

// Shared-memory ints the plan's device functions need.
#define PW_PLAN_SMEM_INTS (3 * PW_TILE + 33)

// The plan of scan b.
__device__ __forceinline__ PwPlan pw_plan_scan_of(PwPlan p, int b, int N,
                                                  int sp, int cap) {
  int nt = N / PW_TILE, W = (nt + 31) / 32;
  p.pos += (size_t)b * N;
  p.start += (size_t)b * N;
  p.tile_node += (size_t)b * N;
  p.tile_off += (size_t)b * (nt + 1);
  p.bitmap += (size_t)b * sp * W;
  if (p.wpre) p.wpre += (size_t)b * sp * W;
  p.node_off += (size_t)b * (sp + 1);
  p.dest += (size_t)b * cap;
  return p;
}

// The plan's device functions read the plan with __ldcg, through the L2:
// inside fit_level another block of the same launch wrote it, and the L1
// and the read-only path are not coherent.

// Exclusive prefix sum of v over the block's PW_TILE threads; *total gets
// the block's sum.  ws: 33 shared ints.  Ends with a barrier.
__device__ __forceinline__ int pw_block_scan(int v, int* ws, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += n;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < PW_TILE / 32 ? ws[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int n = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += n;
    }
    ws[lane] = wi - w;
    if (lane == 31) ws[32] = wi;
  }
  __syncthreads();
  int res = inc - v + ws[warp];
  *total = ws[32];
  __syncthreads();
  return res;
}

// One tile's slots in shared memory: thread t holds the node id s of the
// tile's point t.  Slots follow first occurrence; the point's place in the
// tile stably sorted by slot is slot's run start plus its rank (earlier
// points of its node).  Leaves the runs' starts in iw[PW_TILE + k], k < K.
// iw: PW_PLAN_SMEM_INTS shared ints.  Ends with a barrier.
struct PwSlots {
  int pos;    // the point's place
  int slot;   // its node's slot
  int rank;   // earlier points of its node in the tile
  int K;      // the tile's slot count
  int st;     // for t < K: where slot t's run starts
};

__device__ __forceinline__ PwSlots pw_tile_slots(int s, int* iw) {
  int* segs = iw;
  int* slots = iw + PW_TILE;
  int* cnt = iw + 2 * PW_TILE;
  int* ws = iw + 3 * PW_TILE;
  int t = threadIdx.x;
  segs[t] = s;
  cnt[t] = 0;
  __syncthreads();
  PwSlots q;
  int first = t;
  q.rank = 0;
  for (int u = 0; u < t; ++u) {
    if (segs[u] == s) {
      if (q.rank == 0) first = u;
      ++q.rank;
    }
  }
  q.slot = pw_block_scan(q.rank == 0 ? 1 : 0, ws, &q.K);
  if (q.rank == 0) slots[t] = q.slot;
  __syncthreads();
  q.slot = slots[first];
  atomicAdd(&cnt[q.slot], 1);
  __syncthreads();
  int total;
  q.st = pw_block_scan(t < q.K ? cnt[t] : 0, ws, &total);
  slots[t] = q.st;          // every thread read slots[first] two barriers ago
  __syncthreads();
  q.pos = slots[q.slot] + q.rank;
  return q;
}

// Ids below which pw_tile_slots_table's table (4 bytes an id) is used.
#define PW_SLOT_TABLE_MAX 8192

// pw_tile_slots with a shared table of one int per id (ids < its length) in
// place of the walk over earlier points, which costs a thread up to 255
// shared reads: the warps take turns, the lanes of a warp that hold one
// node rank among themselves by one match, and the node's count so far
// comes from the table.  The same places, slots and runs.
__device__ __forceinline__ PwSlots pw_tile_slots_table(int s, int* iw,
                                                       int* table) {
  int* slots = iw + PW_TILE;
  int* cnt = iw + 2 * PW_TILE;
  int* ws = iw + 3 * PW_TILE;
  int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  table[s] = 0;
  __syncthreads();
  unsigned peers = __match_any_sync(0xffffffffu, s);
  int below = __popc(peers & ((1u << lane) - 1u));
  PwSlots q;
  for (int w = 0; w < PW_TILE / 32; ++w) {
    if (warp == w) {
      q.rank = table[s] + below;
      __syncwarp();
      if (below == 0) table[s] = q.rank + __popc(peers);
    }
    __syncthreads();
  }
  int total = table[s];          // the node's points in the tile
  q.slot = pw_block_scan(q.rank == 0 ? 1 : 0, ws, &q.K);
  if (q.rank == 0) {
    table[s] = q.slot;
    cnt[q.slot] = total;
  }
  __syncthreads();
  q.slot = table[s];
  int all;
  q.st = pw_block_scan(t < q.K ? cnt[t] : 0, ws, &all);
  slots[t] = q.st;
  __syncthreads();
  q.pos = slots[q.slot] + q.rank;
  return q;
}

// Plan, step 1 of 3, one tile: slots in order of first occurrence, each
// point's place, the runs' starts, the slot count (left in tile_off[tile+1]
// for step 2) and the nodes' tile bits.  segrow: the scan's node ids, as
// floats (a row of the sweeps' state) or as ints (a segment binding).
// iw: PW_PLAN_SMEM_INTS shared ints; table: null, or a shared int per id
// (pw_tile_slots_table).
template <typename Id>
__device__ __forceinline__ void pw_plan_tile(const Id* segrow, int tile,
                                             int nt, PwPlan pl, int* iw,
                                             int* table = nullptr) {
  int t = threadIdx.x, W = (nt + 31) / 32;
  size_t i = (size_t)tile * PW_TILE + t;
  int s = (int)segrow[i];
  PwSlots q = table ? pw_tile_slots_table(s, iw, table) : pw_tile_slots(s, iw);
  pl.pos[i] = (unsigned char)q.pos;
  if (t < q.K) pl.start[i] = (unsigned char)q.st;
  if (q.rank == 0) {
    pl.tile_node[(size_t)tile * PW_TILE + q.slot] = s;
    atomicOr(&pl.bitmap[(size_t)s * W + (tile >> 5)], 1u << (tile & 31));
  }
  if (t == 0) pl.tile_off[tile + 1] = q.K;
  __syncthreads();
}

// Plan, step 2 of 3, one block per scan: tile_off and node_off as prefix
// sums (the nodes' entry counts are the set bits of their bitmap rows).
__device__ __forceinline__ void pw_plan_offsets(int nt, int sp, PwPlan pl,
                                                int* ws) {
  int t = threadIdx.x, W = (nt + 31) / 32, carry = 0, total;
  for (int base = 0; base < nt; base += PW_TILE) {
    int j = base + t;
    int v = j < nt ? __ldcg(pl.tile_off + j + 1) : 0;
    int ex = pw_block_scan(v, ws, &total);
    if (j < nt) pl.tile_off[j + 1] = carry + ex + v;
    carry += total;
  }
  carry = 0;
  for (int base = 0; base < sp; base += PW_TILE) {
    int s = base + t, v = 0;
    if (s < sp)
      for (int w = 0; w < W; ++w) {
        if (pl.wpre) pl.wpre[(size_t)s * W + w] = v;
        v += __popc(__ldcg(pl.bitmap + (size_t)s * W + w));
      }
    int ex = pw_block_scan(v, ws, &total);
    if (s < sp) pl.node_off[s + 1] = carry + ex + v;
    carry += total;
  }
  if (t == 0) {
    pl.tile_off[0] = 0;
    pl.node_off[0] = 0;
  }
}

// Plan, step 3 of 3, one tile: each slot's entry gets its place, its
// node's offset plus the count of earlier tiles that hold the node.
__device__ __forceinline__ void pw_plan_places(int tile, int nt,
                                                   PwPlan pl) {
  int t = threadIdx.x, W = (nt + 31) / 32;
  int off = __ldcg(pl.tile_off + tile);
  int K = __ldcg(pl.tile_off + tile + 1) - off;
  if (t < K) {
    int s = __ldcg(pl.tile_node + (size_t)tile * PW_TILE + t);
    const unsigned* bits = pl.bitmap + (size_t)s * W;
    int place = 0;
    if (pl.wpre) {
      place = __ldcg(pl.wpre + (size_t)s * W + (tile >> 5));
    } else {
      for (int w = 0; w < (tile >> 5); ++w) place += __popc(__ldcg(bits + w));
    }
    place += __popc(__ldcg(bits + (tile >> 5)) & ((1u << (tile & 31)) - 1u));
    pl.dest[off + t] = __ldcg(pl.node_off + s) + place;
  }
}

// Load a tile's run starts into sstart[0..K] (sstart[K] = PW_TILE) and its
// entries' places into sdest[0..K), and return K.  The caller's next barrier
// publishes them.
__device__ __forceinline__ int pw_tile_runs(int tile, PwPlan pl, int* sstart,
                                            int* sdest) {
  int t = threadIdx.x;
  int off = __ldcg(pl.tile_off + tile);
  int K = __ldcg(pl.tile_off + tile + 1) - off;
  if (t < K) {
    sstart[t] = __ldcg(pl.start + (size_t)tile * PW_TILE + t);
    sdest[t] = __ldcg(pl.dest + off + t);
  }
  if (t == 0) sstart[K] = PW_TILE;
  return K;
}

// One tile's partials: thread t stages its point's rows v at place `pos`;
// one thread per (slot, row) adds its run in point order from +0.0 and
// writes part[sdest[slot] * R + row].  vals: R * PW_TILE shared floats;
// sstart, sdest from pw_tile_runs.  Ends with a barrier.
template <int R>
__device__ __forceinline__ void pw_tile_compact_sums(float* vals,
                                                     const int* sstart,
                                                     const int* sdest,
                                                     const float (&v)[R],
                                                     int pos, int K,
                                                     float* part) {
#pragma unroll
  for (int r = 0; r < R; ++r) vals[pos * R + r] = v[r];
  __syncthreads();
  for (int j = threadIdx.x; j < K * R; j += PW_TILE) {
    int k = j / R, r = j - k * R;
    const float* run = vals + sstart[k] * R + r;
    int n = sstart[k + 1] - sstart[k], e = 0;
    float acc = 0.f;
    // loads eight at a time, adds in order
    for (; e + 8 <= n; e += 8) {
      float w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = run[(e + q) * R];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc += w[q];
    }
    for (; e < n; ++e) acc += run[e * R];
    part[(size_t)sdest[k] * R + r] = acc;
  }
  __syncthreads();
}

// One (node, row) chain: the node's partials [lo, hi) of part (entries, R),
// added in tile order from +0.0.  They come from other blocks of the same
// launch, so they are read through the L2; the loads go out L at a time
// (sixteen unless the caller can spare the registers for more), the adds
// stay in order.
template <int L = 16>
__device__ __forceinline__ float pw_chain(const float* part, int lo, int hi,
                                          int R, int r) {
  float acc = 0.f;
  const float* p = part + (size_t)lo * R + r;
  int n = hi - lo, e = 0;
  for (; e + L <= n; e += L) {
    float v[L];
#pragma unroll
    for (int q = 0; q < L; ++q) v[q] = __ldcg(p + (size_t)(e + q) * R);
#pragma unroll
    for (int q = 0; q < L; ++q) acc += v[q];
  }
  for (; e < n; ++e) acc += __ldcg(p + (size_t)e * R);
  return acc;
}

// The tail of a one-launch pass over a plan, after the block wrote this
// tile's K partials (rows each) at their places.  Nodes with no point get
// empty(n), and tile 0 calls it.  Then the block counts its partials per
// node in done (the scan's sp counts, zero between launches): the block
// that writes a node's last partial sees them all, sets the count back to
// zero (so the next pass in stream order, of any kind, can share it) and
// calls chain(n, r) for each of that node's rows.  full: PW_TILE shared
// ints; nfull: one shared int.
template <typename Empty, typename Chain>
__device__ __forceinline__ void pw_tile_finish_with(int tile, int K, PwPlan pl,
                                                    int* done, int sp,
                                                    int rows, int* full,
                                                    int* nfull, Empty empty,
                                                    Chain chain) {
  int t = threadIdx.x;
  if (t == 0) *nfull = 0;
  if (tile == 0) {
    for (int n = t; n < sp; n += PW_TILE)
      if (pl.node_off[n + 1] == pl.node_off[n]) empty(n);
  }
  __threadfence();
  __syncthreads();
  if (t < K) {
    int n = pl.tile_node[(size_t)tile * PW_TILE + t];
    int want = pl.node_off[n + 1] - pl.node_off[n];
    if (atomicAdd(&done[n], 1) == want - 1) {
      full[atomicAdd(nfull, 1)] = n;
      done[n] = 0;
    }
  }
  __syncthreads();
  int nf = *nfull;
  if (nf == 0) return;
  __threadfence();
  for (int j = t; j < nf * rows; j += PW_TILE) {
    int q = j / rows;
    chain(full[q], j - q * rows);
  }
}

// The tail of a one-launch sweep (or segment sum), after
// pw_tile_compact_sums wrote this tile's K x R partials to part (the
// scan's): nodes with no point sum to +0.0; a node's R chains add its
// partials in tile order into O (R, sp), L loads in flight (pw_chain).
template <int R, int L = 16>
__device__ __forceinline__ void pw_tile_finish(int tile, int K, PwPlan pl,
                                               const float* part, float* O,
                                               int* done, int sp, int* full,
                                               int* nfull) {
  pw_tile_finish_with(
      tile, K, pl, done, sp, R, full, nfull,
      [&](int n) {
#pragma unroll
        for (int r = 0; r < R; ++r) O[r * sp + n] = 0.f;
      },
      [&](int n, int r) {
        O[r * sp + n] =
            pw_chain<L>(part, pl.node_off[n], pl.node_off[n + 1], R, r);
      });
}

// ---------------------------------------------------------------------------
// A sum with no plan: ids new on every call (binning's segment sum, the
// remap's per-parent sums R1 and R1b)
// ---------------------------------------------------------------------------

#define PW_DENSE_LOADS 16

// Shared memory of pw_dense_sum_tile, declared by its kernel.
template <int R>
struct PwDenseSmem {
  float vals[R * PW_TILE];
  int iw[PW_PLAN_SMEM_INTS];
  int sstart[PW_TILE + 1];
  int sdest[PW_TILE];
  int last;
};

// One tile of one scan per block (tile blockIdx.x of gridDim.x, scan
// blockIdx.y of gridDim.y), after each thread computed its point's rows v
// and id s in [0, S): the tile's runs found in shared memory, each present
// node's R partials written at (tile, node) of partial (B, nt, S, R), which
// is never filled elsewhere; ws holds the scans' tile bitmaps (B, S, W) and
// a count per scan (B), zero between launches, and the last block of a scan
// zeroes its part again.  ids: S shared ints where S <= PW_SLOT_TABLE_MAX
// (the kernel's dynamic shared memory), else unused.  out (B, R, S).
template <int R>
__device__ __forceinline__ void pw_dense_sum_tile(PwDenseSmem<R>& sm,
                                                  int* ids,
                                                  const float (&v)[R], int s,
                                                  float* partial,
                                                  unsigned* ws,
                                                  float* __restrict__ out,
                                                  int S) {
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  int W = (nt + 31) / 32;
  unsigned* bits = ws + (size_t)b * S * W;
  unsigned* count = ws + (size_t)gridDim.y * S * W + b;
  float* part = partial + (size_t)b * nt * S * R;
  PwSlots q = S <= PW_SLOT_TABLE_MAX ? pw_tile_slots_table(s, sm.iw, ids)
                                     : pw_tile_slots(s, sm.iw);
  if (t < q.K) sm.sstart[t] = q.st;
  if (t == 0) sm.sstart[q.K] = PW_TILE;
  if (q.rank == 0) {
    sm.sdest[q.slot] = tile * S + s;
    atomicOr(&bits[(size_t)s * W + (tile >> 5)], 1u << (tile & 31));
  }
  pw_tile_compact_sums<R>(sm.vals, sm.sstart, sm.sdest, v, q.pos, q.K, part);
  __threadfence();
  __syncthreads();
  if (t == 0) sm.last = atomicAdd(count, 1u) == (unsigned)(nt - 1);
  __syncthreads();
  if (!sm.last) return;
  // every tile of the scan is in: a thread per (node, row) adds the node's
  // partials in tile order, the marked tiles of four bitmap words at a
  // time, PW_DENSE_LOADS loads in flight (few registers: they bound the
  // blocks an SM holds in the pass above)
  __threadfence();
  float* O = out + (size_t)b * R * S;
  for (int j = t; j < S * R; j += PW_TILE) {
    int n = j / R, r = j - n * R;
    const unsigned* row = bits + (size_t)n * W;
    const float* p = part + (size_t)n * R + r;
    float acc = 0.f;
    for (int w0 = 0; w0 < W; w0 += 4) {
      unsigned xs[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xs[k] = w0 + k < W ? __ldcg(row + w0 + k) : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned x = xs[k];
        const float* pw = p + (size_t)(w0 + k) * 32 * S * R;
        while (x) {
          float y[PW_DENSE_LOADS];
          unsigned z = x;
#pragma unroll
          for (int e = 0; e < PW_DENSE_LOADS; ++e) {
            y[e] = z ? __ldcg(pw + (size_t)(__ffs(z) - 1) * S * R) : 0.f;
            z &= z - 1;
          }
#pragma unroll
          for (int e = 0; e < PW_DENSE_LOADS; ++e) {
            if (x) acc += y[e];
            x &= x - 1;
          }
        }
      }
    }
    O[r * S + n] = acc;
  }
  __syncthreads();
  for (int j = t; j < S * W; j += PW_TILE) bits[j] = 0u;
  if (t == 0) *count = 0u;
}

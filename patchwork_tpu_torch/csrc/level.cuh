// The phases of one engine level around its fit, as device code shared by
// the phase kernels (level.cu, which run where the one launch cannot hold
// the node table) and the one co-operative launch of a level
// (pw_fit_level_kernel's level layout, fitloop.cu): one device code a
// phase.
//
// Layouts (common.cuh): P the scan's pts (8, N), S its state (4, N), T its
// tables (8, sp) [tau, zth, real, split_thresh, min_split_size, depth_ok,
// parent_split, 0], F its early-out flags (5, sp) [finished, label, fit,
// deficient, zth].  A point i is handled by one thread.  Tables other
// blocks of the one launch write (F, the remap's parent rows, the min
// tables, the split row) are read with __ldcg, through the L2.
//
// Min, max and counts are integer atomics, exact in any order, into
// tables kept as key distances from the identity (pw_min_dist,
// common.cuh): a zeroed table is an empty one.
#pragma once

#include <limits.h>

#include "common.cuh"
#include "tile_sums.cuh"

#define PW_BIG 3.0e38f

// ---------------------------------------------------------------------------
// R3 + R4 (fit_pallas.py:961-982): compact child slots and inherited tau/zth
// ---------------------------------------------------------------------------

// One scan, one block of PW_TILE threads: Q (4, sp) per parent [median, ok,
// base slot, axis], Z (2, sp) per child slot [tau, zth], zero where no
// child lands.  A parent's base slot is 2 x the count of earlier split
// parents, a prefix sum over the block (tables row 6 holds 0 or 1, so the
// integer count is the float sum the plain version's cumsum takes).  ws: 33
// shared ints.
__device__ __forceinline__ void pw_remap_nodes_block(const float* T,
                                                     const float* M,
                                                     const float* A, float* Q,
                                                     float* Z, int sp,
                                                     int trash, int* ws) {
  int t = threadIdx.x;
  for (int j = t; j < 2 * sp; j += PW_TILE) Z[j] = 0.f;
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < sp; base += PW_TILE) {
    int j = base + t, total;
    float split = j < sp ? T[6 * sp + j] : 0.f;
    int rank = carry + pw_block_scan(split > 0.5f ? 1 : 0, ws, &total);
    if (j < sp) {
      float slot = 2.f * (float)rank;
      float ok = split * ((slot + 1.f) < (float)trash ? 1.f : 0.f);
      Q[j] = M[j];
      Q[sp + j] = ok;
      Q[2 * sp + j] = slot;
      Q[3 * sp + j] = A[j];
      if (ok > 0.5f) {
        int d = (int)slot;
        Z[d] = T[j];
        Z[d + 1] = T[j];
        Z[sp + d] = T[sp + j];
        Z[sp + d + 1] = T[sp + j];
      }
    }
    carry += total;
  }
}

// R5 (fit_pallas.py:984-1010): point i moves to its parent's left (value <=
// median) or right child slot; the points of an overflowing parent are
// done.  Writes state rows 1 and 3.
__device__ __forceinline__ void pw_remap_point(const float* P, float* S,
                                               const float* Q, size_t N,
                                               size_t i, int sp, int trash) {
  float pseg = P[3 * N + i];
  int s = (int)pseg;
  float tr = (float)trash;
  float a = pseg < tr ? 1.f : 0.f;
  float med = __ldcg(Q + s), okg = __ldcg(Q + sp + s);
  float slot = __ldcg(Q + 2 * sp + s), ax = __ldcg(Q + 3 * sp + s);
  float v = ax * P[i] + (1.f - ax) * P[N + i];
  float gr = v > med ? 1.f : 0.f;
  float newseg = okg * (slot + gr) + (1.f - okg) * tr;
  S[3 * N + i] = a * newseg + (1.f - a) * tr;
  S[N + i] = fmaxf(S[N + i], a * (1.f - okg));
}

// ---------------------------------------------------------------------------
// node stats (fit_pallas.py:1012-1054): W (8, sp) [cnt, seed_cnt, key
// distances of xmin, ymin, zmin, xmax, ymax, zmax]
// ---------------------------------------------------------------------------

// Point i into W (shared or global) where it is live; seeded where Zt (the
// nodes' zth) is given and z < zth.
__device__ __forceinline__ void pw_stats_point(const float* P, const float* S,
                                               const float* Zt, unsigned* W,
                                               size_t N, size_t i, int sp,
                                               int trash) {
  float segf = S[3 * N + i];
  if (!(segf < (float)trash)) return;
  int s = (int)segf;
  float x = P[i], y = P[N + i], z = P[2 * N + i];
  atomicAdd(&W[s], 1u);
  if (Zt && z < __ldcg(Zt + s)) atomicAdd(&W[sp + s], 1u);
  int kx = pw_f32_key(x), ky = pw_f32_key(y), kz = pw_f32_key(z);
  atomicMax(&W[2 * sp + s], pw_min_dist(kx));
  atomicMax(&W[3 * sp + s], pw_min_dist(ky));
  atomicMax(&W[4 * sp + s], pw_min_dist(kz));
  atomicMax(&W[5 * sp + s], pw_max_dist(kx));
  atomicMax(&W[6 * sp + s], pw_max_dist(ky));
  atomicMax(&W[7 * sp + s], pw_max_dist(kz));
}

// A block's shared table into the scan's table in device memory, one
// atomic per touched entry.  Threads of the block take the nodes.
__device__ __forceinline__ void pw_stats_merge(const unsigned* sh,
                                               unsigned* W, int sp) {
  for (int s = threadIdx.x; s < sp; s += blockDim.x) {
    if (sh[s] == 0) continue;
    atomicAdd(&W[s], sh[s]);
    if (sh[sp + s]) atomicAdd(&W[sp + s], sh[sp + s]);
    for (int r = 2; r < 8; ++r) atomicMax(&W[r * sp + s], sh[r * sp + s]);
  }
}

// Row r of node s as the float the plain version gives: a count, or a min
// (+inf for an empty node) or a max (-inf).
__device__ __forceinline__ float pw_stats_value(const unsigned* W, int sp,
                                                int r, int s) {
  unsigned v = __ldcg(W + r * sp + s);
  if (r < 2) return (float)v;
  return r < 5 ? pw_min_of_dist(v) : pw_max_of_dist(v);
}

// ---------------------------------------------------------------------------
// early-outs in the reference's order (cpp:111-140; fit_pallas.py:1104-1118)
// ---------------------------------------------------------------------------

// Node s from its stats v [cnt, seed_cnt, xmin, ymin, zmin, xmax, ymax,
// zmax]: its flags into F; returns whether it is deficient.
__device__ __forceinline__ bool pw_early_out_node(
    const float (&v)[8], float real_row, float zth, float* F, int sp, int s,
    int is_level0, float flat_area, float flat_dz, int flat_minpts,
    int min_seed) {
  float cnt = v[0], seed = v[1];
  bool real = real_row > 0.5f;
  bool too_small = cnt < 3.f;
  float area = (v[5] - v[2]) * (v[6] - v[3]);
  bool flat_a = is_level0 ? false : ((area < flat_area) && !too_small);
  bool flat_z = ((v[7] - v[4]) < flat_dz) && (cnt > (float)flat_minpts) &&
                !too_small && !flat_a;
  bool finished = real && (too_small || flat_a || flat_z);
  bool fit = real && !finished;
  bool def = fit && (seed < (float)min_seed);
  F[s] = finished ? 1.f : 0.f;
  F[sp + s] = (flat_a || flat_z) ? 1.f : 0.f;
  F[2 * sp + s] = fit ? 1.f : 0.f;
  F[3 * sp + s] = def ? 1.f : 0.f;
  F[4 * sp + s] = zth;
  return def;
}

// ---------------------------------------------------------------------------
// one round of the deficient "lowest-z" pick (cpp:171-182;
// fit_pallas.py:1120-1193): D (2, sp) of the round, zeroed, [key distance
// of the candidates' min z, INT_MAX - the least index at that z]
// ---------------------------------------------------------------------------

// Point i's node if it is a candidate (live, of a deficient node, not
// chosen yet), else -1.
__device__ __forceinline__ int pw_def_cand(const float* S, const float* F,
                                           size_t N, size_t i, int sp,
                                           int trash) {
  float segf = S[3 * N + i];
  if (!(segf < (float)trash)) return -1;
  int s = (int)segf;
  if (!(__ldcg(F + 3 * sp + s) > 0.5f) || !(S[2 * N + i] < 0.5f)) return -1;
  return s;
}

__device__ __forceinline__ float pw_def_zmin(const unsigned* D, int s) {
  float m = pw_min_of_dist(__ldcg(D + s));
  return isfinite(m) ? m : PW_BIG;
}

// Step a: the candidates' min z per node.
__device__ __forceinline__ void pw_def_min_point(const float* P,
                                                 const float* S,
                                                 const float* F, unsigned* D,
                                                 size_t N, size_t i, int sp,
                                                 int trash) {
  int s = pw_def_cand(S, F, N, i, sp, trash);
  if (s >= 0) atomicMax(&D[s], pw_min_dist(pw_f32_key(P[2 * N + i])));
}

// Step b: the least index among the candidates at that z.
__device__ __forceinline__ void pw_def_imin_point(const float* P,
                                                  const float* S,
                                                  const float* F, unsigned* D,
                                                  size_t N, size_t i, int sp,
                                                  int trash) {
  int s = pw_def_cand(S, F, N, i, sp, trash);
  if (s >= 0 && P[2 * N + i] == pw_def_zmin(D, s))
    atomicMax(&D[sp + s], (unsigned)(INT_MAX - (int)P[6 * N + i]));
}

// Step c: that point is chosen (state row 2).
__device__ __forceinline__ void pw_def_pick_point(const float* P, float* S,
                                                  const float* F,
                                                  const unsigned* D, size_t N,
                                                  size_t i, int sp,
                                                  int trash) {
  int s = pw_def_cand(S, F, N, i, sp, trash);
  if (s < 0) return;
  int mi = INT_MAX - (int)__ldcg(D + sp + s);
  float mi_f = mi == INT_MAX ? PW_BIG : (float)mi;
  if (P[2 * N + i] == pw_def_zmin(D, s) && P[6 * N + i] == mi_f)
    S[2 * N + i] = 1.f;
}

// ---------------------------------------------------------------------------
// early-out labels and seeds (fit_pallas.py:1371-1409): the seeded mask and
// its sums' rows, the fit's sweep 0
// ---------------------------------------------------------------------------

// Point i's labels into state rows 0 and 1, and its rows of the first sums:
// [gm, x gm, y gm, z gm, 0, 0] (+ the six raw products in fast mode), gm
// the new mask of a live point.  Returns the point's node.
template <bool FAST>
__device__ __forceinline__ int pw_seed_point(const float* P, float* S,
                                             const float* F, size_t N,
                                             size_t i, int sp, int trash,
                                             float (&v)[FAST ? 12 : 6]) {
  float x = P[i], y = P[N + i], z = P[2 * N + i];
  float segf = S[3 * N + i];
  int s = (int)segf;
  float act = segf < (float)trash ? 1.f : 0.f;
  float fin = __ldcg(F + s), lab = __ldcg(F + sp + s);
  float fit = __ldcg(F + 2 * sp + s), def = __ldcg(F + 3 * sp + s);
  float zth = __ldcg(F + 4 * sp + s);
  float seed = act * (z < zth ? 1.f : 0.f);
  float chosen = S[2 * N + i];
  seed = (def * chosen + (1.f - def) * seed) * act;
  float g = S[i];
  float w_fin = act * fin;
  g = w_fin * lab + (1.f - w_fin) * g;
  float w_fit = act * fit;
  g = w_fit * seed + (1.f - w_fit) * g;
  S[i] = g;
  S[N + i] = fmaxf(S[N + i], w_fin);
  float gm = g * act;
  float xg = x * gm, yg = y * gm, zg = z * gm;
  v[0] = gm;
  v[1] = xg;
  v[2] = yg;
  v[3] = zg;
  v[4] = 0.f;
  v[5] = 0.f;
  if constexpr (FAST) {
    v[6] = x * xg;
    v[7] = y * xg;
    v[8] = z * xg;
    v[9] = y * yg;
    v[10] = z * yg;
    v[11] = z * zg;
  }
  return s;
}

// ---------------------------------------------------------------------------
// split decision (fit_pallas.py:1427-1439) and finish (1441-1462)
// ---------------------------------------------------------------------------

// Node s from the final sums' gcnt and distance sum: O rows [split, gcnt,
// resid] (row stride sp); resid is +inf below 3 ground points.
__device__ __forceinline__ void pw_split_node(float gcnt, float distsum,
                                              float fit, float cnt,
                                              const float* T, float* O,
                                              int sp, int s) {
  float resid = distsum / pw_clamp_lo(gcnt, 1.f);
  if (!(gcnt >= 3.f)) resid = INFINITY;
  bool split = fit > 0.5f && resid > T[3 * sp + s] && cnt >= T[4 * sp + s] &&
               T[5 * sp + s] > 0.5f;
  O[s] = split ? 1.f : 0.f;
  O[sp + s] = gcnt;
  O[2 * sp + s] = resid;
}

// Point i of a fitted node that does not split is done (state row 1).
__device__ __forceinline__ void pw_finish_point(float* S, const float* fit,
                                                const float* split, size_t N,
                                                size_t i, int trash) {
  float segf = S[3 * N + i];
  if (!(segf < (float)trash)) return;
  int s = (int)segf;
  if (__ldcg(fit + s) > 0.5f && __ldcg(split + s) < 0.5f) S[N + i] = 1.f;
}

// Shared helpers of the engine's CUDA kernels (sm_90a).
//
// Layouts (all float32, row-major, a leading batch dimension B):
//   pts    (B, 8, N)  rows [x, y, z, seg, ground, done, index, 0]
//   state  (B, 4, N)  rows [ground, done, chosen, seg_out]
//   node tables (B, R, Sp), one column per node.
// N is a multiple of PW_TILE for every sweep.
//
// Segment sums are never float atomics: inside a tile of PW_TILE points the
// points of node s are added in point order, and the per-tile partials in
// tile order (tile_sums.cuh).  The plain PyTorch versions
// (kernels/fit_cuda.py) add in exactly this order, and the library is built
// with -fmad=false, so both compute the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PW_TILE 256
#define PW_EXPORT extern "C" __attribute__((visibility("default")))

// float32 -> order-preserving int32 key (flip the low 31 bits of negatives);
// its own inverse.  Integer min/max/histograms on keys are exact.
__device__ __forceinline__ int pw_f32_key(float v) {
  int u = __float_as_int(v);
  return u ^ ((u >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float pw_key_f32(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

#define PW_KEY_POS_INF 0x7F800000            // pw_f32_key(+inf)
#define PW_KEY_NEG_INF ((int)0x807FFFFF)     // pw_f32_key(-inf)

// A key's distance from a min's identity (+inf's key) and from a max's
// (-inf's key): zero is the identity, and a larger distance is a smaller
// min or a larger max, so a zeroed table takes atomicMax of distances.
// Keys beyond the identity (+NaN for a min, -NaN for a max) count as the
// identity, as an atomicMin (atomicMax) from the identity ignores them.
__device__ __forceinline__ unsigned pw_min_dist(int k) {
  return (unsigned)PW_KEY_POS_INF - (unsigned)min(k, PW_KEY_POS_INF);
}

__device__ __forceinline__ unsigned pw_max_dist(int k) {
  return (unsigned)max(k, PW_KEY_NEG_INF) - (unsigned)PW_KEY_NEG_INF;
}

__device__ __forceinline__ float pw_min_of_dist(unsigned d) {
  return pw_key_f32((int)((unsigned)PW_KEY_POS_INF - d));
}

__device__ __forceinline__ float pw_max_of_dist(unsigned d) {
  return pw_key_f32((int)(d + (unsigned)PW_KEY_NEG_INF));
}

// NaN-propagating clamps, the semantics of torch.clamp / jnp.clip.
__device__ __forceinline__ float pw_clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float pw_clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float pw_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

#define PW_TWO_PI_3 2.0943951023931953f
#define PW_EPS 1e-12f

// Plane normal of one node from its centered second-moment sums
// m = [xx, xy, xz, yy, yz, zz] and ground count: _plane_rows
// (fit_pallas.py:311-377) term for term, with acosf in place of the TPU's
// polynomial _acos; flipped to +Z.
__device__ __forceinline__ void pw_normal(const float* m, float gcnt,
                                          float* nx, float* ny, float* nz) {
  float denom = pw_clamp_lo(gcnt - 1.f, 1.f);
  float a00 = m[0] / denom, a01 = m[1] / denom, a02 = m[2] / denom;
  float a11 = m[3] / denom, a12 = m[4] / denom, a22 = m[5] / denom;

  float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  float q = (a00 + a11 + a22) / 3.f;
  float d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.f * p1;
  float p = sqrtf(pw_clamp_lo(p2 / 6.f, 0.f));
  float safe_p = pw_clamp_lo(p, PW_EPS);
  float b00 = d0 / safe_p, b11 = d1 / safe_p, b22 = d2 / safe_p;
  float b01 = a01 / safe_p, b02 = a02 / safe_p, b12 = a12 / safe_p;
  float detb = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) +
               b02 * (b01 * b12 - b11 * b02);
  float r = pw_clamp(detb / 2.f, -1.f, 1.f);
  float phi = acosf(r) / 3.f;
  float e_lo = q + 2.f * p * cosf(phi + PW_TWO_PI_3);
  float diag_min = pw_min(a00, pw_min(a11, a22));
  float e_min = p <= PW_EPS ? diag_min : e_lo;

  float r0x = a00 - e_min, r0y = a01, r0z = a02;
  float r1x = a01, r1y = a11 - e_min, r1z = a12;
  float r2x = a02, r2y = a12, r2z = a22 - e_min;
  float c0x = r0y * r1z - r0z * r1y;
  float c0y = r0z * r1x - r0x * r1z;
  float c0z = r0x * r1y - r0y * r1x;
  float c1x = r0y * r2z - r0z * r2y;
  float c1y = r0z * r2x - r0x * r2z;
  float c1z = r0x * r2y - r0y * r2x;
  float c2x = r1y * r2z - r1z * r2y;
  float c2y = r1z * r2x - r1x * r2z;
  float c2z = r1x * r2y - r1y * r2x;
  float n0 = sqrtf(c0x * c0x + c0y * c0y + c0z * c0z);
  float n1 = sqrtf(c1x * c1x + c1y * c1y + c1z * c1z);
  float n2 = sqrtf(c2x * c2x + c2y * c2y + c2z * c2z);
  bool sel0 = (n0 >= n1) && (n0 >= n2);
  bool sel1 = !sel0 && (n1 >= n2);
  float vx = sel0 ? c0x : (sel1 ? c1x : c2x);
  float vy = sel0 ? c0y : (sel1 ? c1y : c2y);
  float vz = sel0 ? c0z : (sel1 ? c1z : c2z);
  float nn = sqrtf(vx * vx + vy * vy + vz * vz);
  bool ok = nn > 1e-20f;
  float sn = pw_clamp_lo(nn, 1e-30f);
  vx = ok ? vx / sn : 0.f;
  vy = ok ? vy / sn : 0.f;
  vz = ok ? vz / sn : 1.f;
  bool flip = vz < 0.f;
  *nx = flip ? -vx : vx;
  *ny = flip ? -vy : vy;
  *nz = flip ? -vz : vz;
}

// Raw fast-sweep moments -> centered sums (_centered_m2, fit_pallas.py:
// 380-396): M1 holds node s's column of the 12-row accumulate [cnt, sx, sy,
// sz, distsum, changed, xx, xy, xz, yy, yz, zz] with row stride sp.
__device__ __forceinline__ void pw_centered_m2(const float* M1, int sp, int s,
                                               float* m) {
  float n = pw_clamp_lo(M1[s], 1.f);
  float sx = M1[sp + s], sy = M1[2 * sp + s], sz = M1[3 * sp + s];
  m[0] = M1[6 * sp + s] - sx * sx / n;
  m[1] = M1[7 * sp + s] - sx * sy / n;
  m[2] = M1[8 * sp + s] - sx * sz / n;
  m[3] = M1[9 * sp + s] - sy * sy / n;
  m[4] = M1[10 * sp + s] - sy * sz / n;
  m[5] = M1[11 * sp + s] - sz * sz / n;
}

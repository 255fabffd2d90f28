// Shared helpers of the engine's CUDA kernels (sm_90a).
//
// Layouts (all float32, row-major, a leading batch dimension B):
//   pts    (B, 8, N)  rows [x, y, z, seg, ground, done, index, 0]
//   state  (B, 4, N)  rows [ground, done, chosen, seg_out]
//   node tables (B, R, Sp), one column per node.
// N is a multiple of PW_TILE for every sweep.
//
// Segment sums are never float atomics: inside a tile of PW_TILE points the
// thread of node s adds that tile's points of s in point order, and the
// per-tile partials are added in tile order (pw_reduce_tiles).  The plain
// PyTorch versions (kernels/fit_cuda.py) add in exactly this order, and the
// library is built with -fmad=false, so both compute the same bits.
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

// Per-tile segment sums.  vals[r][t] and segs[t] hold the tile's staged
// points; the thread of node s adds the points of s in point order and
// writes its R sums to partial[r * sp + s].
template <int R>
__device__ __forceinline__ void pw_tile_accumulate(float (*vals)[PW_TILE],
                                                   const int* segs, int sp,
                                                   float* partial) {
  for (int s = threadIdx.x; s < sp; s += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int t = 0; t < PW_TILE; ++t) {
      if (segs[t] == s) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += vals[r][t];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) partial[r * sp + s] = acc[r];
  }
}

// partial (B, nt, R, sp) -> out (B, R, sp), tiles added in index order.
// Defined in sweeps.cu; errors surface through cudaGetLastError().
void pw_reduce_tiles(const float* partial, float* out, int B, int nt, int R,
                     int sp, cudaStream_t stream);

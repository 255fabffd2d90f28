// Fit-loop sweeps and the fixed-order segment sum.
//
// Replace (patchwork_tpu/kernels/):
//   pw_apply_sweep    fit_pallas.py fused_apply -> _apply_kernel (93-136,
//                     179-216), as the level kernel's `sweep` (1305-1336)
//   pw_moments2_sweep fit_pallas.py fused_moments2 -> _moments2_kernel
//                     (138-172, 219-244), as the level kernel's `m2_sweep`
//                     (1338-1355)
//   pw_seg_sum        seg_pallas.py seg_sum_pallas -> _seg_sum_kernel (52-93)
//
// On the TPU each tile's per-node sums are one-hot matmuls on the MXU over
// a VMEM-resident cloud.  Here one block takes one tile of PW_TILE points of
// one scan: each thread computes one point's rows into shared memory, then
// the thread of node s adds the tile's points of s in point order, and a
// second kernel adds the per-tile partials in tile order.  What bounds it on
// the H100 is memory: about 28 bytes read and 4 written per point, plus the
// dense (tiles, R, Sp) partials; the packed batch (34 MB at 8 x 131072)
// stays in the 50 MB L2 across the sweeps of a level.
#include "common.cuh"

__global__ void pw_tile_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int B, int nt,
                                      int R, int sp) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * R * sp) return;
  int s = idx % sp;
  int r = (idx / sp) % R;
  int b = idx / (sp * R);
  const float* p = partial + ((size_t)b * nt * R + r) * sp + s;
  float acc = 0.f;
  for (int j = 0; j < nt; ++j) acc += p[(size_t)j * R * sp];
  out[idx] = acc;
}

void pw_reduce_tiles(const float* partial, float* out, int B, int nt, int R,
                     int sp, cudaStream_t stream) {
  int total = B * R * sp;
  pw_tile_reduce_kernel<<<(total + 127) / 128, 128, 0, stream>>>(
      partial, out, B, nt, R, sp);
}

template <int R>
__global__ void pw_seg_sum_partials(const float* __restrict__ rows,
                                    const int* __restrict__ seg,
                                    float* __restrict__ partial, int N,
                                    int sp) {
  __shared__ float vals[R][PW_TILE];
  __shared__ int segs[PW_TILE];
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  size_t i = (size_t)tile * PW_TILE + t;
#pragma unroll
  for (int r = 0; r < R; ++r) vals[r][t] = rows[((size_t)b * R + r) * N + i];
  segs[t] = seg[(size_t)b * N + i];
  __syncthreads();
  pw_tile_accumulate<R>(vals, segs, sp,
                        partial + ((size_t)b * nt + tile) * R * sp);
}

template <bool FAST>
__global__ void pw_apply_partials(const float* __restrict__ pts,
                                  float* __restrict__ state,
                                  const float* __restrict__ tab,
                                  float* __restrict__ partial, int N, int sp,
                                  int trash) {
  constexpr int R = FAST ? 12 : 6;
  __shared__ float vals[R][PW_TILE];
  __shared__ int segs[PW_TILE];
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  float* S = state + (size_t)b * 4 * N;
  const float* T = tab + (size_t)b * 8 * sp;

  float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
  float segf = S[3 * (size_t)N + i];
  int s = (int)segf;
  float g = S[i];
  float act = segf < (float)trash ? 1.f : 0.f;
  // fit_pallas.py:1314-1319
  float dx = x - T[s], dy = y - T[sp + s], dz = z - T[2 * sp + s];
  float dist = fabsf(dx * T[3 * sp + s] + dy * T[4 * sp + s] +
                     dz * T[5 * sp + s]);
  float apply_m = act * T[6 * sp + s];
  float new_g = dist < T[7 * sp + s] ? 1.f : 0.f;
  float g2 = apply_m * new_g + (1.f - apply_m) * g;
  S[i] = g2;
  float gm = g2 * act;
  float xg = x * gm, yg = y * gm, zg = z * gm;
  vals[0][t] = gm;
  vals[1][t] = xg;
  vals[2][t] = yg;
  vals[3][t] = zg;
  vals[4][t] = dist * g * act;
  vals[5][t] = apply_m * fabsf(new_g - g);
  if constexpr (FAST) {
    vals[6][t] = x * xg;
    vals[7][t] = y * xg;
    vals[8][t] = z * xg;
    vals[9][t] = y * yg;
    vals[10][t] = z * yg;
    vals[11][t] = z * zg;
  }
  segs[t] = s;
  __syncthreads();
  pw_tile_accumulate<R>(vals, segs, sp,
                        partial + ((size_t)b * nt + tile) * R * sp);
}

__global__ void pw_m2_partials(const float* __restrict__ pts,
                               const float* __restrict__ state,
                               const float* __restrict__ ctab,
                               float* __restrict__ partial, int N, int sp,
                               int trash) {
  __shared__ float vals[6][PW_TILE];
  __shared__ int segs[PW_TILE];
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, nt = gridDim.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  const float* S = state + (size_t)b * 4 * N;
  const float* C = ctab + (size_t)b * 3 * sp;

  float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
  float segf = S[3 * (size_t)N + i];
  int s = (int)segf;
  float act = segf < (float)trash ? 1.f : 0.f;
  float g = S[i] * act;
  float dx = (x - C[s]) * g;
  float dy = (y - C[sp + s]) * g;
  float dz = (z - C[2 * sp + s]) * g;
  vals[0][t] = dx * dx;
  vals[1][t] = dx * dy;
  vals[2][t] = dx * dz;
  vals[3][t] = dy * dy;
  vals[4][t] = dy * dz;
  vals[5][t] = dz * dz;
  segs[t] = s;
  __syncthreads();
  pw_tile_accumulate<6>(vals, segs, sp,
                        partial + ((size_t)b * nt + tile) * 6 * sp);
}

PW_EXPORT int pw_seg_sum(const float* rows, const int* seg, float* partial,
                         float* out, int B, int R, int N, int S,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  switch (R) {
    case 1: pw_seg_sum_partials<1><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 2: pw_seg_sum_partials<2><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 3: pw_seg_sum_partials<3><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 4: pw_seg_sum_partials<4><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 5: pw_seg_sum_partials<5><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 6: pw_seg_sum_partials<6><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 7: pw_seg_sum_partials<7><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    case 8: pw_seg_sum_partials<8><<<grid, PW_TILE, 0, st>>>(rows, seg, partial, N, S); break;
    default: return (int)cudaErrorInvalidValue;
  }
  pw_reduce_tiles(partial, out, B, N / PW_TILE, R, S, st);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_apply_sweep(const float* pts, float* state, const float* tab,
                             float* partial, float* out, int B, int N, int sp,
                             int trash, int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  if (fast) {
    pw_apply_partials<true><<<grid, PW_TILE, 0, st>>>(pts, state, tab, partial,
                                                      N, sp, trash);
  } else {
    pw_apply_partials<false><<<grid, PW_TILE, 0, st>>>(pts, state, tab,
                                                       partial, N, sp, trash);
  }
  pw_reduce_tiles(partial, out, B, N / PW_TILE, fast ? 12 : 6, sp, st);
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_moments2_sweep(const float* pts, const float* state,
                                const float* ctab, float* partial, float* out,
                                int B, int N, int sp, int trash,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(N / PW_TILE, B);
  pw_m2_partials<<<grid, PW_TILE, 0, st>>>(pts, state, ctab, partial, N, sp,
                                           trash);
  pw_reduce_tiles(partial, out, B, N / PW_TILE, 6, sp, st);
  return (int)cudaGetLastError();
}

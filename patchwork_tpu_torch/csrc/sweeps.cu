// Fit-loop sweeps and the tile plans they and the segment ops add over.
//
// Replace (patchwork_tpu/kernels/):
//   pw_apply_sweep    fit_pallas.py fused_apply -> _apply_kernel (93-136,
//                     179-216), as the level kernel's `sweep` (1305-1336)
//   pw_moments2_sweep fit_pallas.py fused_moments2 -> _moments2_kernel
//                     (138-172, 219-244), as the level kernel's `m2_sweep`
//                     (1338-1355)
// and build the plans of tile_sums.cuh: pw_sweep_plan of a level's node ids
// (a row of the sweeps' state), pw_seg_plan of a segment binding's int ids
// (the segment sum and min/max of seg.cu add over it).
//
// On the TPU each tile's per-node sums are one-hot matmuls on the MXU over
// a VMEM-resident cloud.  Here one block takes one tile of PW_TILE points of
// one scan and each thread computes one point's rows into shared memory.
//
// pw_apply_sweep is bound by memory (24 bytes read and 4 written per point;
// a packed batch of 8 x 131072 points stays in the 50 MB L2 across the
// sweeps of a level) and, below that, by the latency of its in-order sums.
// It is one launch with no dense (tiles, R, Sp) buffer: the node ids are
// fixed for a fit, so pw_sweep_plan finds once per level which nodes each
// tile holds (tile_sums.cuh).  A sweep's block sorts its tile's rows by
// node in shared memory, one thread per (present node, row) adds its run in
// point order, and the block writes K x R floats, K the tile's node count.
// A node's partials lie next to each other in tile order; the block that
// writes the last of them (an integer count per node) adds them up, so the
// chains run on many SMs while other tiles are still at work.  A tile
// without a node would add +0.0, which changes no bit, so the sums equal
// the dense ones bit for bit.  A thread loads its point's rows with
// coalesced 4-byte loads and the six blocks an SM holds overlap them; a
// ring of staged tiles filled by 16-byte asynchronous copies was measured
// slower (more registers, fewer blocks per SM) and was not kept.
//
// pw_moments2_sweep is the same one launch over the same plan, with the same
// tail (pw_tile_finish, tile_sums.cuh): 20 bytes read per point, six rows.
#include "common.cuh"
#include "tile_sums.cuh"

// One tile of one scan per block.  partial (B, cap, R): the partial at
// place e of scan b is at (b * cap + e) * R; done (B, sp) counts the
// partials written per node and is zero between launches.
template <bool FAST>
__global__ void __launch_bounds__(PW_TILE)
    pw_apply_kernel(const float* __restrict__ pts, float* __restrict__ state,
                    const float* __restrict__ tab, PwPlan plan, float* partial,
                    float* __restrict__ out, int* done, int N, int sp,
                    int cap, int trash) {
  constexpr int R = FAST ? 12 : 6;
  __shared__ float vals[R * PW_TILE];
  __shared__ int sstart[PW_TILE + 1];
  __shared__ int sdest[PW_TILE];
  __shared__ int full[PW_TILE];   // nodes whose last partial this block wrote
  __shared__ int nfull;
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  float* S = state + (size_t)b * 4 * N;
  const float* T = tab + (size_t)b * 8 * sp;
  PwPlan pl = pw_plan_scan_of(plan, b, N, sp, cap);
  float* part = partial + (size_t)b * cap * R;
  float* O = out + (size_t)b * R * sp;

  int K = pw_tile_runs(tile, pl, sstart, sdest);
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
  float v[R];
  v[0] = gm;
  v[1] = xg;
  v[2] = yg;
  v[3] = zg;
  v[4] = dist * g * act;
  v[5] = apply_m * fabsf(new_g - g);
  if constexpr (FAST) {
    v[6] = x * xg;
    v[7] = y * xg;
    v[8] = z * xg;
    v[9] = y * yg;
    v[10] = z * yg;
    v[11] = z * zg;
  }
  pw_tile_compact_sums<R>(vals, sstart, sdest, v, (int)pl.pos[i], K, part);

  pw_tile_finish<R>(tile, K, pl, part, O, done + (size_t)b * sp, sp, full,
                    &nfull);
}

// table: the dynamic shared memory holds an int per node id (sp of them)
// for pw_tile_slots_table.
template <typename Id>
__global__ void __launch_bounds__(PW_TILE)
    pw_plan_tiles_kernel(const Id* __restrict__ rows, int nrows, int row,
                         PwPlan plan, int N, int sp, int cap, bool table) {
  __shared__ int iw[PW_PLAN_SMEM_INTS];
  extern __shared__ int ids[];
  int b = blockIdx.y;
  pw_plan_tile(rows + ((size_t)b * nrows + row) * N, blockIdx.x, N / PW_TILE,
               pw_plan_scan_of(plan, b, N, sp, cap), iw,
               table ? ids : nullptr);
}

__global__ void __launch_bounds__(PW_TILE)
    pw_plan_offsets_kernel(PwPlan plan, int N, int sp, int cap) {
  __shared__ int ws[33];
  pw_plan_offsets(N / PW_TILE, sp,
                         pw_plan_scan_of(plan, blockIdx.x, N, sp, cap), ws);
}

__global__ void __launch_bounds__(PW_TILE)
    pw_plan_places_kernel(PwPlan plan, int N, int sp, int cap) {
  pw_plan_places(blockIdx.x, N / PW_TILE,
                            pw_plan_scan_of(plan, blockIdx.y, N, sp, cap));
}

// One tile of one scan per block, as pw_apply_kernel: the six centered
// products of each point (fit_pallas.py:1338-1355), summed per node over
// the plan.  It shares the plan's done counts and partials with the apply
// sweep, which runs before and after it on the same stream.
__global__ void __launch_bounds__(PW_TILE)
    pw_m2_kernel(const float* __restrict__ pts,
                 const float* __restrict__ state,
                 const float* __restrict__ ctab, PwPlan plan, float* partial,
                 float* __restrict__ out, int* done, int N, int sp, int cap,
                 int trash) {
  constexpr int R = 6;
  __shared__ float vals[R * PW_TILE];
  __shared__ int sstart[PW_TILE + 1];
  __shared__ int sdest[PW_TILE];
  __shared__ int full[PW_TILE];
  __shared__ int nfull;
  int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  size_t i = (size_t)tile * PW_TILE + t;
  const float* P = pts + (size_t)b * 8 * N;
  const float* S = state + (size_t)b * 4 * N;
  const float* C = ctab + (size_t)b * 3 * sp;
  PwPlan pl = pw_plan_scan_of(plan, b, N, sp, cap);
  float* part = partial + (size_t)b * cap * R;

  int K = pw_tile_runs(tile, pl, sstart, sdest);
  float x = P[i], y = P[(size_t)N + i], z = P[2 * (size_t)N + i];
  float segf = S[3 * (size_t)N + i];
  int s = (int)segf;
  float act = segf < (float)trash ? 1.f : 0.f;
  float g = S[i] * act;
  float dx = (x - C[s]) * g;
  float dy = (y - C[sp + s]) * g;
  float dz = (z - C[2 * sp + s]) * g;
  float v[R];
  v[0] = dx * dx;
  v[1] = dx * dy;
  v[2] = dx * dz;
  v[3] = dy * dy;
  v[4] = dy * dz;
  v[5] = dz * dz;
  pw_tile_compact_sums<R>(vals, sstart, sdest, v, (int)pl.pos[i], K, part);
  pw_tile_finish<R>(tile, K, pl, part, out + (size_t)b * R * sp,
                    done + (size_t)b * sp, sp, full, &nfull);
}

// The three steps of a plan of node-id row `row` of rows (B, nrows, N);
// bitmap (2, B, sp, W) is scratch whose first half is zeroed by the caller
// (the second holds the words' prefix counts), start, tile_node and dest
// are zeroed too where their unused tails are compared.
template <typename Id>
static int pw_plan_launch(const Id* rows, PwPlan plan, int nrows, int row,
                          int B, int N, int sp, int cap, cudaStream_t st) {
  dim3 grid(N / PW_TILE, B);
  plan.wpre = (int*)(plan.bitmap + (size_t)B * sp * ((N / PW_TILE + 31) / 32));
  bool table = sp <= PW_SLOT_TABLE_MAX;
  pw_plan_tiles_kernel<Id><<<grid, PW_TILE, table ? sp * sizeof(int) : 0,
                             st>>>(rows, nrows, row, plan, N, sp, cap, table);
  pw_plan_offsets_kernel<<<B, PW_TILE, 0, st>>>(plan, N, sp, cap);
  pw_plan_places_kernel<<<grid, PW_TILE, 0, st>>>(plan, N, sp, cap);
  return (int)cudaGetLastError();
}

// The plan of a fit: node ids in row `row` of the float state.
PW_EXPORT int pw_sweep_plan(const float* rows, unsigned char* pos,
                            unsigned char* start, int* tile_node,
                            int* tile_off, unsigned* bitmap, int* node_off,
                            int* dest, int nrows, int row, int B, int N,
                            int sp, int cap, void* stream) {
  PwPlan plan = {pos, start, tile_node, tile_off, bitmap, node_off, dest};
  return pw_plan_launch(rows, plan, nrows, row, B, N, sp, cap,
                        (cudaStream_t)stream);
}

// The plan of a segment binding: seg (B, N) int ids in [0, S), N a multiple
// of PW_TILE.  Bound by reading the ids once and by the tile step's
// in-block ranks; built once per binding and shared by its calls.
PW_EXPORT int pw_seg_plan(const int* seg, unsigned char* pos,
                          unsigned char* start, int* tile_node, int* tile_off,
                          unsigned* bitmap, int* node_off, int* dest, int B,
                          int N, int S, int cap, void* stream) {
  PwPlan plan = {pos, start, tile_node, tile_off, bitmap, node_off, dest};
  return pw_plan_launch(seg, plan, 1, 0, B, N, S, cap, (cudaStream_t)stream);
}

PW_EXPORT int pw_apply_sweep(const float* pts, float* state, const float* tab,
                             unsigned char* pos, unsigned char* start,
                             int* tile_node, int* tile_off, int* node_off,
                             int* dest, int* done, float* partial, float* out,
                             int B, int N, int sp, int cap, int trash,
                             int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PwPlan plan = {pos, start, tile_node, tile_off, nullptr, node_off, dest};
  dim3 grid(N / PW_TILE, B);
  if (fast) {
    pw_apply_kernel<true><<<grid, PW_TILE, 0, st>>>(
        pts, state, tab, plan, partial, out, done, N, sp, cap, trash);
  } else {
    pw_apply_kernel<false><<<grid, PW_TILE, 0, st>>>(
        pts, state, tab, plan, partial, out, done, N, sp, cap, trash);
  }
  return (int)cudaGetLastError();
}

PW_EXPORT int pw_moments2_sweep(const float* pts, const float* state,
                                const float* ctab, unsigned char* pos,
                                unsigned char* start, int* tile_node,
                                int* tile_off, int* node_off, int* dest,
                                int* done, float* partial, float* out, int B,
                                int N, int sp, int cap, int trash,
                                void* stream) {
  PwPlan plan = {pos, start, tile_node, tile_off, nullptr, node_off, dest};
  dim3 grid(N / PW_TILE, B);
  pw_m2_kernel<<<grid, PW_TILE, 0, (cudaStream_t)stream>>>(
      pts, state, ctab, plan, partial, out, done, N, sp, cap, trash);
  return (int)cudaGetLastError();
}

// Backward raster kernel: gradients of the folded plane coefficients
// from the per-pixel depth and silhouette cotangents.
//
// Replaces mhmocap_tpu/ops/raster_pallas.py:_bwd_kernel (launched by
// _run_backward, pl.pallas_call at :650). Per active (cell, chunk) pair
// and pixel p, face f:
//   g    = dlk(p) * sigmoid(-d|d| inv_blur) * 2|d| inv_blur
//          routed to the edge plane that won the max, first match in
//          the order d_0, d_1, d_2 (no gradient when the bbox wins);
//   gz   = dz(p) where amin(p) == f (the depth winner), else 0;
//   dC_f += [px, py, 1]^T [g_0, g_1, g_2, gz]
// into the (B, F_pad, 12) plane-coefficient gradient.
//
// What bounds it on the H100: arithmetic. At B=29 bodies, window 160
// the faces-preordered body gives 15037 active (cell, chunk) pairs
// holding 246 M pixel-face pairs, of which 57 M (23%) add anything (the
// rest have d|d| inv_blur above the point where expf underflows). Each
// of those costs ~33 f32 operations, one expf among them, and each row
// of a face with one ~30 more: ~2.0 GFLOP, 0.030 ms at 67 TFLOP/s
// (about twice that with --fmad=false, where a multiply-add is two
// instructions), against ~50 MB of tables, cotangents and output
// (15 us at 3.35 TB/s).
//
// The TPU kernel walks cells in grid order on one core and accumulates
// each chunk's P^T G product into one VMEM output. On this card blocks
// run in parallel, so each face's output is owned by one block:
//   * one block per (face chunk, body); thread (h, l) owns face
//     ch * 128 + l and rows 4 h .. 4 h + 3 of every cell, so two row
//     groups split each cell's pixels and the block's work is the
//     chunk's cells (mean 5.2, at most 25 at B=29) rather than a cell's
//     chunks (71% of cell blocks had none, the busiest 36);
//   * the cells are the rectangle of strips x x-blocks that the
//     chunk's bbox aggregate reaches (chunk_cells, the same 4-scalar
//     test as chunk_active), so the kernel reads no schedule table;
//   * the face's 13 table values are loaded once, into registers; each
//     cell's cotangents (dz, dlk, amin) go to shared memory with
//     cp.async, double-buffered, and are read as warp broadcasts;
//   * most pairs add exactly nothing: where -d|d| inv_blur <= -110,
//     expf underflows to 0 (below -104 its value is under half the
//     least subnormal), so the sigmoid and g are 0. A thread skips the
//     rows and columns whose bbox distance alone (a lower bound of d)
//     puts them there, and every other pair whose d does. The depth
//     winner of a pixel covers it (d <= 0), so no gz is skipped;
//   * the 12 sums stay in registers across the cells, summed per row
//     with cell-relative x and rebased once per row (py exact); the
//     two row groups are added in shared memory in a fixed order and
//     every coefficient is stored once with a coalesced plain store: no
//     atomics, no zero fill, bit-identical results from run to run.
// Exact f32 (no fast math, --fmad=false) and the plain version's
// operation order for the planes, the bbox clamp and the sigmoid.

#include <cuda_pipeline_primitives.h>

#include "raster_common.cuh"

namespace mhmocap_raster {

constexpr int ROW_SPLIT = 2;                          // row groups per cell
constexpr int ROWS_PER_GROUP = STRIP_H / ROW_SPLIT;   // 4
constexpr int BWD_THREADS = ROW_SPLIT * FACE_CHUNK;   // 256
constexpr int RED_STRIDE = 13;                        // 12 sums + 1 pad
// X_ZERO and X_CULL (raster_common.cuh): the bbox cull uses the distance
// sqrt(X_CULL / inv_blur); a pair with -d|d| inv_blur <= X_ZERO has a
// silhouette gradient of exactly 0.

// sigmoid(x) as the stable two-sided form 1 / (1 + e^-x) for x >= 0 and
// e^x / (1 + e^x) below, with one expf and no branch: both sides divide
// by 1 + expf(-|x|).
__device__ __forceinline__ float sigmoid(float x) {
  const float e = expf(-fabsf(x));
  return (x >= 0.0f ? 1.0f : e) / (1.0f + e);
}

// The smem the kernel needs: two staging buffers of one cell's
// cotangents, reused after the cell loop for the row groups' sums.
__host__ __device__ inline size_t bwd_shmem_bytes(int npx) {
  const size_t stage = 2 * static_cast<size_t>(npx) * sizeof(float4);
  const size_t red = static_cast<size_t>(ROW_SPLIT) * FACE_CHUNK *
                     RED_STRIDE * sizeof(float);
  return stage > red ? stage : red;
}

// Copy the cotangents of cell (s, xb) into buf: per pixel {dz, dlk,
// amin bits, unused}, 4-byte cp.async each.
__device__ __forceinline__ void stage_cell(float4* buf, const float* dz,
                                           const float* dlk, const int* amin,
                                           size_t img, int s, int xb, int xw,
                                           int win) {
  const int npx = STRIP_H * xw;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const size_t o = img + static_cast<size_t>(s * STRIP_H + p / xw) * win +
                     xb * xw + p % xw;
    __pipeline_memcpy_async(&buf[p].x, dz + o, sizeof(float));
    __pipeline_memcpy_async(&buf[p].y, dlk + o, sizeof(float));
    __pipeline_memcpy_async(&buf[p].z, amin + o, sizeof(int));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(BWD_THREADS, 4)
    raster_bwd_kernel(const float* __restrict__ tab,
                      const float* __restrict__ agg,
                      const float* __restrict__ dz,
                      const float* __restrict__ dlk,
                      const int* __restrict__ amin,
                      float* __restrict__ dplanes, int F_pad, int win,
                      int n_xb, float inv_blur,
                      unsigned long long* launches) {
  count_launch(launches);
  extern __shared__ float4 smem4[];
  const int ch = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = F_pad / FACE_CHUNK;
  const int xw = win / n_xb;
  const int npx = STRIP_H * xw;
  const int l = threadIdx.x % FACE_CHUNK;
  const int h = threadIdx.x / FACE_CHUNK;  // warp-uniform
  const int f = ch * FACE_CHUNK + l;

  const CellRange cr = chunk_cells(agg + (static_cast<size_t>(b) * nc + ch) * 4,
                                   win, n_xb);
  const int n_x = cr.xb_hi - cr.xb_lo + 1;
  const int n_cells = cr.s_hi < cr.s_lo || n_x <= 0
                          ? 0 : (cr.s_hi - cr.s_lo + 1) * n_x;
  const size_t img = static_cast<size_t>(b) * win * win;
  if (n_cells > 0) stage_cell(smem4, dz, dlk, amin, img, cr.s_lo, cr.xb_lo,
                              xw, win);

  const float* tab_b = tab + static_cast<size_t>(b) * TAB_ROWS * F_pad + f;
  float k[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) k[r] = tab_b[static_cast<size_t>(r) * F_pad];
  const float lox = tab_b[static_cast<size_t>(ROW_BBOX) * F_pad];
  const float hix = tab_b[static_cast<size_t>(ROW_BBOX + 1) * F_pad];
  const float loy = tab_b[static_cast<size_t>(ROW_BBOX + 2) * F_pad];
  const float hiy = tab_b[static_cast<size_t>(ROW_BBOX + 3) * F_pad];

  const float cull = sqrtf(X_CULL / inv_blur);
  float acc[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) acc[q] = 0.0f;

  for (int i = 0; i < n_cells; ++i) {
    if (i + 1 < n_cells)
      stage_cell(smem4 + ((i + 1) & 1) * npx, dz, dlk, amin, img,
                 cr.s_lo + (i + 1) / n_x, cr.xb_lo + (i + 1) % n_x, xw, win);
    else
      __pipeline_commit();  // empty group: wait_prior(1) below stays right
    __pipeline_wait_prior(1);
    __syncthreads();  // cell i's cotangents are visible to every thread
    const float4* cot = smem4 + (i & 1) * npx;
    const float x_lo = static_cast<float>((cr.xb_lo + i % n_x) * xw);
    const float y_lo = static_cast<float>((cr.s_lo + i / n_x) * STRIP_H);
    for (int rr = 0; rr < ROWS_PER_GROUP; ++rr) {
      const int row = h * ROWS_PER_GROUP + rr;
      const float py = y_lo + (static_cast<float>(row) + 0.5f);  // exact
      const float bby = fmaxf(loy - py, py - hiy);
      if (bby > cull) continue;
      // the columns within `cull` of the face's bbox in x
      const int x_begin = static_cast<int>(
          ceilf(fmaxf(lox - cull - x_lo - 0.5f, 0.0f)));
      const int x_end = 1 + static_cast<int>(floorf(
          fminf(hix + cull - x_lo - 0.5f, static_cast<float>(xw - 1))));
      // the row's share of plane(), same rounding
      const float by0 = k[1] * py, by1 = k[4] * py, by2 = k[7] * py;
      float sx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float4* crow = cot + row * xw;
      for (int x = x_begin; x < x_end; ++x) {
        const float4 c = crow[x];
        const float xr = static_cast<float>(x) + 0.5f;
        const float px = x_lo + xr;  // exact: small integers + 0.5
        const float d0 = k[0] * px + by0 + k[2];
        const float d1 = k[3] * px + by1 + k[5];
        const float d2 = k[6] * px + by2 + k[8];
        const float bb = fmaxf(fmaxf(lox - px, px - hix), bby);
        const float d = fmaxf(fmaxf(d0, fmaxf(d1, d2)), bb);
        const float absd = fabsf(d);
        const float xs = -(d * absd) * inv_blur;
        if (xs > X_ZERO) {
          const float sig = sigmoid(xs);
          const float g = c.y * (sig * inv_blur) * (2.0f * absd);
          const bool u0 = d == d0;
          const bool u1 = !u0 && d == d1;
          const bool u2 = !u0 && !u1 && d == d2;
          const float g0 = u0 ? g : 0.0f;
          const float g1 = u1 ? g : 0.0f;
          const float g2 = u2 ? g : 0.0f;
          sx[0] += xr * g0; s1[0] += g0;
          sx[1] += xr * g1; s1[1] += g1;
          sx[2] += xr * g2; s1[2] += g2;
        }
        if (__float_as_int(c.z) == f) {  // the depth winner: gz = dz
          sx[3] += xr * c.x;
          s1[3] += c.x;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // rebase sum(x' g) to absolute pixel coords: x = x' + x_lo
        acc[3 * q] += sx[q] + x_lo * s1[q];
        acc[3 * q + 1] += py * s1[q];
        acc[3 * q + 2] += s1[q];
      }
    }
    __syncthreads();  // buffer i & 1 is free for cell i + 2
  }

  // the row groups' sums, added in the order h = 0, 1 and stored once
  float* red = reinterpret_cast<float*>(smem4);
  float* mine = red + (static_cast<size_t>(h) * FACE_CHUNK + l) * RED_STRIDE;
#pragma unroll
  for (int q = 0; q < 12; ++q) mine[q] = acc[q];
  __syncthreads();
  float* out = dplanes + (static_cast<size_t>(b) * F_pad +
                          static_cast<size_t>(ch) * FACE_CHUNK) * 12;
  for (int j = threadIdx.x; j < FACE_CHUNK * 12; j += blockDim.x) {
    const int fl = j / 12, q = j % 12;
    float v = 0.0f;
#pragma unroll
    for (int hh = 0; hh < ROW_SPLIT; ++hh)
      v += red[(static_cast<size_t>(hh) * FACE_CHUNK + fl) * RED_STRIDE + q];
    out[j] = v;
  }
}

}  // namespace mhmocap_raster

extern "C" int mhmocap_raster_bwd(const float* tab, const float* agg,
                                  const float* dz, const float* dlk,
                                  const int* amin, float* dplanes, int B,
                                  int F_pad, int win, int n_xb,
                                  float inv_blur,
                                  unsigned long long* launches,
                                  void* stream) {
  using namespace mhmocap_raster;
  const int npx = STRIP_H * (win / n_xb);
  dim3 grid(F_pad / FACE_CHUNK, B);
  raster_bwd_kernel<<<grid, BWD_THREADS, bwd_shmem_bytes(npx),
                      static_cast<cudaStream_t>(stream)>>>(
      tab, agg, dz, dlk, amin, dplanes, F_pad, win, n_xb, inv_blur,
      launches);
  return static_cast<int>(cudaGetLastError());
}

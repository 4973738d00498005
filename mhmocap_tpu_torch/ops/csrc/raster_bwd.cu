// Backward raster kernel: gradients of the folded plane coefficients
// from the per-pixel depth and silhouette cotangents.
//
// Replaces mhmocap_tpu/ops/raster_pallas.py:_bwd_kernel (launched by
// _run_backward, pl.pallas_call at :650). Per active (cell, chunk) block
// and pixel p, face f:
//   g    = dlk(p) * sigmoid(-d|d| inv_blur) * 2|d| inv_blur
//          routed to the edge plane that won the max, first match in
//          the order d_0, d_1, d_2 (no gradient when the bbox wins);
//   gz   = dz(p) where amin(p) == f (the depth winner), else 0;
//   dC_f += [px, py, 1]^T [g_0, g_1, g_2, gz]
// into the (B, F_pad, 12) plane-coefficient gradient.
//
// What bounds it on the H100: the same pair arithmetic as the forward
// (one expf per pair for the sigmoid), plus the reduction over pixels.
// The TPU kernel reduces with one P^T G matmul per chunk on the MXU; on
// this card the reduction is mapped to threads instead: one thread per
// FACE of the chunk, looping over the cell's pixels, whose cotangents
// are staged in shared memory and read as broadcasts. Each thread then
// owns its face's 12 sums in registers, so the reduction needs no
// shuffles or shared-memory trees, and the block issues one atomicAdd
// per nonzero coefficient per active (cell, chunk) pair. Pixel
// coordinates are summed cell-relative (k + 0.5) and rebased once, as
// the TPU kernel's "split" mode does, which keeps the f32 sums tight.
// The order of the atomics varies between runs, so results agree with
// the plain version to rounding, not bit for bit.

#include "raster_common.cuh"

namespace mhmocap_raster {

__device__ __forceinline__ float sigmoid(float x) {
  // stable form on both sides of 0
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

__global__ void raster_bwd_kernel(const float* __restrict__ tab,
                                  const float* __restrict__ agg,
                                  const int* __restrict__ lists,
                                  const int* __restrict__ bounds,
                                  const float* __restrict__ dz,
                                  const float* __restrict__ dlk,
                                  const int* __restrict__ amin,
                                  float* __restrict__ dplanes, int F_pad,
                                  int win, int n_xb, float inv_blur) {
  extern __shared__ float smem[];
  const int cell_id = blockIdx.x;
  const int b = blockIdx.y;
  const int n_strips = win / STRIP_H;
  const int n_cells = n_strips * n_xb;
  const int nc = F_pad / FACE_CHUNK;
  const Cell c = make_cell(cell_id, win, n_xb);
  float* s_dz = smem;
  float* s_dlk = smem + c.npx;
  int* s_amin = reinterpret_cast<int*>(smem + 2 * c.npx);

  const size_t img = static_cast<size_t>(b) * win * win;
  for (int p = threadIdx.x; p < c.npx; p += blockDim.x) {
    const int row = c.s * STRIP_H + p / c.xw;
    const int col = c.xb * c.xw + p % c.xw;
    const size_t o = img + static_cast<size_t>(row) * win + col;
    s_dz[p] = dz[o];
    s_dlk[p] = dlk[o];
    s_amin[p] = amin[o];
  }
  __syncthreads();

  const float* tab_b = tab + static_cast<size_t>(b) * TAB_ROWS * F_pad;
  const float* agg_b = agg + static_cast<size_t>(b) * nc * 4;
  const int* list =
      lists + (static_cast<size_t>(b) * n_strips + c.s) * nc;
  const int* bnd = bounds + (static_cast<size_t>(b) * n_cells + cell_id) * 2;
  const int j_lo = bnd[0], j_hi = bnd[1];
  const int l = threadIdx.x;  // blockDim.x == FACE_CHUNK

  for (int j = j_lo; j < j_hi; ++j) {
    const int ch = list[j];
    if (!chunk_active(agg_b + ch * 4, c)) continue;
    const int f = ch * FACE_CHUNK + l;
    float k[9];
#pragma unroll
    for (int r = 0; r < 9; ++r) k[r] = tab_b[static_cast<size_t>(r) * F_pad + f];
    const float lox = tab_b[static_cast<size_t>(ROW_BBOX) * F_pad + f];
    const float hix = tab_b[static_cast<size_t>(ROW_BBOX + 1) * F_pad + f];
    const float loy = tab_b[static_cast<size_t>(ROW_BBOX + 2) * F_pad + f];
    const float hiy = tab_b[static_cast<size_t>(ROW_BBOX + 3) * F_pad + f];

    float acc[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) acc[q] = 0.0f;
    for (int p = 0; p < c.npx; ++p) {
      const float xr = static_cast<float>(p % c.xw) + 0.5f;
      const float yr = static_cast<float>(p / c.xw) + 0.5f;
      const float px = c.x_lo + xr;  // exact: small integers + 0.5
      const float py = c.y_lo + yr;
      const float d0 = plane(k[0], k[1], k[2], px, py);
      const float d1 = plane(k[3], k[4], k[5], px, py);
      const float d2 = plane(k[6], k[7], k[8], px, py);
      const float bb = bbox_dist(lox, hix, loy, hiy, px, py);
      const float d = fmaxf(fmaxf(d0, fmaxf(d1, d2)), bb);
      const float absd = fabsf(d);
      const float sig = sigmoid(-(d * absd) * inv_blur);
      const float g = s_dlk[p] * (sig * inv_blur) * (2.0f * absd);
      const bool u0 = d == d0;
      const bool u1 = !u0 && d == d1;
      const bool u2 = !u0 && !u1 && d == d2;
      const float g0 = u0 ? g : 0.0f;
      const float g1 = u1 ? g : 0.0f;
      const float g2 = u2 ? g : 0.0f;
      const float gz = s_amin[p] == f ? s_dz[p] : 0.0f;
      acc[0] += xr * g0; acc[1] += yr * g0; acc[2] += g0;
      acc[3] += xr * g1; acc[4] += yr * g1; acc[5] += g1;
      acc[6] += xr * g2; acc[7] += yr * g2; acc[8] += g2;
      acc[9] += xr * gz; acc[10] += yr * gz; acc[11] += gz;
    }
    float* out = dplanes + (static_cast<size_t>(b) * F_pad + f) * 12;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // rebase sum(x' g) to absolute pixel coords: x = x' + x_lo
      const float a0 = acc[3 * q] + c.x_lo * acc[3 * q + 2];
      const float a1 = acc[3 * q + 1] + c.y_lo * acc[3 * q + 2];
      const float a2 = acc[3 * q + 2];
      if (a0 != 0.0f) atomicAdd(out + 3 * q, a0);
      if (a1 != 0.0f) atomicAdd(out + 3 * q + 1, a1);
      if (a2 != 0.0f) atomicAdd(out + 3 * q + 2, a2);
    }
  }
}

}  // namespace mhmocap_raster

extern "C" int mhmocap_raster_bwd(const float* tab, const float* agg,
                                  const int* lists, const int* bounds,
                                  const float* dz, const float* dlk,
                                  const int* amin, float* dplanes, int B,
                                  int F_pad, int win, int n_xb,
                                  float inv_blur, void* stream) {
  using namespace mhmocap_raster;
  const int n_cells = (win / STRIP_H) * n_xb;
  const int npx = STRIP_H * (win / n_xb);
  const size_t shmem = 3 * static_cast<size_t>(npx) * sizeof(float);
  dim3 grid(n_cells, B);
  raster_bwd_kernel<<<grid, FACE_CHUNK, shmem,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, agg, lists, bounds, dz, dlk, amin, dplanes, F_pad, win, n_xb,
      inv_blur);
  return static_cast<int>(cudaGetLastError());
}

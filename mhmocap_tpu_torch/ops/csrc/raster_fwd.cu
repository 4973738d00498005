// Forward raster kernel: per-pixel z-buffer minimum, winning face id and
// silhouette log-coverage over a batch of bodies.
//
// Replaces mhmocap_tpu/ops/raster_pallas.py:_fwd_kernel (launched by
// _run_forward, pl.pallas_call at :515). Semantics, per window pixel p
// and face f of the folded table (see ops/raster_cuda.py:_fold_pack):
//   d_i  = edge plane i at p, z = z plane at p, bb = bbox Chebyshev clamp
//   d    = max(d_0, d_1, d_2, bb)
//   zmin = min z over faces with d <= 0 and z > znear (BIG where none)
//   amin = the face giving zmin, lowest id on a tie (-1 where none)
//   logkeep = sum_f log_sigmoid(d |d| inv_blur)
// Invalid and padding faces carry d_0 = +1e9 and z = -1e9, so they are
// never covered and their log_sigmoid is exactly 0: no per-face flags.
//
// What bounds it on the H100: arithmetic, not memory. Each (pixel, face)
// pair costs ~20 float ops plus one expf and one log1pf, while the
// face table is read once per active (cell, chunk) block (8 KB) and
// reused by all pixels of the cell. The design answers with:
//   * one block per (body, 8-px strip x ~16-px column cell), one thread
//     per pixel, so a pair is a register-only loop iteration;
//   * the chunk's 16 table rows staged in shared memory and read as
//     warp-wide broadcasts;
//   * the TPU kernel's schedule: each cell walks only the [lo, hi)
//     slice of its strip's x-sorted chunk list and skips chunks whose
//     bbox aggregate misses the cell, so most pairs are never formed.
// Exact f32 throughout (no fast math, no FMA contraction): the z-buffer
// winner must not flip on near-degenerate slivers.

#include "raster_common.cuh"

namespace mhmocap_raster {

__device__ __forceinline__ float log_sigmoid(float x) {
  // stable form: min(x, 0) - log1p(exp(-|x|))
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__global__ void raster_fwd_kernel(const float* __restrict__ tab,
                                  const float* __restrict__ agg,
                                  const int* __restrict__ lists,
                                  const int* __restrict__ bounds,
                                  float* __restrict__ zmin,
                                  float* __restrict__ logkeep,
                                  int* __restrict__ amin, int F_pad,
                                  int win, int n_xb, float inv_blur,
                                  float znear) {
  __shared__ float sh[TAB_ROWS][FACE_CHUNK];
  const int cell_id = blockIdx.x;
  const int b = blockIdx.y;
  const int n_strips = win / STRIP_H;
  const int n_cells = n_strips * n_xb;
  const int nc = F_pad / FACE_CHUNK;
  const Cell c = make_cell(cell_id, win, n_xb);

  const int t = threadIdx.x;  // blockDim.x == c.npx
  const int col = c.xb * c.xw + t % c.xw;
  const int row = c.s * STRIP_H + t / c.xw;
  const float px = static_cast<float>(col) + 0.5f;
  const float py = static_cast<float>(row) + 0.5f;

  const float* tab_b = tab + static_cast<size_t>(b) * TAB_ROWS * F_pad;
  const float* agg_b = agg + static_cast<size_t>(b) * nc * 4;
  const int* list =
      lists + (static_cast<size_t>(b) * n_strips + c.s) * nc;
  const int* bnd = bounds + (static_cast<size_t>(b) * n_cells + cell_id) * 2;
  const int j_lo = bnd[0], j_hi = bnd[1];

  float zbest = BIG;
  int abest = -1;
  float lk = 0.0f;
  for (int j = j_lo; j < j_hi; ++j) {
    const int ch = list[j];
    if (!chunk_active(agg_b + ch * 4, c)) continue;  // uniform per block
    __syncthreads();  // the previous chunk's shared reads are done
    for (int i = t; i < TAB_ROWS * FACE_CHUNK; i += blockDim.x) {
      const int r = i / FACE_CHUNK, l = i % FACE_CHUNK;
      sh[r][l] = tab_b[static_cast<size_t>(r) * F_pad + ch * FACE_CHUNK + l];
    }
    __syncthreads();
    for (int l = 0; l < FACE_CHUNK; ++l) {
      const float d0 = plane(sh[0][l], sh[1][l], sh[2][l], px, py);
      const float d1 = plane(sh[3][l], sh[4][l], sh[5][l], px, py);
      const float d2 = plane(sh[6][l], sh[7][l], sh[8][l], px, py);
      const float zi = plane(sh[9][l], sh[10][l], sh[11][l], px, py);
      const float bb = bbox_dist(sh[ROW_BBOX][l], sh[ROW_BBOX + 1][l],
                                 sh[ROW_BBOX + 2][l], sh[ROW_BBOX + 3][l],
                                 px, py);
      const float d = fmaxf(fmaxf(d0, fmaxf(d1, d2)), bb);
      if (d <= 0.0f && zi > znear) {
        const int id = ch * FACE_CHUNK + l;
        if (zi < zbest || (zi == zbest && id < abest)) {
          zbest = zi;
          abest = id;
        }
      }
      lk += log_sigmoid((d * fabsf(d)) * inv_blur);
    }
  }
  const size_t o = static_cast<size_t>(b) * win * win +
                   static_cast<size_t>(row) * win + col;
  zmin[o] = zbest;
  logkeep[o] = lk;
  amin[o] = zbest >= BIG ? -1 : abest;
}

}  // namespace mhmocap_raster

extern "C" int mhmocap_raster_fwd(const float* tab, const float* agg,
                                  const int* lists, const int* bounds,
                                  float* zmin, float* logkeep, int* amin,
                                  int B, int F_pad, int win, int n_xb,
                                  float inv_blur, float znear,
                                  void* stream) {
  using namespace mhmocap_raster;
  const int n_cells = (win / STRIP_H) * n_xb;
  const int npx = STRIP_H * (win / n_xb);
  dim3 grid(n_cells, B);
  raster_fwd_kernel<<<grid, npx, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, agg, lists, bounds, zmin, logkeep, amin, F_pad, win, n_xb,
      inv_blur, znear);
  return static_cast<int>(cudaGetLastError());
}

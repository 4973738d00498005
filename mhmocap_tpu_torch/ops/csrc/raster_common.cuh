// Shared layout constants and helpers of the raster kernel pair
// (raster_fwd.cu, raster_bwd.cu). The Python side (ops/raster_cuda.py)
// packs the tables in exactly this layout.
#pragma once

#include <cuda_runtime.h>

namespace mhmocap_raster {

constexpr int STRIP_H = 8;       // cell height in pixels
constexpr int FACE_CHUNK = 128;  // faces per scheduled chunk
constexpr int TAB_ROWS = 16;     // 12 folded plane coefficients + 4 bbox
constexpr int ROW_BBOX = 12;     // rows 12..15: lox, hix, loy, hiy
constexpr float BIG = 3.0e38f;

// Cell geometry shared by both kernels: cell = s * n_xb + xb covers
// rows [8 s, 8 s + 8) and columns [xb xw, xb xw + xw) of the window.
struct Cell {
  int s, xb, xw, npx;
  float x_lo, y_lo;
};

__device__ __forceinline__ Cell make_cell(int cell, int win, int n_xb) {
  Cell c;
  c.s = cell / n_xb;
  c.xb = cell % n_xb;
  c.xw = win / n_xb;
  c.npx = STRIP_H * c.xw;
  c.x_lo = static_cast<float>(c.xb * c.xw);
  c.y_lo = static_cast<float>(c.s * STRIP_H);
  return c;
}

// The chunk's reach-expanded bbox aggregate against the cell (the
// 4-scalar activity test of the TPU kernel's _cell_active).
__device__ __forceinline__ bool chunk_active(const float* a, const Cell& c) {
  const float x_hi = c.x_lo + static_cast<float>(c.xw);
  const float y_hi = c.y_lo + static_cast<float>(STRIP_H);
  return (a[0] < x_hi) && (a[1] >= c.x_lo) && (a[2] < y_hi) &&
         (a[3] >= c.y_lo);
}

// The cells a chunk reaches: strips [s_lo, s_hi] x x-blocks
// [xb_lo, xb_hi] (empty where lo > hi), exactly the cells for which
// chunk_active holds. The test is separable: a0 < (xb + 1) xw iff
// xb >= floor(a0 / xw), and a1 >= xb xw iff xb <= floor(a1 / xw); the
// same in y with STRIP_H. The aggregate is clamped to [-1, win] first
// (an all-invalid chunk carries +-3e38), which changes no answer.
// ops/raster_cuda.py:_chunk_cells is the same arithmetic in torch.
struct CellRange {
  int s_lo, s_hi, xb_lo, xb_hi;
};

// floor(a / w) for a in [-1, win]: the float quotient, then one exact
// integer correction (k * w is a small integer, exact in f32).
__device__ __forceinline__ int floor_div(float a, int w) {
  int k = static_cast<int>(floorf(a / static_cast<float>(w)));
  if (static_cast<float>(k * w) > a) {
    --k;
  } else if (static_cast<float>((k + 1) * w) <= a) {
    ++k;
  }
  return k;
}

__device__ __forceinline__ float clamp_to_window(float v, int win) {
  return fminf(fmaxf(v, -1.0f), static_cast<float>(win));
}

__device__ __forceinline__ CellRange chunk_cells(const float* a, int win,
                                                 int n_xb) {
  const int xw = win / n_xb;
  CellRange r;
  r.xb_lo = max(floor_div(clamp_to_window(a[0], win), xw), 0);
  r.xb_hi = min(floor_div(clamp_to_window(a[1], win), xw), n_xb - 1);
  r.s_lo = max(floor_div(clamp_to_window(a[2], win), STRIP_H), 0);
  r.s_hi = min(floor_div(clamp_to_window(a[3], win), STRIP_H),
               win / STRIP_H - 1);
  return r;
}

// Affine plane evaluation with the plain torch version's rounding:
// (a * px + b * py) + c, each product and sum rounded (the library is
// built with --fmad=false so nvcc does not contract into FMAs).
__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return a * px + b * py + c;
}

__device__ __forceinline__ float bbox_dist(float lox, float hix, float loy,
                                           float hiy, float px, float py) {
  return fmaxf(fmaxf(lox - px, px - hix), fmaxf(loy - py, py - hiy));
}

}  // namespace mhmocap_raster

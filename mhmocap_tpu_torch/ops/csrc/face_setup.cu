// The raster's face set-up: from B bodies' projected vertices to the
// raster kernels' tables (forward), and from the tables' cotangents back
// to the vertices (backward).
//
// Replaces no TPU kernel. In the JAX package, and on CPU tensors in the
// port, the set-up is array code: the face gather uvz[:, faces], the
// window shift, ops/rasterizer.py:face_planes and
// ops/raster_cuda.py:_fold_pack, some 140 small ops forward and 240
// backward a raster call, the backward's gather ending in a sorted
// index_put. On the card each op is a launch, and those launches, not
// the arithmetic, were the set-up's cost.
//
// face_setup_fwd_kernel: one block per (128-face chunk, body), one
// thread per face. A thread gathers its face's 3 corners, shifts them by
// the window origin, computes face_planes' 12 coefficients, bbox and
// flags in face_planes' order of operations, folds them as _fold_pack
// does (an invalid face: d_0 = +D_INVALID, the other edges 0, bbox
// -+BIG; a face without depth: z plane (0, 0, -D_INVALID); a padding
// face: both) and writes its column of tab (B, 16, F_pad). The block
// then takes the chunk's reach-expanded bbox aggregate over its faces
// with valid silhouette into agg (B, nc, 4). Every step is one IEEE
// single operation as in the torch chain (the library is built with
// --fmad=false; rsqrtf and true division, as torch's rsqrt and div), so
// tab and agg are the chain's bit for bit.
//
// face_setup_bwd_kernel: one thread per (vertex, body). It walks the
// vertex's (face, corner) incidences in ascending order (a CSR built
// once per face table on the host), recomputes each incident face's
// forward terms, takes the analytic derivative of its 12 folded
// coefficients with respect to its 9 corner inputs (u, v, z of 3
// corners) at dtab (B, F_pad, 12), the raster backward's output, and
// adds the corner's 3 components. Zero where the fold substituted a
// constant, where clamp(ex^2 + ey^2, eps) clamped (through the clamp
// only) and through the bbox, which is detached. No atomics and no
// sort: the sum runs in the order of the stable-sorted index_put that
// autograd ran for the gather, and two runs agree bit for bit.
//
// What bounds them on the H100: bytes. At B=29, V=6890, F=12672 the
// forward reads 2.4 MB of vertices and writes 23.5 MB of tables; the
// backward reads 17.6 MB of dtab (each face's row by three threads,
// the two later reads from L2), the vertices, and writes 2.4 MB: a few
// microseconds each at 3.35 TB/s, under the launch itself.

#include <cuda_runtime.h>

#include <cstdint>

#include "raster_common.cuh"

namespace mhmocap_faces {

using mhmocap_raster::BIG;
using mhmocap_raster::FACE_CHUNK;
using mhmocap_raster::TAB_ROWS;
using mhmocap_raster::count_launch;

constexpr float D_INVALID = 1.0e9f;
constexpr float EDGE_EPS = 1e-12f;   // face_planes' eps
constexpr float AREA_EPS = 1e-9f;    // face_planes' ok_area threshold
constexpr int BWD_THREADS = 128;

// torch's min/max reductions: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// torch.clamp(s, min=EDGE_EPS): NaN stays NaN
__device__ __forceinline__ float clamp_eps(float s) {
  return isnan(s) ? s : fmaxf(s, EDGE_EPS);
}

// A face's window-local corners: (u, v) of a, b, c and their z.
struct Corners {
  float ax, ay, bx, by, cx, cy, z0, z1, z2;
};

__device__ __forceinline__ Corners load_corners(const float* uvz_b,
                                                const int* faces, int f,
                                                float ox, float oy) {
  const int ia = 3 * faces[3 * f], ib = 3 * faces[3 * f + 1],
            ic = 3 * faces[3 * f + 2];
  Corners c;
  c.ax = uvz_b[ia] - ox;
  c.ay = uvz_b[ia + 1] - oy;
  c.z0 = uvz_b[ia + 2];
  c.bx = uvz_b[ib] - ox;
  c.by = uvz_b[ib + 1] - oy;
  c.z1 = uvz_b[ib + 2];
  c.cx = uvz_b[ic] - ox;
  c.cy = uvz_b[ic + 1] - oy;
  c.z2 = uvz_b[ic + 2];
  return c;
}

// face_planes' shared terms: the signed double area, its sign, the
// inverse area (0 where |area| <= AREA_EPS) and the two flags.
struct Terms {
  float area, sgn, inv_a;
  bool ok_sil, ok_depth;
};

__device__ __forceinline__ Terms face_terms(const Corners& c, float znear) {
  Terms t;
  t.area = (c.bx - c.ax) * (c.cy - c.ay) - (c.by - c.ay) * (c.cx - c.ax);
  t.sgn = t.area < 0.0f ? -1.0f : 1.0f;
  const bool ok_area = fabsf(t.area) > AREA_EPS;
  t.inv_a = (ok_area ? 1.0f : 0.0f) / (ok_area ? t.area : 1.0f);
  t.ok_sil = (c.z0 > znear) && (c.z1 > znear) && (c.z2 > znear);
  t.ok_depth = t.ok_sil && ok_area;
  return t;
}

// The unit edge line from (x0, y0) to (x1, y1), inside negative:
// (nx, ny, c) = sgn (ey, -ex, ex y0 - ey x0) / |e|.
__device__ __forceinline__ void edge_line(float x0, float y0, float x1,
                                          float y1, float sgn, float* out) {
  const float ex = x1 - x0, ey = y1 - y0;
  const float inv_len = rsqrtf(clamp_eps(ex * ex + ey * ey));
  out[0] = sgn * ey * inv_len;
  out[1] = -sgn * ex * inv_len;
  out[2] = sgn * (ex * y0 - ey * x0) * inv_len;
}

// The edge line's derivative: cotangents (gnx, gny, gc) onto the two
// end points, added into g0 = (x0, y0) and g1 = (x1, y1).
__device__ __forceinline__ void edge_line_grad(float x0, float y0, float x1,
                                               float y1, float sgn,
                                               const float* g, float* g0x,
                                               float* g0y, float* g1x,
                                               float* g1y) {
  const float ex = x1 - x0, ey = y1 - y0;
  const float s2 = ex * ex + ey * ey;
  const float inv_len = rsqrtf(clamp_eps(s2));
  const float sr = sgn * inv_len;
  const float gw = sr * g[2];               // onto w = ex y0 - ey x0
  float g_ex = gw * y0 - sr * g[1];
  float g_ey = sr * g[0] - gw * x0;
  if (s2 >= EDGE_EPS) {                     // the clamp passes
    const float w = ex * y0 - ey * x0;
    const float g_inv = sgn * (g[0] * ey - g[1] * ex + g[2] * w);
    const float g_s2 = -0.5f * g_inv * (inv_len * inv_len * inv_len);
    g_ex += 2.0f * ex * g_s2;
    g_ey += 2.0f * ey * g_s2;
  }
  *g0x += -g_ex - gw * ey;
  *g0y += -g_ey + gw * ex;
  *g1x += g_ex;
  *g1y += g_ey;
}

// The derivative of a face's 12 folded coefficients, cotangents g, with
// respect to its 9 corner inputs: out = (u, v, z) of a, b, c.
__device__ __forceinline__ void face_grad(const Corners& c, const Terms& t,
                                          const float* g, float* out) {
  float gax = 0.0f, gay = 0.0f, gbx = 0.0f, gby = 0.0f, gcx = 0.0f,
        gcy = 0.0f, gz0 = 0.0f, gz1 = 0.0f, gz2 = 0.0f;
  if (t.ok_sil) {
    edge_line_grad(c.ax, c.ay, c.bx, c.by, t.sgn, g, &gax, &gay, &gbx, &gby);
    edge_line_grad(c.bx, c.by, c.cx, c.cy, t.sgn, g + 3, &gbx, &gby, &gcx,
                   &gcy);
    edge_line_grad(c.cx, c.cy, c.ax, c.ay, t.sgn, g + 6, &gcx, &gcy, &gax,
                   &gay);
  }
  if (t.ok_depth) {
    // (za, zb, zc) = (Na, Nb, Nc) inv_a, inv_a = 1 / area
    const float Na = c.z0 * (c.by - c.cy) + c.z1 * (c.cy - c.ay) +
                     c.z2 * (c.ay - c.by);
    const float Nb = c.z0 * (c.cx - c.bx) + c.z1 * (c.ax - c.cx) +
                     c.z2 * (c.bx - c.ax);
    const float Nc = c.z0 * (c.bx * c.cy - c.by * c.cx) +
                     c.z1 * (c.cx * c.ay - c.cy * c.ax) +
                     c.z2 * (c.ax * c.by - c.ay * c.bx);
    const float ga = g[9] * t.inv_a, gb = g[10] * t.inv_a,
                gc = g[11] * t.inv_a;
    const float g_area =
        -(g[9] * Na + g[10] * Nb + g[11] * Nc) * (t.inv_a / t.area);
    gz0 = ga * (c.by - c.cy) + gb * (c.cx - c.bx) +
          gc * (c.bx * c.cy - c.by * c.cx);
    gz1 = ga * (c.cy - c.ay) + gb * (c.ax - c.cx) +
          gc * (c.cx * c.ay - c.cy * c.ax);
    gz2 = ga * (c.ay - c.by) + gb * (c.bx - c.ax) +
          gc * (c.ax * c.by - c.ay * c.bx);
    gax += gb * (c.z1 - c.z2) + gc * (c.z2 * c.by - c.z1 * c.cy) +
           g_area * (c.by - c.cy);
    gay += ga * (c.z2 - c.z1) + gc * (c.z1 * c.cx - c.z2 * c.bx) +
           g_area * (c.cx - c.bx);
    gbx += gb * (c.z2 - c.z0) + gc * (c.z0 * c.cy - c.z2 * c.ay) +
           g_area * (c.cy - c.ay);
    gby += ga * (c.z0 - c.z2) + gc * (c.z2 * c.ax - c.z0 * c.cx) +
           g_area * (c.ax - c.cx);
    gcx += gb * (c.z0 - c.z1) + gc * (c.z1 * c.ay - c.z0 * c.by) +
           g_area * (c.ay - c.by);
    gcy += ga * (c.z1 - c.z0) + gc * (c.z0 * c.bx - c.z1 * c.ax) +
           g_area * (c.bx - c.ax);
  }
  out[0] = gax; out[1] = gay; out[2] = gz0;
  out[3] = gbx; out[4] = gby; out[5] = gz1;
  out[6] = gcx; out[7] = gcy; out[8] = gz2;
}

__global__ void __launch_bounds__(FACE_CHUNK)
face_setup_fwd_kernel(const float* __restrict__ uvz,
                      const int64_t* __restrict__ origin,
                      const int* __restrict__ faces, float* __restrict__ tab,
                      float* __restrict__ agg, int V, int F, int F_pad,
                      float znear, float reach_x, float reach_y,
                      unsigned long long* launches) {
  count_launch(launches);
  const int b = blockIdx.y;
  const int f = blockIdx.x * FACE_CHUNK + threadIdx.x;
  float col[TAB_ROWS];
  // a padding face, also what an invalid face folds to
#pragma unroll
  for (int r = 0; r < 12; ++r) col[r] = 0.0f;
  col[2] = D_INVALID;
  col[11] = -D_INVALID;
  col[12] = -BIG;
  col[13] = BIG;
  col[14] = -BIG;
  col[15] = BIG;
  float lo_x = BIG, hi_x = -BIG, lo_y = BIG, hi_y = -BIG;
  if (f < F) {
    const Corners c = load_corners(
        uvz + static_cast<int64_t>(b) * V * 3, faces, f,
        static_cast<float>(origin[2 * b]), static_cast<float>(origin[2 * b + 1]));
    const Terms t = face_terms(c, znear);
    if (t.ok_sil) {
      edge_line(c.ax, c.ay, c.bx, c.by, t.sgn, col);
      edge_line(c.bx, c.by, c.cx, c.cy, t.sgn, col + 3);
      edge_line(c.cx, c.cy, c.ax, c.ay, t.sgn, col + 6);
      col[12] = min_nan(min_nan(c.ax, c.bx), c.cx);
      col[13] = max_nan(max_nan(c.ax, c.bx), c.cx);
      col[14] = min_nan(min_nan(c.ay, c.by), c.cy);
      col[15] = max_nan(max_nan(c.ay, c.by), c.cy);
      lo_x = col[12];
      hi_x = col[13];
      lo_y = col[14] - reach_y;
      hi_y = col[15] + reach_y;
    }
    if (t.ok_depth) {
      col[9] = (c.z0 * (c.by - c.cy) + c.z1 * (c.cy - c.ay) +
                c.z2 * (c.ay - c.by)) * t.inv_a;
      col[10] = (c.z0 * (c.cx - c.bx) + c.z1 * (c.ax - c.cx) +
                 c.z2 * (c.bx - c.ax)) * t.inv_a;
      col[11] = (c.z0 * (c.bx * c.cy - c.by * c.cx) +
                 c.z1 * (c.cx * c.ay - c.cy * c.ax) +
                 c.z2 * (c.ax * c.by - c.ay * c.bx)) * t.inv_a;
    }
  }
  float* out = tab + static_cast<int64_t>(b) * TAB_ROWS * F_pad + f;
#pragma unroll
  for (int r = 0; r < TAB_ROWS; ++r) {
    out[static_cast<int64_t>(r) * F_pad] = col[r];
  }

  // the chunk's aggregate over its faces with valid silhouette
  for (int s = 16; s > 0; s >>= 1) {
    lo_x = min_nan(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, s));
    hi_x = max_nan(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, s));
    lo_y = min_nan(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, s));
    hi_y = max_nan(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, s));
  }
  __shared__ float part[FACE_CHUNK / 32][4];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = lo_x;
    part[warp][1] = hi_x;
    part[warp][2] = lo_y;
    part[warp][3] = hi_y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < FACE_CHUNK / 32; ++w) {
      lo_x = min_nan(lo_x, part[w][0]);
      hi_x = max_nan(hi_x, part[w][1]);
      lo_y = min_nan(lo_y, part[w][2]);
      hi_y = max_nan(hi_y, part[w][3]);
    }
    float* a = agg + (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * 4;
    a[0] = lo_x - reach_x;
    a[1] = hi_x + reach_x;
    a[2] = lo_y;
    a[3] = hi_y;
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
face_setup_bwd_kernel(const float* __restrict__ uvz,
                      const int64_t* __restrict__ origin,
                      const int* __restrict__ faces,
                      const int* __restrict__ ptr,
                      const int* __restrict__ incidence,
                      const float* __restrict__ dtab,
                      float* __restrict__ duvz, int V, int F_pad,
                      float znear, unsigned long long* launches) {
  count_launch(launches);
  const int b = blockIdx.y;
  const int v = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (v >= V) return;
  const float* uvz_b = uvz + static_cast<int64_t>(b) * V * 3;
  const float ox = static_cast<float>(origin[2 * b]);
  const float oy = static_cast<float>(origin[2 * b + 1]);
  const float* dtab_b = dtab + static_cast<int64_t>(b) * F_pad * 12;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int k = ptr[v]; k < ptr[v + 1]; ++k) {
    const int p = incidence[k];
    const int f = p / 3, corner = p - 3 * f;
    const Corners c = load_corners(uvz_b, faces, f, ox, oy);
    const Terms t = face_terms(c, znear);
    float g[12];
    const float4* row = reinterpret_cast<const float4*>(dtab_b + 12 * f);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 x = row[q];
      g[4 * q] = x.x;
      g[4 * q + 1] = x.y;
      g[4 * q + 2] = x.z;
      g[4 * q + 3] = x.w;
    }
    float d[9];
    face_grad(c, t, g, d);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      acc[j] += corner == 0 ? d[j] : (corner == 1 ? d[3 + j] : d[6 + j]);
    }
  }
  float* out = duvz + (static_cast<int64_t>(b) * V + v) * 3;
  out[0] = acc[0];
  out[1] = acc[1];
  out[2] = acc[2];
}

}  // namespace mhmocap_faces

extern "C" {

// tab (B, 16, F_pad) and agg (B, F_pad / 128, 4) from uvz (B, V, 3),
// origin (B, 2) int64 and faces (F, 3) int32. Returns a cudaError_t.
int mhmocap_face_setup_fwd(const float* uvz, const int64_t* origin,
                           const int* faces, float* tab, float* agg, int B,
                           int V, int F, int F_pad, float znear,
                           float reach_x, float reach_y,
                           unsigned long long* launches,
                           cudaStream_t stream) {
  const dim3 grid(F_pad / mhmocap_faces::FACE_CHUNK, B);
  mhmocap_faces::face_setup_fwd_kernel<<<grid, mhmocap_faces::FACE_CHUNK, 0,
                                         stream>>>(
      uvz, origin, faces, tab, agg, V, F, F_pad, znear, reach_x, reach_y,
      launches);
  return static_cast<int>(cudaGetLastError());
}

// duvz (B, V, 3) from dtab (B, F_pad, 12) over the CSR (ptr (V + 1),
// incidence (3 F) of 3 f + corner). Returns a cudaError_t.
int mhmocap_face_setup_bwd(const float* uvz, const int64_t* origin,
                           const int* faces, const int* ptr,
                           const int* incidence, const float* dtab,
                           float* duvz, int B, int V, int F_pad, float znear,
                           unsigned long long* launches,
                           cudaStream_t stream) {
  const dim3 grid((V + mhmocap_faces::BWD_THREADS - 1) /
                      mhmocap_faces::BWD_THREADS,
                  B);
  mhmocap_faces::face_setup_bwd_kernel<<<grid, mhmocap_faces::BWD_THREADS, 0,
                                         stream>>>(
      uvz, origin, faces, ptr, incidence, dtab, duvz, V, F_pad, znear,
      launches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The chunk's window losses: the depth and silhouette terms of the fit
// (engine/optimizer.py _chunk_loss_core), from each window group's
// raster outputs (zbuf, sil) to the chunk's two scalars (forward), and
// from the scalars' cotangents back to zbuf, sil and the frames' z
// bounds (backward).
//
// Replaces no TPU kernel. In the JAX package, and on CPU tensors in the
// port (ops/window_loss.py:window_losses_plain), the terms are array
// code: the depth target over whole frames, the occlusion keep masks and
// their full-frame sums, four window gathers a group, the disparity and
// log chains, the window sums, and all of their autograd backward,
// which ends in the sorted index_put of the target's gather. Some 250 to
// 360 small ops a chunk, each a launch on the card, and those launches,
// not the arithmetic, were the terms' cost.
//
// Forward: window_loss_fwd_kernel, then window_loss_fwd_finish.
//   * A body block (one per body of every group, group by group, frame
//     by frame, person by person: the "slots") walks its window's pixels
//     and reads the frame's depths, eroded mask and masks at origin +
//     (i, j) where they lie in the full frames: the target disparity
//     depths (1 / min_z - 1 / max_z) + 1 / max_z, the keep mask (no
//     person in front, by root depth and then index, covers the pixel),
//     zbuf's disparity and both logs, in the torch chain's operations
//     and order. It sums dmask, dmask log(zbuf disparity), dmask
//     log(target), (keep (sil - seg))^2 and keep seg.
//   * A frame block (one per (frame, person, part of FRAME_PART pixels))
//     counts keep and keep seg over its part of the whole frame.
//   * The finish (one block) turns each slot's sums into its per-body
//     terms, keeps (n_pix, diff, n_keep) for the backward, and adds the
//     terms into the two scalars: bodies in slot order within a group,
//     then the groups in window_groups order.
// Backward: window_loss_bwd_kernel, then window_loss_bwd_finish.
//   * A body block recomputes its pixels and writes d_zbuf and d_sil in
//     the order of operations autograd runs for the chain (the where /
//     isfinite masking, the two clamps, which pass the gradient at
//     x == min, the reciprocal and the log), and sums the target's
//     cotangent d_t and d_t depth over its window.
//   * The finish (one thread a frame) adds the frame's bodies' sums in
//     slot order into d_min_z and d_max_z through the reciprocals.
// Every step is one IEEE single operation as in the torch chain (the
// library is built with --fmad=false; true division and logf), so each
// pixel's values are the chain's bit for bit. Only the order of the sums
// differs from torch's reductions. Sums of 0/1 values (the counts of
// dmask, keep and keep seg) are exact integers in any order below 2^24.
// No float atomics: each block reduces in a fixed tree and the finishes
// add in a fixed order, so two runs agree bit for bit.
//
// What bounds them on the H100: bytes, and at these sizes the launch.
// At ts11-fit's chunk (C=39, N=3, 240x135, windows 112/80/64) the
// forward reads zbuf and sil (7.2 MB), the depths and eroded masks at
// the window pixels and the masks of whole frames (15.2 MB; the body
// blocks read the masks at their windows again, mostly from L2), ~29 MB
// in all; the backward reads about as much and writes 7.2 MB: under
// 10 us each at 3.35 TB/s. Body blocks of 512 threads over 64^2 to
// 160^2 pixels and frame blocks of FRAME_PART pixels give a ts1-fit or
// ts11-fit chunk's forward 290 or 351 blocks for the 132 SMs; its
// backward has the body blocks alone (58 or 117).

#include <cuda_runtime.h>

#include <cstdint>

#include "raster_common.cuh"

namespace mhmocap_window_loss {

using mhmocap_raster::count_launch;

constexpr int MAX_GROUPS = 16;
constexpr int MAX_PEOPLE = 32;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int FINISH_THREADS = 256;
constexpr int FRAME_PART = 16384;
constexpr int SAVED = 5;   // a slot's n_pix, diff, n_keep, depth, sil term
constexpr float DISP_SHIFT = 0.2f;   // zbuf + 0.2 before the reciprocal

// A window group: its bodies' raster outputs (C, ng, win, win), their
// origins (C, ng, 2) as (x0, y0), the backward's outputs, and where its
// slots and people start.
struct Group {
  const float* zbuf;
  const float* sil;
  const int64_t* origin;
  float* d_zbuf;
  float* d_sil;
  int win, ng, slot0, first;
};

struct Geometry {
  Group group[MAX_GROUPS];
  int people[MAX_PEOPLE];   // the groups' people, group after group
  int n_groups, slots, C, N, H, W, parts;
  long long z_sc, z_sn;     // the strides of z (C, N)
  float eps;
};

// The per-frame and per-body inputs shared by both directions.
struct Inputs {
  const float* depths;      // (C, H, W)
  const float* min_z;       // (C)
  const float* max_z;       // (C)
  const float* seg;         // (C, N, H, W), 0/1
  const float* seg_er;      // (C, N, H, W), 0/1
  const float* z;           // (C, N) at strides z_sc, z_sn
  const float* dw;          // (C, N)
  const float* sil_gate;    // (C, N)
};

// Slot s: its group, frame c, place k in the group, person n and index
// c ng + k in the group's tensors.
struct Body {
  int gi, c, k, n, local;
};

__device__ __forceinline__ Body body_of(const Geometry& geo, int s) {
  int gi = 0;
  while (gi + 1 < geo.n_groups && s >= geo.group[gi + 1].slot0) ++gi;
  const Group& g = geo.group[gi];
  Body b;
  b.gi = gi;
  b.local = s - g.slot0;
  b.c = b.local / g.ng;
  b.k = b.local - b.c * g.ng;
  b.n = geo.people[g.first + b.k];
  return b;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// front[q]: person q is in front of person n in frame c (its root is
// nearer, or as near with a lower index), into shared memory.
__device__ __forceinline__ void load_front(const Geometry& geo,
                                           const Inputs& in, int c, int n,
                                           int* front) {
  const int q = threadIdx.x;
  if (q < geo.N) {
    const float zp = in.z[c * geo.z_sc + n * geo.z_sn];
    const float zq = in.z[c * geo.z_sc + q * geo.z_sn];
    front[q] = (zq < zp) || (zq == zp && q < n);
  }
  __syncthreads();
}

// 1 where no person in front of the body's person covers the pixel:
// seg_c is the frame's (N, H, W) masks.
__device__ __forceinline__ float keep_at(const float* seg_c, int64_t hw,
                                         int N, int64_t pix,
                                         const int* front) {
  for (int q = 0; q < N; ++q) {
    if (front[q] && seg_c[q * hw + pix] > 0.0f) return 0.0f;
  }
  return 1.0f;
}

// Adds NV values over the block in a fixed tree; thread 0 holds the sums.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV]) {
  __shared__ float part[NV][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    }
    if (lane == 0) part[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[k] = lane < WARPS ? part[k][lane] : 0.0f;
      for (int o = 16; o > 0; o >>= 1) {
        v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
      }
    }
  }
}

// A window pixel's forward values, as the torch chain computes them.
struct Pixel {
  bool valid;
  float dmask, x2, r, t;
};

__device__ __forceinline__ Pixel pixel_at(float zb, float ser, float dwb,
                                          float depth, float a, float rmax,
                                          float eps) {
  Pixel p;
  p.valid = isfinite(zb);
  p.dmask = ((p.valid ? 1.0f : 0.0f) * ser) * dwb;
  p.x2 = (p.valid ? zb : 1.0f) + DISP_SHIFT;
  p.r = 1.0f / clamp_min(p.x2, eps);     // zbuf's disparity
  p.t = depth * a + rmax;                // the target disparity
  return p;
}

__global__ void __launch_bounds__(THREADS)
window_loss_fwd_kernel(const __grid_constant__ Geometry geo, Inputs in,
                       float* __restrict__ wsum, float* __restrict__ fcount,
                       unsigned long long* launches) {
  count_launch(launches);
  __shared__ int front[MAX_PEOPLE];
  const int64_t hw = static_cast<int64_t>(geo.H) * geo.W;
  const float eps = geo.eps;
  if (blockIdx.x >= geo.slots) {
    // a part of a whole frame: the keep and keep seg counts
    const int r = blockIdx.x - geo.slots;
    const int part = r % geo.parts, cn = r / geo.parts;
    const int c = cn / geo.N, n = cn - c * geo.N;
    load_front(geo, in, c, n, front);
    const float* seg_c = in.seg + static_cast<int64_t>(c) * geo.N * hw;
    const float* seg_n = seg_c + n * hw;
    const int64_t lo = static_cast<int64_t>(part) * FRAME_PART;
    const int64_t hi = lo + FRAME_PART < hw ? lo + FRAME_PART : hw;
    float v[2] = {0.0f, 0.0f};
    for (int64_t pix = lo + threadIdx.x; pix < hi; pix += THREADS) {
      const float keep = keep_at(seg_c, hw, geo.N, pix, front);
      v[0] += keep;
      v[1] += keep * seg_n[pix];
    }
    block_sum(v);
    if (threadIdx.x == 0) {
      fcount[2 * r] = v[0];
      fcount[2 * r + 1] = v[1];
    }
    return;
  }
  // a body's window
  const int s = blockIdx.x;
  const Body b = body_of(geo, s);
  const Group& g = geo.group[b.gi];
  load_front(geo, in, b.c, b.n, front);
  const int win = g.win;
  const int64_t wpix = static_cast<int64_t>(win) * win;
  const float* zbuf = g.zbuf + b.local * wpix;
  const float* sil = g.sil + b.local * wpix;
  const int64_t ox = g.origin[2 * b.local], oy = g.origin[2 * b.local + 1];
  const float* depth = in.depths + b.c * hw;
  const float* seg_c = in.seg + static_cast<int64_t>(b.c) * geo.N * hw;
  const float* seg_n = seg_c + b.n * hw;
  const float* ser_n = in.seg_er + (static_cast<int64_t>(b.c) * geo.N + b.n)
                                       * hw;
  const float rmin = 1.0f / in.min_z[b.c], rmax = 1.0f / in.max_z[b.c];
  const float a = rmin - rmax;
  const float dwb = in.dw[b.c * geo.N + b.n];
  // n_pix, dmask log(zbuf disparity), dmask log(target), in_win, keep seg
  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < wpix; p += THREADS) {
    const int i = p / win, j = p - i * win;
    const int64_t pix = (oy + i) * geo.W + ox + j;
    const Pixel px = pixel_at(zbuf[p], ser_n[pix], dwb, depth[pix], a, rmax,
                              eps);
    v[0] += px.dmask;
    v[1] += px.dmask * logf(clamp_min(px.r, eps));
    v[2] += px.dmask * logf(clamp_min(px.t, eps));
    const float keep = keep_at(seg_c, hw, geo.N, pix, front);
    const float sg = seg_n[pix];
    const float e = keep * (sil[p] - sg);
    v[3] += e * e;
    v[4] += keep * sg;
  }
  block_sum(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) wsum[5 * s + q] = v[q];
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
window_loss_fwd_finish(const __grid_constant__ Geometry geo, Inputs in,
                       const float* __restrict__ wsum,
                       const float* __restrict__ fcount,
                       float* __restrict__ saved, float* out_depth,
                       float* out_sil, unsigned long long* launches) {
  count_launch(launches);
  for (int s = threadIdx.x; s < geo.slots; s += FINISH_THREADS) {
    const Body b = body_of(geo, s);
    const float* w = wsum + 5 * s;
    const float* f = fcount
        + 2 * static_cast<int64_t>(b.c * geo.N + b.n) * geo.parts;
    float keep = 0.0f, seg_keep = 0.0f;
    for (int q = 0; q < geo.parts; ++q) {
      keep += f[2 * q];
      seg_keep += f[2 * q + 1];
    }
    const float n_keep = keep + 1.0f;
    const float n_pix = w[0] + 1.0f;
    const float diff = w[1] / n_pix - w[2] / n_pix;
    const float outside = seg_keep - w[4];
    float* out = saved + SAVED * s;
    out[0] = n_pix;
    out[1] = diff;
    out[2] = n_keep;
    out[3] = diff * diff;
    out[4] = in.sil_gate[b.c * geo.N + b.n] * (w[3] + outside) / n_keep;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float depth = 0.0f, sil = 0.0f;
    for (int gi = 0; gi < geo.n_groups; ++gi) {
      const Group& g = geo.group[gi];
      float gd = 0.0f, gs = 0.0f;
      for (int s = g.slot0; s < g.slot0 + geo.C * g.ng; ++s) {
        gd += saved[SAVED * s + 3];
        gs += saved[SAVED * s + 4];
      }
      depth += gd;
      sil += gs;
    }
    *out_depth = depth;
    *out_sil = sil;
  }
}

__global__ void __launch_bounds__(THREADS)
window_loss_bwd_kernel(const __grid_constant__ Geometry geo, Inputs in,
                       const float* __restrict__ saved,
                       const float* __restrict__ g_depth,
                       const float* __restrict__ g_sil,
                       float* __restrict__ partial,
                       unsigned long long* launches) {
  count_launch(launches);
  __shared__ int front[MAX_PEOPLE];
  const int64_t hw = static_cast<int64_t>(geo.H) * geo.W;
  const float eps = geo.eps;
  const int s = blockIdx.x;
  const Body b = body_of(geo, s);
  const Group& g = geo.group[b.gi];
  load_front(geo, in, b.c, b.n, front);
  const int win = g.win;
  const int64_t wpix = static_cast<int64_t>(win) * win;
  const float* zbuf = g.zbuf + b.local * wpix;
  const float* sil = g.sil + b.local * wpix;
  float* d_zbuf = g.d_zbuf + b.local * wpix;
  float* d_sil = g.d_sil + b.local * wpix;
  const int64_t ox = g.origin[2 * b.local], oy = g.origin[2 * b.local + 1];
  const float* depth = in.depths + b.c * hw;
  const float* seg_c = in.seg + static_cast<int64_t>(b.c) * geo.N * hw;
  const float* seg_n = seg_c + b.n * hw;
  const float* ser_n = in.seg_er + (static_cast<int64_t>(b.c) * geo.N + b.n)
                                       * hw;
  const float rmin = 1.0f / in.min_z[b.c], rmax = 1.0f / in.max_z[b.c];
  const float a = rmin - rmax;
  const float dwb = in.dw[b.c * geo.N + b.n];
  // autograd's cotangents of the body's window sums: the square's
  // grad (2 diff), the mean's division, the sub's negation; the sil
  // term's division by n_keep, then its gate
  const float* sv = saved + SAVED * s;
  const float kd = *g_depth * (2.0f * sv[1]);
  const float k_pred = kd / sv[0], k_true = -kd / sv[0];
  const float k_sil = *g_sil / sv[2] * in.sil_gate[b.c * geo.N + b.n];
  float v[2] = {0.0f, 0.0f};   // d_t depth, d_t
  for (int p = threadIdx.x; p < wpix; p += THREADS) {
    const int i = p / win, j = p - i * win;
    const int64_t pix = (oy + i) * geo.W + ox + j;
    const float dep = depth[pix];
    const Pixel px = pixel_at(zbuf[p], ser_n[pix], dwb, dep, a, rmax, eps);
    // log, clamp(min=eps), reciprocal, clamp(min=eps), where(isfinite)
    const float d_disp = px.r >= eps
        ? k_pred * px.dmask / clamp_min(px.r, eps) : 0.0f;
    const float d_x2 = px.x2 >= eps ? -d_disp * (px.r * px.r) : 0.0f;
    d_zbuf[p] = px.valid ? d_x2 : 0.0f;
    // square's grad 2 e, then the keep factor
    const float keep = keep_at(seg_c, hw, geo.N, pix, front);
    const float e = keep * (sil[p] - seg_n[pix]);
    d_sil[p] = k_sil * (2.0f * e) * keep;
    // the target's log and clamp
    const float d_t = px.t >= eps
        ? k_true * px.dmask / clamp_min(px.t, eps) : 0.0f;
    v[0] += d_t * dep;
    v[1] += d_t;
  }
  block_sum(v);
  if (threadIdx.x == 0) {
    partial[2 * s] = v[0];
    partial[2 * s + 1] = v[1];
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
window_loss_bwd_finish(const __grid_constant__ Geometry geo, Inputs in,
                       const float* __restrict__ partial,
                       float* __restrict__ d_min_z,
                       float* __restrict__ d_max_z,
                       unsigned long long* launches) {
  count_launch(launches);
  for (int c = threadIdx.x; c < geo.C; c += FINISH_THREADS) {
    float td = 0.0f, t = 0.0f;   // sums of d_t depth and d_t
    for (int gi = 0; gi < geo.n_groups; ++gi) {
      const Group& g = geo.group[gi];
      for (int k = 0; k < g.ng; ++k) {
        const int s = g.slot0 + c * g.ng + k;
        td += partial[2 * s];
        t += partial[2 * s + 1];
      }
    }
    // target = depths (1 / min_z - 1 / max_z) + 1 / max_z through the
    // reciprocals' grad -g r^2
    const float rmin = 1.0f / in.min_z[c], rmax = 1.0f / in.max_z[c];
    const float rr = rmax * rmax;
    d_min_z[c] = -td * (rmin * rmin);
    d_max_z[c] = td * rr + -t * rr;
  }
}

void pack(Geometry* geo, int n_groups, const int* wins, const int* ngs,
          const int* people, const void* const* zbufs,
          const void* const* sils, const void* const* origins,
          void* const* d_zbufs, void* const* d_sils, int C, int N, int H,
          int W, long long z_sc, long long z_sn, float eps) {
  geo->n_groups = n_groups;
  int slot = 0, first = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    Group& g = geo->group[gi];
    g.zbuf = static_cast<const float*>(zbufs[gi]);
    g.sil = static_cast<const float*>(sils[gi]);
    g.origin = static_cast<const int64_t*>(origins[gi]);
    g.d_zbuf = d_zbufs ? static_cast<float*>(d_zbufs[gi]) : nullptr;
    g.d_sil = d_sils ? static_cast<float*>(d_sils[gi]) : nullptr;
    g.win = wins[gi];
    g.ng = ngs[gi];
    g.slot0 = slot;
    g.first = first;
    for (int k = 0; k < ngs[gi]; ++k) {
      geo->people[first + k] = people[first + k];
    }
    slot += C * ngs[gi];
    first += ngs[gi];
  }
  geo->slots = slot;
  geo->C = C;
  geo->N = N;
  geo->H = H;
  geo->W = W;
  geo->parts = static_cast<int>(
      (static_cast<long long>(H) * W + FRAME_PART - 1) / FRAME_PART);
  geo->z_sc = z_sc;
  geo->z_sn = z_sn;
  geo->eps = eps;
}

}  // namespace mhmocap_window_loss

extern "C" {

// The chunk's loss_depth and loss_sil (0-dim each) and the slots' saved
// rows (slots, 5) from the groups' zbuf and sil (C, ng, win, win) and
// origins (C, ng, 2) int64 and the chunk's inputs; wsum (slots, 5) and
// fcount (C N parts, 2) are scratch. Returns a cudaError_t.
int mhmocap_window_loss_fwd(int n_groups, const int* wins, const int* ngs,
                            const int* people, const void* const* zbufs,
                            const void* const* sils,
                            const void* const* origins, const float* depths,
                            const float* min_z, const float* max_z,
                            const float* seg, const float* seg_er,
                            const float* z, long long z_sc, long long z_sn,
                            const float* dw, const float* sil_gate, int C,
                            int N, int H, int W, float eps, float* wsum,
                            float* fcount, float* saved, float* out_depth,
                            float* out_sil, unsigned long long* launches,
                            cudaStream_t stream) {
  using namespace mhmocap_window_loss;
  Geometry geo;
  pack(&geo, n_groups, wins, ngs, people, zbufs, sils, origins, nullptr,
       nullptr, C, N, H, W, z_sc, z_sn, eps);
  const Inputs in{depths, min_z, max_z, seg, seg_er, z, dw, sil_gate};
  window_loss_fwd_kernel<<<geo.slots + C * N * geo.parts, THREADS, 0,
                           stream>>>(geo, in, wsum, fcount, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_loss_fwd_finish<<<1, FINISH_THREADS, 0, stream>>>(
      geo, in, wsum, fcount, saved, out_depth, out_sil, launches);
  return static_cast<int>(cudaGetLastError());
}

// d_zbuf and d_sil of every group (C, ng, win, win) and d_min_z,
// d_max_z (C) from the scalars' cotangents g_depth, g_sil (device
// scalars) and the forward's saved rows; partial (slots, 2) is scratch.
// Returns a cudaError_t.
int mhmocap_window_loss_bwd(int n_groups, const int* wins, const int* ngs,
                            const int* people, const void* const* zbufs,
                            const void* const* sils,
                            const void* const* origins,
                            void* const* d_zbufs, void* const* d_sils,
                            const float* depths, const float* min_z,
                            const float* max_z, const float* seg,
                            const float* seg_er, const float* z,
                            long long z_sc, long long z_sn, const float* dw,
                            const float* sil_gate, int C, int N, int H, int W,
                            float eps, const float* saved,
                            const float* g_depth, const float* g_sil,
                            float* partial, float* d_min_z, float* d_max_z,
                            unsigned long long* launches,
                            cudaStream_t stream) {
  using namespace mhmocap_window_loss;
  Geometry geo;
  pack(&geo, n_groups, wins, ngs, people, zbufs, sils, origins, d_zbufs,
       d_sils, C, N, H, W, z_sc, z_sn, eps);
  const Inputs in{depths, min_z, max_z, seg, seg_er, z, dw, sil_gate};
  window_loss_bwd_kernel<<<geo.slots, THREADS, 0, stream>>>(
      geo, in, saved, g_depth, g_sil, partial, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_loss_bwd_finish<<<1, FINISH_THREADS, 0, stream>>>(
      geo, in, partial, d_min_z, d_max_z, launches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

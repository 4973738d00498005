// Forward raster kernel: per-pixel z-buffer minimum, winning face id and
// silhouette log-coverage over a batch of bodies.
//
// Replaces mhmocap_tpu/ops/raster_pallas.py:_fwd_kernel (launched by
// _run_forward, pl.pallas_call at :515). Semantics, per window pixel p
// and face f of the folded table (see ops/raster_cuda.py:_fold_pack),
// over the faces of the chunks whose bbox aggregate reaches p's cell:
//   d_i  = edge plane i at p, z = z plane at p, bb = bbox Chebyshev clamp
//   d    = max(d_0, d_1, d_2, bb)
//   zmin = min z over faces with d <= 0 and z > znear (BIG where none)
//   amin = the face giving zmin, lowest id on a tie (-1 where none)
//   logkeep = sum_f log_sigmoid(d |d| inv_blur)
// Invalid and padding faces carry d_0 = +1e9 and z = -1e9, so they are
// never covered and their log_sigmoid is exactly 0: no per-face flags.
//
// What bounds it on the H100: arithmetic on the pairs that add anything.
// At B=29 bodies, window 160 the active (cell, chunk) pairs hold 246 M
// pixel-face pairs, of which 57 M (23%) are live (d|d| inv_blur < 104;
// above it expf underflows, the term is exactly 0 and d > 0 covers
// nothing): ~24 f32 operations each, ~1.4 GFLOP, 0.021 ms at 67 TFLOP/s,
// against 33 MB of tables and images (10 us at 3.35 TB/s). A cell-major
// kernel with a thread per pixel that evaluates every pair of its active
// chunks spends ~77% of its work on dead pairs, and leaves 71% of its
// blocks idle while the busiest cell walks 36 chunks against a mean of 9
// over the active cells. The design answers with:
//   * one block per (body, cell) of up to 8 chunk groups (512 threads at
//     16-px cells), launched bodies fastest and cells from the window's
//     middle out, so the busy cells at the body's centre start first.
//     The cell's active chunks, found from agg alone with
//     the chunk_active test in chunk-id order (no schedule table, no
//     sort before the launch), are dealt to the groups round-robin, so a
//     busy cell's chunks run 8-wide. Each group keeps its own z, id and
//     log-sum; the groups meet in shared memory in group order ((z, id)
//     compared lexicographically, exact in any order; the sums added in
//     group order) and each output is written once with a plain store:
//     no atomics, bit-identical from launch to launch;
//   * in a group, a warp owns 8 columns and all 8 rows of the cell, a
//     thread one column and two rows: a face's x products and the bbox's
//     x part are evaluated once for both rows;
//   * each group stages a chunk's 16 x 128 table with cp.async, face-major
//     and swizzled, so a face is 4 float4 broadcast reads and the 4-byte
//     copies meet few bank conflicts. One buffer a group: a second one,
//     filled while the first is read, bought nothing on the card, and the
//     shared memory it takes costs resident blocks;
//   * an exact cull that keeps the order: per chunk, each warp's lanes
//     test the 128 faces against the warp's 8 x 8 pixel rectangle (bbox
//     distance, a lower bound of d, beyond sqrt(X_CULL / inv_blur), or
//     the invalid mark d_0 = const > that) and ballot the survivors. A
//     culled face adds exactly +0.0f to every pixel of the warp and
//     covers none. The warp walks the survivors in ascending face order,
//     two an iteration so that their transcendental chains interleave,
//     its branches uniform: it skips the terms where all are past
//     -X_ZERO (exactly +0.0f) and takes -expf(-x) where all are past
//     X_TINY (log1pf(e) == e there, checked for every float on the card).
// Exact f32 throughout (no fast math, no FMA contraction): the z-buffer
// winner must not flip on near-degenerate slivers; the planes, the bbox
// clamp and the log-sigmoid keep the plain version's operation order.

#include <cuda_pipeline_primitives.h>

#include "raster_common.cuh"

namespace mhmocap_raster {

constexpr int FWD_MAX_THREADS = 512;
constexpr int FWD_MAX_GROUPS = 8;                          // chunk groups
constexpr int CHUNK_FLOATS = TAB_ROWS * FACE_CHUNK;        // one staged chunk
constexpr int WARP_COLS = 8;                               // a warp's columns
constexpr int ROWS_PER_THREAD = STRIP_H * WARP_COLS / 32;  // 2
constexpr int MERGE_FLOATS = 3 * ROWS_PER_THREAD;          // z, lk, id bits
// x = d|d| inv_blur at or above X_TINY: expf(-x) <= expf(-20) ~ 2.1e-9,
// where log1pf(e) == e (every such float is checked on the card by
// mhmocap_raster_log1p_check), so log_sigmoid(x) = 0 - log1pf(e) = -e.
constexpr float X_TINY = 20.0f;
constexpr float X_TINY_CHECKED = 19.0f;  // the check covers e <= expf(-19)

// Threads of a chunk group: one warp per 8 columns of a cell, a thread
// per column and row pair.
__host__ __device__ inline int fwd_group_threads(int xw) {
  return 32 * ((xw + WARP_COLS - 1) / WARP_COLS);
}

__host__ __device__ inline int fwd_groups(int xw) {
  const int g = FWD_MAX_THREADS / fwd_group_threads(xw);
  return g < 1 ? 1 : (g > FWD_MAX_GROUPS ? FWD_MAX_GROUPS : g);
}

// One staging buffer per group (reused for the groups' merge), then the
// cell's active-chunk list.
inline size_t fwd_shmem_bytes(int groups, int nc) {
  return static_cast<size_t>(groups) * CHUNK_FLOATS * sizeof(float) +
         static_cast<size_t>(nc) * sizeof(int);
}

// float4 slot q (rows 4q .. 4q + 3) of face f in a staged chunk, XOR
// swizzled so that 8 consecutive faces' slots cover all 32 banks.
__device__ __forceinline__ int face_slot(int f, int q) {
  return f * 4 + (q ^ ((f >> 1) & 3));
}

__device__ __forceinline__ void stage_chunk(float* buf, const float* tab_b,
                                            int F_pad, int ch, int t,
                                            int gsz) {
  const float* src = tab_b + ch * FACE_CHUNK;
  for (int i = t; i < CHUNK_FLOATS; i += gsz) {
    const int r = i / FACE_CHUNK, f = i % FACE_CHUNK;
    __pipeline_memcpy_async(buf + face_slot(f, r >> 2) * 4 + (r & 3),
                            src + static_cast<size_t>(r) * F_pad + f,
                            sizeof(float));
  }
  __pipeline_commit();
}

// The k-th of 0 .. n-1 from the middle out: n/2, n/2 - 1, n/2 + 1, ...
__device__ __forceinline__ int middle_out(int k, int n) {
  return (k & 1) ? n / 2 - (k + 1) / 2 : n / 2 + k / 2;
}

// Barrier of one chunk group (named barrier g + 1; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g, int gsz) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(gsz) : "memory");
}

__device__ __forceinline__ float log_sigmoid(float x) {
  // stable form: min(x, 0) - log1p(exp(-|x|))
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(FWD_MAX_THREADS)
    raster_fwd_kernel(const float* __restrict__ tab,
                      const float* __restrict__ agg,
                      float* __restrict__ zmin, float* __restrict__ logkeep,
                      int* __restrict__ amin, int F_pad, int win, int n_xb,
                      float inv_blur, float znear,
                      unsigned long long* launches) {
  count_launch(launches);
  extern __shared__ float4 smem4[];
  __shared__ int warp_count[FWD_MAX_THREADS / 32];
  float* smem = reinterpret_cast<float*>(smem4);
  // Blocks are dispatched about in grid order: bodies fastest, then
  // cells from the window's middle out. Each body is centred in its
  // window, so the cells with the most chunks start first and the light
  // ones fill in behind them.
  const int n_strips = win / STRIP_H;
  const Cell c = make_cell(
      middle_out(blockIdx.y / n_xb, n_strips) * n_xb +
          middle_out(blockIdx.y % n_xb, n_xb),
      win, n_xb);
  const int b = blockIdx.x;
  const int nc = F_pad / FACE_CHUNK;
  const int gsz = fwd_group_threads(c.xw);
  const int n_groups = blockDim.x / gsz;
  int* list = reinterpret_cast<int*>(smem + n_groups * CHUNK_FLOATS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The cell's active chunks in chunk-id order: ballot, then each
  // warp's offset from the counts of the warps before it.
  const float* agg_b = agg + static_cast<size_t>(b) * nc * 4;
  int n_act = 0;
  for (int base = 0; base < nc; base += blockDim.x) {
    const int ch = base + threadIdx.x;
    const bool act = ch < nc && chunk_active(agg_b + ch * 4, c);
    const unsigned m = __ballot_sync(0xffffffffu, act);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      const int k = warp_count[w];
      before += w < warp ? k : 0;
      total += k;
    }
    if (act) list[n_act + before + __popc(m & ((1u << lane) - 1u))] = ch;
    n_act += total;
    __syncthreads();
  }

  // This thread: chunk group g; its warp owns columns 8 w .. 8 w + 7 of
  // the cell, the thread column 8 w + lane % 8 and rows 2 (lane / 8)
  // and 2 (lane / 8) + 1.
  const int g = threadIdx.x / gsz;
  const int t = threadIdx.x % gsz;
  const int col0 = WARP_COLS * (t >> 5);
  const int col = col0 + (lane % WARP_COLS);
  const int row0 = ROWS_PER_THREAD * (lane / WARP_COLS);
  const bool owns = col < c.xw;
  const float px = c.x_lo + static_cast<float>(col) + 0.5f;
  const float py0 = c.y_lo + static_cast<float>(row0) + 0.5f;

  // This warp's pixel-centre rectangle [x_a, x_b] x [y_a, y_b].
  const float x_a = c.x_lo + static_cast<float>(col0) + 0.5f;
  const float x_b =
      c.x_lo + static_cast<float>(min(col0 + WARP_COLS, c.xw) - 1) + 0.5f;
  const float y_a = c.y_lo + 0.5f;
  const float y_b = c.y_lo + static_cast<float>(STRIP_H - 1) + 0.5f;
  const float cull = sqrtf(X_CULL / inv_blur);

  float zb[ROWS_PER_THREAD], lk[ROWS_PER_THREAD];
  int ab[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    zb[r] = BIG;
    lk[r] = 0.0f;
    ab[r] = -1;
  }

  const float* tab_b = tab + static_cast<size_t>(b) * TAB_ROWS * F_pad;
  float* bufs = smem + g * CHUNK_FLOATS;
  const int n_mine = n_act > g ? (n_act - g + n_groups - 1) / n_groups : 0;
  for (int i = 0; i < n_mine; ++i) {
    stage_chunk(bufs, tab_b, F_pad, list[g + i * n_groups], t, gsz);
    __pipeline_wait_prior(0);
    group_sync(g, gsz);  // chunk i's table is visible to the group
    const float4* sh = reinterpret_cast<const float4*>(bufs);
    const int id0 = list[g + i * n_groups] * FACE_CHUNK;

    // the faces that can add to this warp's pixels, as 4 ballot masks
    unsigned keep[FACE_CHUNK / 32];
#pragma unroll
    for (int k = 0; k < FACE_CHUNK / 32; ++k) {
      const int f = k * 32 + lane;
      const float4 e = sh[face_slot(f, 0)];   // a0 b0 c0 a1
      const float4 bx = sh[face_slot(f, 3)];  // lox hix loy hiy
      const float bb_min = fmaxf(fmaxf(bx.x - x_b, x_a - bx.y),
                                 fmaxf(bx.z - y_b, y_a - bx.w));
      const bool dead = bb_min > cull ||
                        (e.x == 0.0f && e.y == 0.0f && e.z > cull);
      keep[k] = __ballot_sync(0xffffffffu, !dead);
    }

    // the survivors in ascending order, two faces an iteration
#pragma unroll
    for (int k = 0; k < FACE_CHUNK / 32; ++k) {
      unsigned m = keep[k];
      while (m != 0u) {
        int fs[2];
        fs[0] = k * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const bool two = m != 0u;
        fs[1] = two ? k * 32 + __ffs(m) - 1 : fs[0];
        if (two) m &= m - 1u;
        float x[2][ROWS_PER_THREAD];
        bool live = false, slow = false;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int f = fs[j];
          const float4 q0 = sh[face_slot(f, 0)];  // a0 b0 c0 a1
          const float4 q1 = sh[face_slot(f, 1)];  // b1 c1 a2 b2
          const float4 q2 = sh[face_slot(f, 2)];  // c2 az bz cz
          const float4 q3 = sh[face_slot(f, 3)];  // lox hix loy hiy
          // the column's share of plane() and bbox_dist(), same rounding
          const float ax0 = q0.x * px, ax1 = q0.w * px, ax2 = q1.z * px;
          const float bbx = fmaxf(q3.x - px, px - q3.y);
#pragma unroll
          for (int r = 0; r < ROWS_PER_THREAD; ++r) {
            const float py = py0 + static_cast<float>(r);  // exact
            const float d0 = ax0 + q0.y * py + q0.z;
            const float d1 = ax1 + q1.x * py + q1.y;
            const float d2 = ax2 + q1.w * py + q2.x;
            const float bb = fmaxf(bbx, fmaxf(q3.z - py, py - q3.w));
            const float d = fmaxf(fmaxf(d0, fmaxf(d1, d2)), bb);
            if (d <= 0.0f && (j == 0 || two)) {
              const float zi = plane(q2.y, q2.z, q2.w, px, py);
              const int id = id0 + f;
              if (zi > znear &&
                  (zi < zb[r] || (zi == zb[r] && id < ab[r]))) {
                zb[r] = zi;
                ab[r] = id;
              }
            }
            x[j][r] = (d * fabsf(d)) * inv_blur;
            live = live || !(x[j][r] >= -X_ZERO);
            slow = slow || !(x[j][r] >= X_TINY);
          }
        }
        // The terms, in face order. Past -X_ZERO a term is exactly +0
        // (lk is never -0, so adding it changes nothing), past X_TINY
        // it is -expf(-x); the branches are uniform across the warp.
        if (!__any_sync(0xffffffffu, live)) continue;
        float l[2][ROWS_PER_THREAD];
        if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < ROWS_PER_THREAD; ++r)
              l[j][r] = log_sigmoid(x[j][r]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < ROWS_PER_THREAD; ++r)
              l[j][r] = -expf(-x[j][r]);
        }
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD; ++r) {
          lk[r] += l[0][r];
          if (two) lk[r] += l[1][r];
        }
      }
    }
    group_sync(g, gsz);  // the buffer is free for the next chunk
  }

  // the groups' results, merged in group order and stored once
  __syncthreads();  // every group is done with its buffers
  if (g > 0) {
    float* o = smem + (static_cast<size_t>(g - 1) * gsz + t) * MERGE_FLOATS;
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      o[r] = zb[r];
      o[ROWS_PER_THREAD + r] = lk[r];
      o[2 * ROWS_PER_THREAD + r] = __int_as_float(ab[r]);
    }
  }
  __syncthreads();
  if (g > 0 || !owns) return;
  for (int h = 1; h < n_groups; ++h) {
    const float* o =
        smem + (static_cast<size_t>(h - 1) * gsz + t) * MERGE_FLOATS;
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const float zh = o[r];
      const int ah = __float_as_int(o[2 * ROWS_PER_THREAD + r]);
      lk[r] += o[ROWS_PER_THREAD + r];
      if (zh < zb[r] || (zh == zb[r] && ah < ab[r])) {
        zb[r] = zh;
        ab[r] = ah;
      }
    }
  }
  const int col_abs = c.xb * c.xw + col;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int row = c.s * STRIP_H + row0 + r;
    const size_t o = static_cast<size_t>(b) * win * win +
                     static_cast<size_t>(row) * win + col_abs;
    zmin[o] = zb[r];
    logkeep[o] = lk[r];
    amin[o] = zb[r] >= BIG ? -1 : ab[r];
  }
}

// Counts the floats e in [0, expf(-X_TINY_CHECKED)] whose log1pf is not
// e itself, bit for bit: the forward's shortcut needs none.
__global__ void log1p_check_kernel(unsigned long long* bad) {
  const unsigned hi = __float_as_uint(expf(-X_TINY_CHECKED));
  unsigned long long n = 0;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u <= hi;
       u += gridDim.x * blockDim.x)
    n += __float_as_uint(log1pf(__uint_as_float(u))) != u;
  if (n) atomicAdd(bad, n);
}

}  // namespace mhmocap_raster

extern "C" int mhmocap_raster_fwd(const float* tab, const float* agg,
                                  float* zmin, float* logkeep, int* amin,
                                  int B, int F_pad, int win, int n_xb,
                                  float inv_blur, float znear,
                                  unsigned long long* launches,
                                  void* stream) {
  using namespace mhmocap_raster;
  const int xw = win / n_xb;
  const int threads = fwd_groups(xw) * fwd_group_threads(xw);
  const size_t smem = fwd_shmem_bytes(fwd_groups(xw), F_pad / FACE_CHUNK);
  cudaError_t err = cudaFuncSetAttribute(
      raster_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, (win / STRIP_H) * n_xb);
  raster_fwd_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, agg, zmin, logkeep, amin, F_pad, win, n_xb, inv_blur, znear,
      launches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mhmocap_raster_log1p_check(unsigned long long* bad,
                                          void* stream) {
  using namespace mhmocap_raster;
  log1p_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      bad);
  return static_cast<int>(cudaGetLastError());
}

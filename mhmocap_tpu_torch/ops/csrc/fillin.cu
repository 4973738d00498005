// Masked window-median fill-in: rounds of a k x k rank filter over the
// masked-out pixels of B frames, in place, that stop on the card once a
// round fills nothing.
//
// Replaces mhmocap_tpu/ops/image.py:fillin_masked (:56), a
// lax.while_loop whose body is one jnp rank-filter round
// (masked_window_median, :36; XLA code, no Pallas kernel). In round r
// every pixel with m < 0.5 whose k x k window (zero padding outside the
// frame) holds a pixel with m > 0.5 takes 0.5 * (lo + hi), where lo and
// hi are elements (n-1)/2 and n/2 of the window's values sorted with the
// invalid slots set to 3.4e38 (n valid slots), and its mask becomes 1.
// Every median of a round reads the state before that round. The sort
// is JAX's: stable, -0.0 equal to 0.0 and every NaN after +inf, each
// element keeping its own bits.
//
// Stopping on the card. The host launches max_iters rounds and reads
// nothing back, so that a CUDA graph can hold the call. state[r] counts
// the pixels round r filled (zeroed by the caller, a memset inside the
// capture); round r returns at once when state[r - 1] is 0. A round that
// fills nothing leaves the state as it was, so every later round would
// fill nothing too: stopping there gives the while_loop's result, whose
// condition (min(m) < 0.5 and it < max_iters) stops at the same round or
// later with the same state. A frame whose mask holds a NaN runs no
// round (min(m) is NaN there, so the loop's condition is false at once):
// state[max_iters + b] flags it.
//
// In place, with no ping-pong buffer: fr[p] is the round that made p a
// valid neighbour (0: m > 0.5 from the start; r + 1: filled in round r;
// HOLE: still to fill; NEVER: m is 0.5 or NaN, neither filled nor used).
// In round r a pixel is a neighbour iff fr <= r. A pixel that round r
// fills changes fr from HOLE to r + 1 while other blocks may read it,
// and both values read as "not a neighbour", so the result does not
// depend on the order of the blocks; x is read only where fr <= r,
// which round r never writes.
//
// What bounds it on the H100: launches and the frontier. The init reads
// m and writes fr (8 bytes a pixel). A live round reads every pixel's fr
// (4 bytes a pixel: 0.26 MB for one 256 x 256 map, 0.08 us at 3.35 TB/s;
// 34 MB for a 128-frame block, 10 us); a block whose tile holds a hole
// also reads the fr of its halo and the x of the valid slots it stages,
// and each pixel the round fills writes x, m and fr (12 bytes). m is
// never read by a round. The rank selection costs about k^4 compares at
// each pixel of the frontier, which is small. The card's floor is then the max_iters launches
// themselves (a few us each), most of which return after one load.
// Design: one thread per pixel in 16 x 16 blocks; a block whose tile
// holds no hole leaves after reading its fr; otherwise it stages the
// tile and a halo of k - 1 (each slot's value, or 3.4e38 where it is
// not a neighbour, with its sort key and validity) in shared memory,
// and each hole thread with a neighbour ranks the valid slots of its
// window against all k^2 slots (the slots before a slot with a key <=
// its own, those after it with a smaller key: its place in the stable
// sort) and takes the two that land on (n-1)/2 and n/2; neither found
// means the invalid slots' 3.4e38. Built with --fmad=false (the raster
// kernels' flags); the median is one add and one multiply, as the plain
// version's.

#include <cuda_runtime.h>

#include <cstdint>

namespace mhmocap_fill {

constexpr int TILE = 16;
constexpr int MAX_K = 15;               // the staged halo's reach
constexpr int MAX_FRAMES = 65535;       // the grid's z limit
constexpr int SPAN = TILE + MAX_K - 1;   // staged rows and columns
constexpr int HOLE = 0x7ffffffe;
constexpr int NEVER = 0x7fffffff;
constexpr float BIG = 3.4e38f;           // the invalid slots' value
// counts[]: calls (init launches), round launches, live rounds
constexpr int COUNT_CALLS = 0, COUNT_ROUNDS = 1, COUNT_LIVE = 2;

// The order of JAX's float sort as an unsigned key: -0.0 == 0.0, every
// NaN equal and after +inf.
__device__ __forceinline__ uint32_t sort_key(float v) {
  uint32_t b = __float_as_uint(v);
  const uint32_t mag = b & 0x7fffffffu;
  if (mag > 0x7f800000u) return 0xffffffffu;
  if (mag == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool first_thread() {
  return (blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x |
          threadIdx.y) == 0;
}

__global__ void fillin_init_kernel(const float* __restrict__ m,
                                   int* __restrict__ fr,
                                   int* __restrict__ nan_frame,
                                   long long hw, long long total,
                                   unsigned long long* counts) {
  if (first_thread()) atomicAdd(counts + COUNT_CALLS, 1ULL);
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const float v = m[i];
  fr[i] = v > 0.5f ? 0 : (v < 0.5f ? HOLE : NEVER);
  if (v != v) atomicOr(nan_frame + i / hw, 1);
}

__global__ void __launch_bounds__(TILE * TILE)
fillin_round_kernel(float* x, float* m, int* fr, int* state, int H, int W,
                    int k, int r, int max_iters,
                    unsigned long long* counts) {
  __shared__ float sval[SPAN * SPAN];
  __shared__ uint32_t skey[SPAN * SPAN];
  __shared__ unsigned char sok[SPAN * SPAN];

  if (first_thread()) atomicAdd(counts + COUNT_ROUNDS, 1ULL);
  if (r > 0 && state[r - 1] == 0) return;   // the loop has ended
  if (first_thread()) atomicAdd(counts + COUNT_LIVE, 1ULL);
  const int b = blockIdx.z;
  if (state[max_iters + b]) return;         // a NaN in this frame's mask

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int px = x0 + tx, py = y0 + ty;
  const size_t frame = static_cast<size_t>(b) * H * W;
  const size_t p = frame + static_cast<size_t>(py) * W + px;
  const bool hole = px < W && py < H && fr[p] == HOLE;
  if (!__syncthreads_or(hole)) return;

  const int pad = k / 2, span = TILE + k - 1;
  for (int s = ty * TILE + tx; s < span * span; s += TILE * TILE) {
    const int gy = y0 - pad + s / span, gx = x0 - pad + s % span;
    bool ok = false;
    float v = BIG;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t q = frame + static_cast<size_t>(gy) * W + gx;
      ok = fr[q] <= r;
      if (ok) v = x[q];
    }
    sval[s] = v;
    skey[s] = sort_key(v);
    sok[s] = ok;
  }
  __syncthreads();

  bool filled = false;
  if (hole) {
    int n = 0;
    for (int i = 0; i < k; ++i)
      for (int j = 0; j < k; ++j) n += sok[(ty + i) * span + tx + j];
    if (n > 0) {
      const int lo_pos = (n - 1) / 2, hi_pos = n / 2;
      float lo = BIG, hi = BIG;
      int slot = 0;
      for (int i = 0; i < k; ++i) {
        for (int j = 0; j < k; ++j, ++slot) {
          const int s = (ty + i) * span + tx + j;
          if (!sok[s]) continue;
          const uint32_t key = skey[s];
          // the slot's place in the stable sort of all k^2 slots
          int rank = 0, other = 0;
          for (int i2 = 0; i2 < k; ++i2) {
            const uint32_t* row = skey + (ty + i2) * span + tx;
            for (int j2 = 0; j2 < k; ++j2, ++other)
              rank += other < slot ? row[j2] <= key : row[j2] < key;
          }
          if (rank == lo_pos) lo = sval[s];
          if (rank == hi_pos) hi = sval[s];
        }
      }
      x[p] = 0.5f * (lo + hi);
      m[p] = 1.0f;
      fr[p] = r + 1;
      filled = true;
    }
  }
  const int count = __syncthreads_count(filled);
  if (tx == 0 && ty == 0 && count) atomicAdd(state + r, count);
}

}  // namespace mhmocap_fill

// The largest filter size and frame count mhmocap_fillin takes.
extern "C" int mhmocap_fillin_max_k() { return mhmocap_fill::MAX_K; }
extern "C" int mhmocap_fillin_max_frames() {
  return mhmocap_fill::MAX_FRAMES;
}

// x, m (B, H, W) f32, filled in place; fr (B, H, W) i32 scratch; state
// (max_iters + B) i32, zero on entry: the pixels each round filled, then
// a flag per frame whose mask holds a NaN; counts: 3 u64 words (calls,
// round launches, live rounds). Launches the init and max_iters rounds
// on `stream` and returns the first launch error (0 when all launched).
extern "C" int mhmocap_fillin(float* x, float* m, int* fr, int* state,
                              int B, int H, int W, int k, int max_iters,
                              unsigned long long* counts, void* stream) {
  using namespace mhmocap_fill;
  if (k < 1 || k > MAX_K || B < 0 || B > MAX_FRAMES || H < 0 || W < 0 ||
      max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = static_cast<long long>(H) * W;
  const long long total = hw * B;
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fillin_init_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       s>>>(m, fr, state + max_iters, hw, total, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  const dim3 block(TILE, TILE);
  for (int r = 0; r < max_iters; ++r) {
    fillin_round_kernel<<<grid, block, 0, s>>>(x, m, fr, state, H, W, k, r,
                                               max_iters, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Phase marks: the device clock at a point of a stage-1 cycle, written
// into a ring of per-cycle rows on the card.
//
// Replaces no TPU kernel. A cycle on the card is one CUDA graph replay,
// so no host code runs while it runs and host ranges cannot split it
// into phases; a mark is a node of the graph itself. One thread reads
// %globaltimer (ns) when the stream reaches the mark, that is once every
// operation before it on the stream has finished, and stores it at
// ring[row * slots + own], where row = *cycle + row_offset is read on
// the card from the fit's cycle counter (a replay needs no host
// argument). Slots [first, own) are the phases that this cycle's
// variant skips: they take the value of slot first - 1, so that each
// skipped phase lasts 0 ns and the row is filled. A row outside
// [0, rows) is left alone. The thread also adds one to *count, the
// library's launch counter (cuda_lib.LaunchCounts), so a launch recorded
// in a CUDA graph counts at each replay.
//
// What bounds it: the launch. It moves 8 bytes a slot and reads one
// int64; a mark costs one node's launch latency in the graph (a few us).

#include <cuda_runtime.h>

#include <cstdint>

namespace mhmocap_phase {

__global__ void phase_mark_kernel(long long* __restrict__ ring,
                                  const long long* __restrict__ cycle,
                                  int row_offset, int rows, int slots,
                                  int first, int own,
                                  unsigned long long* __restrict__ count) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  atomicAdd(count, 1ULL);
  const long long row = *cycle + row_offset;
  if (row < 0 || row >= rows) return;
  long long* r = ring + row * slots;
  if (first < own) {
    const long long prev = r[first - 1];
    for (int s = first; s < own; ++s) r[s] = prev;
  }
  r[own] = static_cast<long long>(now);
}

}  // namespace mhmocap_phase

extern "C" int mhmocap_phase_mark(long long* ring, const long long* cycle,
                                  int row_offset, int rows, int slots,
                                  int first, int own, long long* count,
                                  void* stream) {
  if (first < 0 || own < first || own >= slots || (first == 0 && own > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  mhmocap_phase::phase_mark_kernel<<<1, 1, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      ring, cycle, row_offset, rows, slots, first, own,
      reinterpret_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

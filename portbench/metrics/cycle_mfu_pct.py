"""The whole cycle's share of the card's float32 peak, in %: the
operations an average cycle needs (`work.cycle_flops`, itemised, with
this run's raster counts) over a window cycle's seconds times 67
TFLOP/s."""

from .. import work as W


def read(facts):
    if not facts.raster_calls or not facts.window_cycles:
        return None
    ops = sum(W.cycle_flops(facts.layout, facts.raster_calls,
                            facts.num_vertices).values())
    per_cycle = facts.window_s / facts.window_cycles
    return 100.0 * ops / (per_cycle * W.F32_OPS_PER_S)

"""A raster kernel's share of its roofline in a cycle: the least time
of every call of the cycle (`work.py`, counted by the reference on the
raster inputs of the profiled refresh cycle's state) over the kernel's
device time in that cycle's trace, in %."""

from .. import work as W
from ..trace import kernel_seconds


def roofline(facts, kind: str, kernel: str):
    span = facts.spans.get("refresh")
    if span is None or not facts.raster_calls:
        return None
    n, seconds = kernel_seconds(span, kernel)
    if n == 0 or seconds <= 0:
        return None
    least = sum(W.least_seconds(W.raster_ops(kind, wk),
                                W.raster_bytes(kind, b, facts.num_faces, win))
                for win, b, wk in facts.raster_calls)
    return 100.0 * least / seconds

"""The backward raster kernel (`ops/csrc/raster_bwd.cu`) against its
roofline, in %."""

from ._roofline import roofline


def read(facts):
    return roofline(facts, "bwd", "raster_bwd_kernel")

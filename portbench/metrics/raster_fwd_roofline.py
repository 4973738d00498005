"""The forward raster kernel (`ops/csrc/raster_fwd.cu`) against its
roofline, in %."""

from ._roofline import roofline


def read(facts):
    return roofline(facts, "fwd", "raster_fwd_kernel")

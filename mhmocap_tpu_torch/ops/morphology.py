"""Erosion and dilation with a square structuring element.

Port of `mhmocap_tpu/ops/morphology.py`: min/max pooling with SAME
padding over the last two axes. Dilation pads with -inf, which is
`max_pool2d`'s own padding; erosion pads with +inf, i.e.
`-max_pool2d(-x)`. `erode`/`dilate` are binary: inputs >= 0.5 are
foreground and outputs are {0, 1}. `erode_labels`/`dilate_labels` are
the grey-level 3x3 filters of cv2.erode/cv2.dilate on label maps (the
ingestion's anti-glue pass): pixels outside the image are ignored,
`iterations=k` is k passes. They pool in float32 (max_pool2d has no
uint8 kernel on CUDA), exact for labels below 2**24.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    y = F.max_pool2d(y, kernel_size=k, stride=1, padding=k // 2)
    return y.reshape(lead + y.shape[-2:])


def erode(x: torch.Tensor, kernel_size: int = 5, iterations: int = 1):
    y = (x >= 0.5).to(x.dtype)
    for _ in range(iterations):
        y = -_max_pool(-y, kernel_size)
    return y


def dilate(x: torch.Tensor, kernel_size: int = 5, iterations: int = 1):
    y = (x >= 0.5).to(x.dtype)
    for _ in range(iterations):
        y = _max_pool(y, kernel_size)
    return y


def erode_labels(x: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    y = x.to(torch.float32)
    for _ in range(iterations):
        y = -_max_pool(-y, 3)
    return y.to(x.dtype)


def dilate_labels(x: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    y = x.to(torch.float32)
    for _ in range(iterations):
        y = _max_pool(y, 3)
    return y.to(x.dtype)

"""Binary erosion and dilation with a square structuring element.

Port of `mhmocap_tpu/ops/morphology.py`: min/max pooling with SAME
padding over the last two axes. Dilation pads with -inf, which is
`max_pool2d`'s own padding; erosion pads with +inf, i.e.
`-max_pool2d(-x)`. Inputs >= 0.5 are foreground; outputs are {0, 1}.
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

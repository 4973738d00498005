"""The masked window-median fill-in kernel, hand-written in CUDA.

Counterpart of the JAX package's `fillin_masked`
(`mhmocap_tpu/ops/image.py`), a `lax.while_loop` of rank-filter rounds.
The kernel lives in `csrc/fillin.cu` (its header says what it computes,
how it stops on the card and what bounds it). This module builds it
(`cuda_lib.build_library`: nvcc for sm_90a into build/ at first use, a
library of its own), binds it with ctypes, checks a call against the
limits the library reports and launches it on the current stream, so that a CUDA graph capture records the call: the
zeroed round counts, the init and `max_iters` round launches. The host
reads nothing back on the path. `launches` counts, on the card, the
calls, the round launches and the rounds that ran past the stop test.

`ops.image.fillin_masked` is the wrapper: CUDA tensors come here, CPU
tensors run its plain version (`ops.image.fillin_plain`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from .cuda_lib import LaunchCounts, build_library, load_library, stream_ptr

_SOURCES = ("fillin.cu",)

# calls (one a fillin_masked), launches of the round kernel (max_iters a
# call) and live rounds (those past the stop test)
launches = LaunchCounts(("calls", "rounds", "live"))


def build_kernels() -> Tuple[Path, str]:
    """Compile csrc/fillin.cu into build/ unless it is built. Returns
    (path, nvcc's output); raises with the compiler's output if it
    fails."""
    return build_library("fillin", _SOURCES)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("fillin", _SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mhmocap_fillin.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
    lib.mhmocap_fillin.restype = i
    for limit in (lib.mhmocap_fillin_max_k, lib.mhmocap_fillin_max_frames):
        limit.argtypes, limit.restype = [], i
    return lib


def fillin_cuda(x, mask, filter_size: int, max_iters: int = 64):
    """Launch the fill-in on CUDA tensors x, mask (..., H, W) of one
    shape -> (x, m, filled): x and m float32 of that shape, and filled
    (max_iters,) int32, the pixels each round filled (0 from the round
    the loop stopped at on). Nothing is read back to the host."""
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"fillin_cuda needs CUDA tensors on one device, "
                         f"got {x.device} and {mask.device}")
    if x.shape != mask.shape or x.ndim < 2:
        raise ValueError(f"fillin_cuda: x {tuple(x.shape)} and mask "
                         f"{tuple(mask.shape)} must be one (..., H, W) shape")
    lib = _library()
    max_k = lib.mhmocap_fillin_max_k()
    if not 1 <= filter_size <= max_k:
        raise ValueError(f"fillin_cuda: filter size {filter_size} is not "
                         f"in [1, {max_k}]")
    if max_iters < 0:
        raise ValueError(f"fillin_cuda: max_iters {max_iters} < 0")
    H, W = x.shape[-2:]
    B = x.numel() // max(H * W, 1)
    if B > lib.mhmocap_fillin_max_frames():
        raise ValueError(f"fillin_cuda: {B} frames exceed "
                         f"{lib.mhmocap_fillin_max_frames()}")
    dev = x.device
    xv = x.detach().to(torch.float32, memory_format=torch.contiguous_format,
                       copy=True)
    m = mask.detach().to(torch.float32, memory_format=torch.contiguous_format,
                         copy=True)
    fr = torch.empty(x.shape, dtype=torch.int32, device=dev)
    state = torch.zeros(max_iters + B, dtype=torch.int32, device=dev)
    err = lib.mhmocap_fillin(
        xv.data_ptr(), m.data_ptr(), fr.data_ptr(), state.data_ptr(), B, H,
        W, filter_size, max_iters, launches.pointer("calls", dev),
        stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"fill-in kernel launch failed: CUDA error {err}")
    return xv, m, state[:max_iters]

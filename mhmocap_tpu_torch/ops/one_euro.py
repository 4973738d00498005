"""One-Euro low-pass filter on torch tensors.

Port of `mhmocap_tpu/ops/one_euro.py`: the step API used by the
chunked filtered-target refresh, and the (T, ...) filter with the
'ramp' (t_e = i / rate) or 'uniform' (t_e = 1 / rate) time base and an
optional hold mask, and the forward + backward average used to smooth
the 2D poses at ingestion. The time loop is a Python loop over frames.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _alpha(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


def one_euro_init(x0: torch.Tensor):
    """Initial filter state (x_prev, dx_prev)."""
    return (x0, torch.zeros_like(x0))


def one_euro_step(state, x, t_e, min_cutoff, beta, d_cutoff=1.0):
    """One unmasked update; returns (new_state, x_hat)."""
    x_prev, dx_prev = state
    a_d = _alpha(t_e, d_cutoff)
    dx = (x - x_prev) / t_e
    dx_hat = a_d * dx + (1 - a_d) * dx_prev
    cutoff = min_cutoff + beta * torch.abs(dx_hat)
    a = _alpha(t_e, cutoff)
    x_hat = a * x + (1 - a) * x_prev
    return (x_hat, dx_hat), x_hat


def one_euro_filter(x: torch.Tensor, min_cutoff: float = 0.004,
                    beta: float = 0.7, d_cutoff: float = 1.0,
                    dt: Optional[torch.Tensor] = None,
                    frame_rate: float = 25.0,
                    mask: Optional[torch.Tensor] = None,
                    dt_mode: str = "ramp") -> torch.Tensor:
    """Filter a (T, ...) signal along axis 0. Masked-out elements hold
    their filter state and pass the raw input through."""
    T = x.shape[0]
    if dt is None:
        i = torch.arange(1, T, dtype=x.dtype, device=x.device)
        if dt_mode == "ramp":
            dt = i / frame_rate
        elif dt_mode == "uniform":
            dt = torch.full((T - 1,), 1.0 / frame_rate, dtype=x.dtype,
                            device=x.device)
        else:
            raise ValueError(f"unknown dt_mode {dt_mode!r}")
    else:
        dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
        if dt.shape[0] == T:
            dt = dt[1:]
    if mask is None:
        mask_seq = torch.ones_like(x[1:])
    else:
        mask_seq = mask.expand(x.shape)[1:].to(x.dtype)

    x_prev, dx_prev, te_prev = x[0], torch.zeros_like(x[0]), \
        torch.zeros_like(x[0])
    ys = [x[0]]
    for k in range(T - 1):
        xi, mi, te = x[k + 1], mask_seq[k], dt[k]
        t_e = te + te_prev
        a_d = _alpha(t_e, d_cutoff)
        dx = (xi - x_prev) / t_e
        dx_hat = a_d * dx + (1 - a_d) * dx_prev
        cutoff = min_cutoff + beta * torch.abs(dx_hat)
        a = _alpha(t_e, cutoff)
        x_hat = a * xi + (1 - a) * x_prev
        x_prev = (1 - mi) * x_prev + mi * x_hat
        dx_prev = (1 - mi) * dx_prev + mi * dx_hat
        te_prev = (1 - mi) * t_e
        ys.append((1 - mi) * xi + mi * x_hat)
    return torch.stack(ys, dim=0)


def one_euro_bidirectional(x: torch.Tensor, valid: Optional[torch.Tensor],
                           min_cutoff: float, beta: float,
                           frame_rate: float = 25.0) -> torch.Tensor:
    """Mean of a forward and a time-reversed 'ramp' pass over the
    (T, ...) signal, with the update mask `valid` (or None)."""
    fwd = one_euro_filter(x, min_cutoff=min_cutoff, beta=beta,
                          frame_rate=frame_rate, mask=valid,
                          dt_mode="ramp")
    rmask = None if valid is None else torch.flip(valid, dims=(0,))
    bwd = one_euro_filter(torch.flip(x, dims=(0,)), min_cutoff=min_cutoff,
                          beta=beta, frame_rate=frame_rate, mask=rmask,
                          dt_mode="ramp")
    return 0.5 * (fwd + torch.flip(bwd, dims=(0,)))

"""Loss terms for the space-time SMPL optimization.

Port of `mhmocap_tpu/engine/losses.py` (the reference `mhmocap/losses.py`:
eigen-style log-depth loss, per-instance average log-disparity loss,
masked MSE, multiscale gradient loss; losses.py:6-103). Plain functions
on tensors, sum-reduced with the reference's normalizations. The L1
terms use the optimizer's `_abs`, whose derivative at 0 is +1 as
jnp.abs's is (torch.abs has 0 there).
"""

from __future__ import annotations

import torch

from .optimizer import _abs


def _log_clip(x, eps):
    return torch.log(torch.clamp(x, min=eps))


def eigen_log_depth_loss(y_pred, y_true, mask, eps: float = 1e-3):
    """Masked mean of squared log-depth differences, normalized by
    (sum(mask) + 1)."""
    d = mask * (_log_clip(y_pred, eps) - _log_clip(y_true, eps))
    return torch.sum(torch.square(d)) / (torch.sum(mask) + 1.0)


def avg_log_depth_loss(y_pred, y_true, mask, eps: float = 1e-3):
    """Per-instance average log-disparity alignment loss: (..., H, W)
    maps; the masked mean log per leading index (normalized by
    sum(mask) + 1), then the summed squared differences of those
    means."""
    lp = mask * _log_clip(y_pred, eps)
    lt = mask * _log_clip(y_true, eps)
    n = torch.sum(mask, dim=(-2, -1)) + 1.0
    mp = torch.sum(lp, dim=(-2, -1)) / n
    mt = torch.sum(lt, dim=(-2, -1)) / n
    return torch.sum(torch.square(mp - mt))


def masked_mse_loss(y1, y2, mask):
    """sum((mask * (y1 - y2))^2) / (sum(mask) + 1)."""
    return torch.sum(torch.square(mask * (y1 - y2))) / (torch.sum(mask) + 1.0)


def sum_sq(x):
    """Sum-reduced squared error (MSELoss(reduction='sum'))."""
    return torch.sum(torch.square(x))


def sum_abs(x):
    """Sum-reduced absolute error (L1Loss(reduction='sum'))."""
    return torch.sum(_abs(x))


def inv_depth_loss(diff_z):
    """softplus(dz)^2."""
    return torch.square(torch.logaddexp(diff_z, torch.zeros_like(diff_z)))


def multiscale_gradient_loss(y_true, y_pred, mask, num_levels: int = 4,
                             alpha: float = 0.5, eps: float = 1e-3):
    """L1-of-log-gradients pyramid plus the eigen log-depth base loss.
    Inputs are (H, W) or (H, W, C)."""
    loss = eigen_log_depth_loss(y_pred, y_true, mask, eps)
    if num_levels <= 0:
        return loss

    diff = _log_clip(y_true, eps) - _log_clip(y_pred, eps)
    if diff.ndim < 3:
        diff = diff[..., None]
        mask = mask[..., None]

    def level_term(d, m):
        vg = _abs(d[:-1] - d[1:])
        vm = m[:-1] * m[1:]
        vn = torch.clamp(torch.sum(vm, dim=(0, 1)), min=1)
        v = torch.sum(vm * vg, dim=(0, 1)) / vn
        hg = _abs(d[:, :-1] - d[:, 1:])
        hm = m[:, :-1] * m[:, 1:]
        hn = torch.clamp(torch.sum(hm, dim=(0, 1)), min=1)
        h = torch.sum(hm * hg, dim=(0, 1)) / hn
        return torch.mean(v + h)

    grad_loss = 0.0
    d, m = diff, mask
    for level in range(num_levels - 1):
        grad_loss = grad_loss + level_term(d, m)
        if level == num_levels - 2 or min(d.shape[:2]) < 8:
            break
        # 2x decimation into 4 phase-shifted stacks
        d = torch.cat([d[0::2, 0::2], d[0::2, 1::2], d[1::2, 0::2],
                       d[1::2, 1::2]], dim=0)
        m = torch.cat([m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2],
                       m[1::2, 1::2]], dim=0)

    return loss + alpha * grad_loss

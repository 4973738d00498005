"""Image primitives for the depth/scene postprocess, on torch tensors.

Port of `mhmocap_tpu/ops/image.py`: masked window and temporal medians
(the mean of elements (n-1)//2 and n//2 of the sorted valid values, not
`torch.median`'s lower element), iterative masked fill-in, Sobel
magnitude with reflect padding, the bilateral filter, the Sobel
outlier mask and `postprocess_depthmap`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .morphology import erode

_BIG = 3.4e38


def _unfold(x: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """k*k neighbourhoods: (H, W) -> (H, W, k*k), padded with `fill`."""
    pad = k // 2
    xp = F.pad(x, (pad, pad, pad, pad), value=fill)
    H, W = x.shape
    return torch.stack([xp[i:i + H, j:j + W]
                        for i in range(k) for j in range(k)], dim=-1)


def _median_of_sorted(sorted_vals, n, dim):
    lo_idx = torch.clamp((n - 1) // 2, min=0).unsqueeze(dim)
    hi_idx = (n // 2).unsqueeze(dim)
    lo = torch.gather(sorted_vals, dim, lo_idx).squeeze(dim)
    hi = torch.gather(sorted_vals, dim, hi_idx).squeeze(dim)
    return 0.5 * (lo + hi)


def masked_window_median(x, mask, k: int):
    """Median over the valid pixels of each k*k window -> (median (H, W),
    any_valid (H, W)); windows without a valid pixel give 0."""
    vals = _unfold(x, k, 0.0)
    ok = _unfold(mask.to(x.dtype), k, 0.0) > 0.5
    n = torch.sum(ok, dim=-1)
    sorted_vals = torch.sort(
        torch.where(ok, vals, torch.full_like(vals, _BIG)), dim=-1).values
    med = _median_of_sorted(sorted_vals, n, -1)
    any_valid = n > 0
    return torch.where(any_valid, med, torch.zeros_like(med)), any_valid


def fillin_masked(x, mask, filter_size: int, max_iters: int = 64):
    """Fill masked-out pixels with the window median of valid
    neighbours, `max_iters` rounds. A round changes nothing once the
    mask is full (or no window holds a valid pixel), so the fixed count
    gives the JAX while-loop's result without reading the mask back to
    the host."""
    xv = x.to(torch.float32)
    m = mask.to(torch.float32)
    for _ in range(max_iters):
        med, ok = masked_window_median(xv, m, filter_size)
        newly = (m < 0.5) & ok
        xv = torch.where(newly, med, xv)
        m = torch.where(newly, torch.ones_like(m), m)
    return xv, m


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """|Sobel_x| + |Sobel_y| with 3x3 kernels and reflect padding."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=x.dtype, device=x.device)
    w = torch.stack([kx, kx.T])[:, None]                  # (2, 1, 3, 3)
    xp = F.pad(x[None, None], (1, 1, 1, 1), mode="reflect")
    g = F.conv2d(xp, w)[0]
    return torch.abs(g[0]) + torch.abs(g[1])


def bilateral_filter(x: torch.Tensor, d: int = 9, sigma_color: float = 0.05,
                     sigma_space: float = 25.0) -> torch.Tensor:
    """Bilateral filter over (H, W) with a d*d window, parameterized like
    cv2.bilateralFilter."""
    k = d if d % 2 == 1 else d + 1
    r = k // 2
    offs = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)
    sw = torch.exp(-(offs[:, None] ** 2 + offs[None, :] ** 2)
                   / (2.0 * sigma_space ** 2)).reshape(-1)
    vals = _unfold(x, k, float("nan"))
    ok = ~torch.isnan(vals)
    vals = torch.nan_to_num(vals)
    rw = torch.exp(-torch.square(vals - x[..., None])
                   / (2.0 * sigma_color ** 2))
    w = sw * rw * ok
    return torch.sum(w * vals, dim=-1) / torch.clamp(
        torch.sum(w, dim=-1), min=1e-8)


def _edge_outlier_mask(disp, depth):
    """Pixels whose combined normalized Sobel gradient exceeds 3x its
    mean are outliers; the clean mask is eroded twice with a 3x3
    kernel. std is the population std (correction=0), as jnp.std."""
    g_disp = sobel_magnitude(disp)
    g_depth = sobel_magnitude(depth)
    g = (g_disp / torch.clamp(torch.std(g_disp, correction=0), min=1e-8)
         + g_depth / torch.clamp(torch.std(g_depth, correction=0),
                                 min=1e-8))
    edges = (g > 3.0 * torch.mean(g)).to(disp.dtype)
    return erode(1.0 - edges, kernel_size=3, iterations=2)


def postprocess_depthmap(depth, mask=None, fillin_ksize: int = 7,
                         use_bilateral_filter: bool = False):
    """Outlier removal + fill-in for a metric depth map."""
    if use_bilateral_filter:
        disp_f = bilateral_filter(1.0 / torch.clamp(depth, 0.01, 100.0),
                                  d=9, sigma_color=0.05, sigma_space=25.0)
        depth = 1.0 / torch.clamp(disp_f, 0.01, 100.0)
    disp = 1.0 / torch.clamp(depth, 0.1, 100.0)
    dmask = _edge_outlier_mask(disp, depth)
    if mask is not None:
        dmask = dmask * mask
    filled, _ = fillin_masked(depth, dmask, fillin_ksize)
    return filled


def masked_temporal_median(values, valid):
    """Per-pixel median over time of masked values.

    values: (T, H, W) or (T, H, W, C); valid: (T, H, W). Returns
    (median, any_valid)."""
    v = values.to(torch.float32)
    ok = valid.to(torch.bool)
    if v.ndim == 4:
        ok = ok[..., None]
    ok = ok.expand(v.shape)
    sv = torch.sort(torch.where(ok, v, torch.full_like(v, _BIG)),
                    dim=0).values
    n = torch.sum(ok, dim=0)
    med = _median_of_sorted(sv, n, 0)
    any_valid = n > 0
    med = torch.where(any_valid, med, torch.zeros_like(med))
    if values.ndim == 4:
        return med, torch.all(any_valid, dim=-1)
    return med, any_valid

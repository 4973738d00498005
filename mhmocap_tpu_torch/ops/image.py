"""Image primitives for the depth/scene postprocess, on torch tensors.

Port of `mhmocap_tpu/ops/image.py`: masked window and temporal medians
(the mean of elements (n-1)//2 and n//2 of the sorted valid values, not
`torch.median`'s lower element), iterative masked fill-in (a CUDA
kernel on the card, `fillin_cuda.py`, beside its plain version), Sobel
magnitude with reflect padding, the bilateral filter, the Sobel
outlier mask, `postprocess_dispmap` and `postprocess_depthmap`, and the
two resizes of the ingestion in PIL's semantics. The window ops work on
(H, W) or batched (..., H, W) frames, each frame on its own (the JAX
package vmaps them).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .fillin_cuda import fillin_cuda
from .morphology import erode

_BIG = 3.4e38


def _unfold(x: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """k*k neighbourhoods: (..., H, W) -> (..., H, W, k*k), padded with
    `fill`."""
    pad = k // 2
    xp = F.pad(x, (pad, pad, pad, pad), value=fill)
    H, W = x.shape[-2:]
    return torch.stack([xp[..., i:i + H, j:j + W]
                        for i in range(k) for j in range(k)], dim=-1)


def _median_of_sorted(sorted_vals, n, dim):
    lo_idx = torch.clamp((n - 1) // 2, min=0).unsqueeze(dim)
    hi_idx = (n // 2).unsqueeze(dim)
    lo = torch.gather(sorted_vals, dim, lo_idx).squeeze(dim)
    hi = torch.gather(sorted_vals, dim, hi_idx).squeeze(dim)
    return 0.5 * (lo + hi)


def masked_window_median(x, mask, k: int):
    """Median over the valid pixels of each k*k window -> (median (H, W),
    any_valid (H, W)); windows without a valid pixel give 0. The values
    are ordered as JAX's sort orders them: a stable sort in which -0.0
    equals 0.0 and every NaN comes after +inf, each value keeping its
    bits. The sort runs on a key whose zeros are +0.0 and whose NaNs are
    one NaN, so that a sort that orders by bits (the card's radix sort)
    gives that order too."""
    vals = _unfold(x, k, 0.0)
    ok = _unfold(mask.to(x.dtype), k, 0.0) > 0.5
    n = torch.sum(ok, dim=-1)
    vals = torch.where(ok, vals, torch.full_like(vals, _BIG))
    key = torch.where(vals == 0, torch.zeros_like(vals), vals)
    key = torch.where(torch.isnan(key), torch.full_like(key, float("nan")),
                      key)
    order = torch.sort(key, dim=-1, stable=True).indices
    med = _median_of_sorted(torch.gather(vals, -1, order), n, -1)
    any_valid = n > 0
    return torch.where(any_valid, med, torch.zeros_like(med)), any_valid


def fillin_plain(x, mask, filter_size: int, max_iters: int = 64):
    """The plain version of the fill-in kernel -> (x, m, filled): rounds
    of `masked_window_median` until a round fills no pixel or
    `max_iters` rounds ran; filled lists the pixels each round filled.
    The stop reads each round's count on the host. It gives the JAX
    while-loop's result: a round that fills nothing leaves the state as
    it was, and the loop's condition (mask not full, below max_iters)
    stops there or later. A frame whose mask holds a NaN runs no round,
    as in JAX (min(m) is NaN there)."""
    xv = x.to(torch.float32, copy=True)
    m = mask.to(torch.float32, copy=True)
    live = ~torch.isnan(m).flatten(-2).any(-1)[..., None, None]
    filled = []
    for _ in range(max_iters):
        med, ok = masked_window_median(xv, m, filter_size)
        newly = (m < 0.5) & ok & live
        filled.append(int(newly.sum()))
        if not filled[-1]:
            break
        xv = torch.where(newly, med, xv)
        m = torch.where(newly, torch.ones_like(m), m)
    return xv, m, filled


def fillin_masked(x, mask, filter_size: int, max_iters: int = 64):
    """Fill masked-out pixels with the window median of valid
    neighbours until a round fills nothing or after `max_iters` rounds
    -> (x, m) float32. CUDA tensors launch the kernel
    (`fillin_cuda.fillin_cuda`, which stops on the card and reads
    nothing back), CPU tensors run the plain version (`fillin_plain`)."""
    x, mask = torch.broadcast_tensors(x, mask)
    if x.is_cuda:
        xv, m, _ = fillin_cuda(x, mask, filter_size, max_iters)
    else:
        xv, m, _ = fillin_plain(x, mask, filter_size, max_iters)
    return xv, m


# never evicted: a captured CUDA graph reads it at its address
@functools.cache
def _sobel_weight(dtype, device) -> torch.Tensor:
    """The (2, 1, 3, 3) Sobel x and y kernels, built once per (dtype,
    device) so that a call copies nothing from the host (and can be
    captured in a CUDA graph)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=dtype,
                      device=device)
    return torch.stack([kx, kx.T])[:, None]


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """|Sobel_x| + |Sobel_y| with 3x3 kernels and reflect padding."""
    w = _sobel_weight(x.dtype, x.device)
    xp = F.pad(x.reshape((-1, 1) + x.shape[-2:]), (1, 1, 1, 1),
               mode="reflect")
    g = F.conv2d(xp, w)
    return (torch.abs(g[:, 0]) + torch.abs(g[:, 1])).reshape(x.shape)


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
    kernel. Statistics are per frame; std is the population std
    (correction=0), as jnp.std."""
    def std(t):
        return torch.clamp(torch.std(t, dim=(-2, -1), correction=0,
                                     keepdim=True), min=1e-8)

    g_disp = sobel_magnitude(disp)
    g_depth = sobel_magnitude(depth)
    g = g_disp / std(g_disp) + g_depth / std(g_depth)
    edges = (g > 3.0 * torch.mean(g, dim=(-2, -1), keepdim=True)).to(
        disp.dtype)
    return erode(1.0 - edges, kernel_size=3, iterations=2)


def postprocess_dispmap(dispmap, minz: float = 1.0, maxz: float = 20.0,
                        fillin_ksize: int = 7):
    """Outlier removal + fill-in for normalized disparity maps
    (..., H, W): clip, Sobel outliers on the disparity and the depth it
    induces, erode the valid mask, median-fill the holes."""
    disp = torch.clamp(dispmap, 1.0 / maxz, 1.0)
    depth = 1.0 / (disp * (1.0 / minz - 1.0 / maxz) + 1.0 / maxz)
    dmask = _edge_outlier_mask(disp, depth)
    filled, _ = fillin_masked(disp, dmask, fillin_ksize)
    return filled


def _resize(x: torch.Tensor, size_wh, mode: str, **kw) -> torch.Tensor:
    """(B, H, W[, C]) -> (B, h, w[, C]) in float32."""
    chan = x.ndim == 4
    y = x.to(torch.float32)
    y = y.permute(0, 3, 1, 2) if chan else y[:, None]
    y = F.interpolate(y, size=(size_wh[1], size_wh[0]), mode=mode, **kw)
    return y.permute(0, 2, 3, 1) if chan else y[:, 0]


def resize_bicubic(x: torch.Tensor, size_wh) -> torch.Tensor:
    """PIL's `resize(size_wh, BICUBIC)` of a batch of frames: the
    antialiased a = -0.5 cubic; uint8 frames are rounded and clamped as
    PIL does, other dtypes come back as float32."""
    y = _resize(x, size_wh, "bicubic", antialias=True, align_corners=False)
    if x.dtype == torch.uint8:
        return torch.round(y).clamp(0, 255).to(torch.uint8)
    return y


def resize_nearest(x: torch.Tensor, size_wh) -> torch.Tensor:
    """PIL's `resize(size_wh, NEAREST)` of a batch of label frames when
    downscaling ("nearest-exact" samples the pixel centres as PIL does;
    computed in float32, exact for labels below 2**24)."""
    return _resize(x, size_wh, "nearest-exact").to(x.dtype)


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

"""The depth + silhouette raster kernel pair, hand-written in CUDA.

Counterpart of `mhmocap_tpu/ops/raster_pallas.py`. The kernels live in
`csrc/raster_fwd.cu` and `csrc/raster_bwd.cu` (their headers say which
Pallas kernel each replaces, what bounds it on an H100 and how the
design answers). This module holds what surrounds them:

  * `_fold_pack`: fold face validity into the plane coefficients
    (invalid and padding faces get d_0 = +D_INVALID and z = -D_INVALID,
    so their soft coverage is exactly 0 and they are never covered),
    pad to a FACE_CHUNK multiple and build the per-chunk
    reach-expanded bbox aggregates;
  * the schedule, which both kernels derive from the aggregates alone
    (no table, no sort before a launch): the forward tests each chunk
    against its cell with `chunk_active`, in chunk-id order; the
    backward takes the rectangle of cells each chunk reaches
    (`_chunk_cells` is its arithmetic in torch). The two are the same
    (cell, chunk) set. `_strip_chunk_lists` is the counterpart of the
    JAX package's schedule (x-sorted per-strip lists and per-cell
    slices), held equal to it by the tests; `_active_pairs` reads the
    visited set from it, and `_pair_work` counts the pixel-face pairs
    in it whose coverage term is not exactly 0 (what a kernel's bound
    is computed from);
  * `_fwd_cull`: the forward kernel's exact cull in torch. Per chunk,
    each warp drops the faces whose bbox distance to the warp's pixel
    rectangle, or whose invalid mark, puts every pixel of it where the
    term is exactly 0 and nothing is covered; `_fwd_work` counts the
    pixel-face pairs the kernel still evaluates;
  * the plain torch version of both kernels, over all faces in face
    chunks (the CPU path's raster stages, and the reference the card is
    held to);
  * `_tables`, `_window_outputs` and `_cotangents`: the fold of
    `face_setup.face_extents`' planes into the tables, and the per-pixel
    glue between the kernels and `rasterizer.RasterFaces`, the one
    autograd.Function that runs them (its docstring names the four
    kernel / plain pairs);
  * `launches` (`cuda_lib.LaunchCounts`): each kernel counts its own
    launches on the device (raster_common.cuh count_launch), so a
    launch recorded in a CUDA graph counts at every replay;
  * the load of the library (`cuda_lib.build_library`: nvcc for sm_90a
    into build/ at first use), bound with ctypes.

Table layout (shared with csrc/raster_common.cuh): tab (B, 16, F_pad)
f32, rows 3*b + r = coefficient r (x, y, const) of plane b (edges 0-2,
then z), rows 12-15 = bbox (lox, hix, loy, hiy); agg (B, nc, 4).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_lib import LaunchCounts, build_library, load_library, stream_ptr

STRIP_H = 8
FACE_CHUNK = 128
TAB_ROWS = 16
AGG_XLO, AGG_XHI, AGG_YLO, AGG_YHI = 0, 1, 2, 3
BIG = 3.0e38
D_INVALID = 1.0e9
X_CELL_MIN = 16
# expf(-x) underflows to 0 in f32 from x ~ 103.97 on, and with it a
# pair's log-sigmoid (forward) and sigmoid (backward) coverage term
X_LIVE = 104.0
# the kernels' cull line (raster_common.cuh X_CULL): a pair whose bbox
# distance exceeds sqrt(X_CULL / inv_blur) has x past 110
X_CULL = 111.0
# the forward kernel: a warp owns 8 columns of a cell, all its rows
FWD_WARP_COLS = 8

_SOURCES = ("raster_fwd.cu", "raster_bwd.cu")
_HEADERS = ("raster_common.cuh",)

launches = LaunchCounts(("fwd", "bwd"))


def _n_xb(win: int) -> int:
    """x-blocks per strip: the narrowest cell width >= 16 px that
    divides the window."""
    for w in range(X_CELL_MIN, win + 1):
        if win % w == 0:
            return win // w
    return 1


# ---------------------------------------------------------------------------
# Table pack and schedule (plain torch, run on the tables' device)
# ---------------------------------------------------------------------------

def _fold_pack(planes, bbox, oks, okd, ymin, ymax, reach: float):
    """Fold validity into the coefficients and pad to FACE_CHUNK.

    planes (B, F, 12), bbox (B, F, 4), oks/okd (B, F) bool, ymin/ymax
    (B, F) reach-expanded y extents. Returns (tab (B, 16, F_pad),
    agg (B, nc, 4)), both float32 and contiguous.
    """
    B, Fn = planes.shape[:2]
    F_pad = -(-Fn // FACE_CHUNK) * FACE_CHUNK
    nc = F_pad // FACE_CHUNK
    dev, f32 = planes.device, torch.float32

    z_invalid, bbox_invalid = _pack_fills(dev)
    edge = torch.where(oks[..., None], planes[..., :9],
                       torch.zeros((), dtype=f32, device=dev))
    edge = edge.reshape(B, Fn, 3, 3).clone()
    edge[..., 0, 2] = torch.where(oks, edge[..., 0, 2],
                                  torch.full_like(edge[..., 0, 2],
                                                  D_INVALID))
    zpl = torch.where(okd[..., None], planes[..., 9:12], z_invalid)
    blocks = torch.cat([edge.reshape(B, Fn, 9), zpl], dim=-1)
    bbox_k = torch.where(oks[..., None], bbox, bbox_invalid)
    bbox_s = bbox
    if F_pad > Fn:
        npad = F_pad - Fn
        pad = torch.zeros((B, npad, 12), dtype=f32, device=dev)
        pad[..., 2] = D_INVALID
        pad[..., 11] = -D_INVALID
        blocks = torch.cat([blocks, pad], dim=1)
        fpad = torch.full((B, npad), BIG, dtype=f32, device=dev)
        ymin = torch.cat([ymin, fpad], dim=1)
        ymax = torch.cat([ymax, -fpad], dim=1)
        oks = torch.cat([oks, torch.zeros((B, npad), dtype=torch.bool,
                                          device=dev)], dim=1)
        bbox_s = torch.cat(
            [bbox, torch.stack([fpad, -fpad, fpad, -fpad], -1)], dim=1)
        bbox_k = torch.cat(
            [bbox_k, torch.stack([-fpad, fpad, -fpad, fpad], -1)], dim=1)
    tab = torch.cat([blocks, bbox_k], dim=-1).transpose(1, 2).contiguous()

    okc = oks.reshape(B, nc, FACE_CHUNK)

    def cm(v, init, red):
        return red(torch.where(okc, v.reshape(B, nc, FACE_CHUNK),
                               torch.full((), init, dtype=f32, device=dev)),
                   dim=-1)

    agg = torch.stack([
        cm(bbox_s[..., 0], BIG, torch.amin) - reach,
        cm(bbox_s[..., 1], -BIG, torch.amax) + reach,
        cm(ymin, BIG, torch.amin),
        cm(ymax, -BIG, torch.amax),
    ], dim=-1).contiguous()
    return tab, agg


# never evicted: a captured CUDA graph reads it at its address
@functools.cache
def _pack_fills(device):
    """`_fold_pack`'s z plane and bbox of an invalid face, built once per
    device so that a pack copies nothing from the host (and can be
    captured in a CUDA graph)."""
    f32 = torch.float32
    return (torch.tensor([0.0, 0.0, -D_INVALID], dtype=f32, device=device),
            torch.tensor([-BIG, BIG, -BIG, BIG], dtype=f32, device=device))


def _strip_chunk_lists(agg, win: int):
    """Per-strip x-sorted active-chunk lists and per-cell [lo, hi)
    bounds. agg (B, nc, 4) -> (lists (B, n_strips, nc) int32,
    bounds (B, n_strips * n_xb, 2) int32). The sort is stable, like
    jnp.argsort, so the lists match the TPU package's exactly."""
    B, nc = agg.shape[:2]
    n_strips = win // STRIP_H
    n_xb = _n_xb(win)
    xw = win // n_xb
    dev = agg.device
    s = torch.arange(n_strips, dtype=torch.float32, device=dev)[:, None]
    a = agg[:, None]                                   # (B, 1, nc, 4)
    active = ((a[..., AGG_YLO] < (s + 1.0) * STRIP_H)
              & (a[..., AGG_YHI] >= s * STRIP_H))      # (B, S, nc)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    xlo = torch.where(active, a[..., AGG_XLO], big)
    order = torch.argsort(xlo, dim=-1, stable=True)
    xlo_s = torch.gather(xlo, -1, order)
    xhi = torch.where(active, a[..., AGG_XHI], -big)
    pmax = torch.cummax(torch.gather(xhi, -1, order), dim=-1).values
    cell_lo = (torch.arange(n_xb, dtype=torch.float32, device=dev)
               * xw).expand(B, n_strips, n_xb).contiguous()
    hi_idx = torch.searchsorted(xlo_s.contiguous(), cell_lo + float(xw))
    lo_idx = torch.searchsorted(pmax.contiguous(), cell_lo)
    lo_idx = torch.minimum(lo_idx, hi_idx)
    bounds = torch.stack([lo_idx, hi_idx], dim=-1).reshape(
        B, n_strips * n_xb, 2)
    return (order.to(torch.int32).contiguous(),
            bounds.to(torch.int32).contiguous())


def _floor_div(a, w: int):
    """floor(a / w) of a float32 tensor in [-1, win], as int32: the float
    quotient, then one exact integer correction (raster_common.cuh
    floor_div)."""
    k = torch.floor(a / w).to(torch.int32)
    k = torch.where((k * w).to(a.dtype) > a, k - 1, k)
    return torch.where(((k + 1) * w).to(a.dtype) <= a, k + 1, k)


def _chunk_cells(agg, win: int):
    """The cells each chunk reaches, as the backward kernel computes them
    from agg alone (raster_common.cuh chunk_cells): agg (B, nc, 4) ->
    int32 (B, nc, 4) of (s_lo, s_hi, xb_lo, xb_hi), inclusive, empty
    where lo > hi. These are exactly the cells whose chunk_active test
    the chunk passes."""
    n_strips, n_xb = win // STRIP_H, _n_xb(win)
    xw = win // n_xb
    a = agg.clamp(-1.0, float(win))
    return torch.stack([
        _floor_div(a[..., AGG_YLO], STRIP_H).clamp(min=0),
        _floor_div(a[..., AGG_YHI], STRIP_H).clamp(max=n_strips - 1),
        _floor_div(a[..., AGG_XLO], xw).clamp(min=0),
        _floor_div(a[..., AGG_XHI], xw).clamp(max=n_xb - 1)], dim=-1)


def _active_pairs(agg, lists, bounds, win: int):
    """The (cell, chunk) pairs the forward kernel visits: per cell, the
    chunks of its [lo, hi) list slice that pass chunk_active. Returns
    bool (B, n_cells, nc), indexed by chunk id."""
    B, nc = agg.shape[:2]
    n_xb = _n_xb(win)
    xw = win // n_xb
    dev = agg.device
    cell = torch.arange(bounds.shape[1], device=dev)
    s, xb = cell // n_xb, cell % n_xb
    j = torch.arange(nc, device=dev)
    in_slice = (j >= bounds[..., :1]) & (j < bounds[..., 1:])
    ch = lists[:, s].long()                              # (B, C, nc)
    a = torch.gather(agg, 1, ch.reshape(B, -1, 1).expand(-1, -1, 4))
    a = a.reshape(*ch.shape, 4)
    x_lo = (xb * xw).to(torch.float32)[None, :, None]
    y_lo = (s * STRIP_H).to(torch.float32)[None, :, None]
    act = (in_slice & (a[..., AGG_XLO] < x_lo + xw)
           & (a[..., AGG_XHI] >= x_lo) & (a[..., AGG_YLO] < y_lo + STRIP_H)
           & (a[..., AGG_YHI] >= y_lo))
    # each strip's list is a permutation of the chunks
    return torch.zeros_like(act).scatter_(2, ch, act)


def _pair_work(tab, agg, lists, bounds, win: int, inv_blur: float):
    """The pixel-face pairs of the active (cell, chunk) pairs whose
    coverage term is not exactly 0, the part of the kernels' work that
    depends on the data. A pair is live where x = d|d| inv_blur < X_LIVE
    (the forward's log-sigmoid and the backward's sigmoid of x are 0 in
    f32 above it) and covered where d <= 0. Returns (live, covered,
    live rows): the last counts the (body, window row, face) triples
    with a live pair, whose y terms are evaluated once per row."""
    B, _, F_pad = tab.shape
    n_xb = _n_xb(win)
    xw = win // n_xb
    active = _active_pairs(agg, lists, bounds, win)
    px, py = _pixel_grid(win, tab.device)
    cell = (py.long() // STRIP_H) * n_xb + px.long() // xw
    live = covered = rows = 0
    for ch in range(F_pad // FACE_CHUNK):
        act = active[:, cell, ch][..., None]                 # (B, P, 1)
        if not bool(act.any()):
            continue
        d = _chunk_distances(
            tab[:, :, ch * FACE_CHUNK:(ch + 1) * FACE_CHUNK], px, py)[-1]
        lv = act & ((d * torch.abs(d)) * inv_blur < X_LIVE)
        live += int(lv.sum())
        covered += int((act & (d <= 0)).sum())
        rows += int(lv.reshape(B, win, win, -1).any(2).sum())
    return live, covered, rows


def _fwd_warp_rects(win: int, device):
    """The forward kernel's warps (raster_fwd.cu): warp w of a chunk
    group owns columns FWD_WARP_COLS w .. FWD_WARP_COLS (w + 1) - 1 and
    all STRIP_H rows of its cell. Returns the pixel-centre rectangle
    (x_a, x_b, y_a, y_b) of each (cell, warp), float32 (n_cells, W, 4),
    and each window pixel's (cell, warp) index, int64 (P,) in row-major
    pixel order."""
    n_strips, n_xb = win // STRIP_H, _n_xb(win)
    xw = win // n_xb
    W = -(-xw // FWD_WARP_COLS)
    c0 = torch.arange(W, device=device) * FWD_WARP_COLS
    c1 = torch.clamp(c0 + FWD_WARP_COLS, max=xw) - 1
    cell = torch.arange(n_strips * n_xb, device=device)[:, None]
    x0, y0 = (cell % n_xb) * xw, (cell // n_xb) * STRIP_H
    y_a = y0.expand(-1, W)
    rect = torch.stack([x0 + c0, x0 + c1, y_a, y_a + STRIP_H - 1],
                       -1).to(torch.float32) + 0.5
    p = torch.arange(win * win, device=device)
    y, x = p // win, p % win
    return rect, ((y // STRIP_H) * n_xb + x // xw) * W \
        + (x % xw) // FWD_WARP_COLS


def _fwd_cull(t, win: int, inv_blur: float):
    """The pixel-face pairs of a table slice t (B, 16, cs) that the
    forward kernel keeps: bool (B, P, cs). A warp drops a face for all
    its pixels where the face's bbox distance to the warp's rectangle (a
    lower bound of d at each of them, in the kernel's rounding) exceeds
    sqrt(X_CULL / inv_blur), or where the face carries the invalid mark
    (d_0 equal to its constant, above that distance): there the term is
    exactly 0 and d > 0."""
    rect, pix = _fwd_warp_rects(win, t.device)
    f32 = torch.float32
    cull = torch.sqrt(torch.tensor(X_CULL, dtype=f32)
                      / torch.tensor(inv_blur, dtype=f32)).to(t.device)
    r = rect[None, ..., None]                            # (1, C, W, 4, 1)

    def row(k):
        return t[:, k][:, None, None, :]                 # (B, 1, 1, cs)
    bb_min = torch.maximum(
        torch.maximum(row(12) - r[..., 1, :], r[..., 0, :] - row(13)),
        torch.maximum(row(14) - r[..., 3, :], r[..., 2, :] - row(15)))
    invalid = (row(0) == 0) & (row(1) == 0) & (row(2) > cull)
    keep = ~((bb_min > cull) | invalid)                  # (B, C, W, cs)
    return keep.reshape(t.shape[0], -1, t.shape[2])[:, pix]


def _fwd_work(tab, agg, lists, bounds, win: int, inv_blur: float):
    """The pixel-face pairs the forward kernel evaluates: those of the
    active (cell, chunk) pairs that its cull keeps."""
    n_xb = _n_xb(win)
    xw = win // n_xb
    active = _active_pairs(agg, lists, bounds, win)
    px, py = _pixel_grid(win, tab.device)
    cell = (py.long() // STRIP_H) * n_xb + px.long() // xw
    kept = 0
    for ch in range(tab.shape[2] // FACE_CHUNK):
        act = active[:, cell, ch][..., None]                 # (B, P, 1)
        if bool(act.any()):
            kept += int((act & _fwd_cull(
                tab[:, :, ch * FACE_CHUNK:(ch + 1) * FACE_CHUNK], win,
                inv_blur)).sum())
    return kept


# ---------------------------------------------------------------------------
# Plain torch version of the kernel pair
# ---------------------------------------------------------------------------

def _pixel_grid(win: int, device):
    p = torch.arange(win * win, device=device)
    px = (p % win).to(torch.float32) + 0.5
    py = torch.div(p, win, rounding_mode="floor").to(torch.float32) + 0.5
    return px, py


def _chunk_distances(t, px, py):
    """t (B, 16, cs) table slice; px, py (P,) -> d0, d1, d2, z, d each
    (B, P, cs), with the kernels' rounding order."""
    def row(r):
        return t[:, r][:, None, :]
    x, y = px[None, :, None], py[None, :, None]

    def plane(b):
        return row(3 * b) * x + row(3 * b + 1) * y + row(3 * b + 2)
    d0, d1, d2, zi = plane(0), plane(1), plane(2), plane(3)
    bb = torch.maximum(torch.maximum(row(12) - x, x - row(13)),
                       torch.maximum(row(14) - y, y - row(15)))
    d = torch.maximum(torch.maximum(d0, torch.maximum(d1, d2)), bb)
    return d0, d1, d2, zi, d


def raster_fwd_plain(tab, win: int, inv_blur: float, znear: float,
                     chunk: int = FACE_CHUNK):
    """Plain version of the forward kernel over all faces: tab
    (B, 16, F_pad) -> (zmin, logkeep, amin), each (B, win, win); zmin
    is BIG and amin -1 where no face covers."""
    B, _, F_pad = tab.shape
    dev = tab.device
    px, py = _pixel_grid(win, dev)
    P = win * win
    zmin = torch.full((B, P), BIG, dtype=torch.float32, device=dev)
    amin = torch.full((B, P), -1, dtype=torch.int64, device=dev)
    logkeep = torch.zeros((B, P), dtype=torch.float32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    for f0 in range(0, F_pad, chunk):
        _, _, _, zi, d = _chunk_distances(tab[:, :, f0:f0 + chunk], px, py)
        zc = torch.where((d <= 0) & (zi > znear), zi, big)
        cmin, carg = torch.min(zc, dim=-1)   # first (lowest) id on ties
        better = cmin < zmin
        zmin = torch.where(better, cmin, zmin)
        amin = torch.where(better, carg + f0, amin)
        logkeep = logkeep + torch.sum(
            F.logsigmoid((d * torch.abs(d)) * inv_blur), dim=-1)
    amin = torch.where(zmin >= BIG, torch.full_like(amin, -1), amin)
    shape = (B, win, win)
    return (zmin.reshape(shape), logkeep.reshape(shape),
            amin.to(torch.int32).reshape(shape))


def raster_bwd_plain(tab, dz, dlk, amin, win: int, inv_blur: float,
                     chunk: int = FACE_CHUNK):
    """Plain version of the backward kernel: per-pixel cotangents dz,
    dlk (B, win, win) and the forward's amin -> d_planes
    (B, F_pad, 12)."""
    B, _, F_pad = tab.shape
    dev = tab.device
    px, py = _pixel_grid(win, dev)
    pmat = torch.stack([px, py, torch.ones_like(px)], dim=-1)   # (P, 3)
    dz = dz.reshape(B, -1, 1)
    dlk = dlk.reshape(B, -1, 1)
    amin = amin.reshape(B, -1, 1).to(torch.int64)
    out = torch.zeros((B, F_pad, 12), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for f0 in range(0, F_pad, chunk):
        cs = min(chunk, F_pad - f0)
        d0, d1, d2, _, d = _chunk_distances(tab[:, :, f0:f0 + cs], px, py)
        absd = torch.abs(d)
        sig = torch.sigmoid(-(d * absd) * inv_blur)
        g = dlk * (sig * inv_blur) * (2.0 * absd)
        use0 = d == d0
        use1 = ~use0 & (d == d1)
        use2 = ~(use0 | use1) & (d == d2)
        ids = torch.arange(f0, f0 + cs, device=dev)
        gz = torch.where(amin == ids, dz, zero)
        G = torch.stack([torch.where(use0, g, zero),
                         torch.where(use1, g, zero),
                         torch.where(use2, g, zero), gz], dim=-1)
        out[:, f0:f0 + cs] = torch.einsum(
            "bpcq,pk->bcqk", G, pmat).reshape(B, cs, 12)
    return out


# ---------------------------------------------------------------------------
# Build, load and launch
# ---------------------------------------------------------------------------

def build_kernels() -> Tuple[Path, str]:
    """Compile csrc/ into a shared library under build/ unless a library
    of the same sources and flags is already there. Returns (path,
    nvcc's output); raises with the compiler's output if it fails."""
    return build_library("raster", _SOURCES, _HEADERS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(load_library("raster", _SOURCES, _HEADERS))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from csrc/."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mhmocap_raster_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, f, p,
                                       p]
    lib.mhmocap_raster_fwd.restype = i
    lib.mhmocap_raster_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p,
                                       p]
    lib.mhmocap_raster_bwd.restype = i
    lib.mhmocap_raster_log1p_check.argtypes = [p, p]
    lib.mhmocap_raster_log1p_check.restype = i
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_window(win: int):
    if win % STRIP_H:
        raise ValueError(f"raster window {win} is not a multiple of "
                         f"{STRIP_H}")
    # the forward's chunk group: a warp per FWD_WARP_COLS columns
    if 32 * -(-(win // _n_xb(win)) // FWD_WARP_COLS) > 512:
        raise ValueError(f"raster window {win}: its {win // _n_xb(win)} "
                         f"px cells exceed 512 threads per block")
    if win // STRIP_H * _n_xb(win) > 65535:
        raise ValueError(f"raster window {win}: more cells than the "
                         f"forward's 65535 grid rows")


def raster_fwd_cuda(tab, agg, win: int, inv_blur: float, znear: float):
    """Launch the forward kernel -> (zmin, logkeep, amin) (B, win, win).
    The kernel finds each cell's chunks from agg itself and writes every
    pixel once, and counts its launch in `launches`."""
    return _launch_fwd(tab, agg, win, inv_blur, znear)


def _launch_fwd(tab, agg, win: int, inv_blur: float, znear: float,
                lib=None):
    """Check the inputs, then launch the forward kernel of `lib` (a
    library bound by _bind; the one built from csrc/ by default)."""
    _check_window(win)
    B, _, F_pad = tab.shape
    nc = F_pad // FACE_CHUNK
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError("raster_fwd_cuda needs CUDA tensors")
    _check("tab", tab, torch.float32, (B, TAB_ROWS, nc * FACE_CHUNK), dev)
    _check("agg", agg, torch.float32, (B, nc, 4), dev)
    zmin = torch.empty((B, win, win), dtype=torch.float32, device=dev)
    logkeep = torch.empty_like(zmin)
    amin = torch.empty((B, win, win), dtype=torch.int32, device=dev)
    err = (lib or _library()).mhmocap_raster_fwd(
        tab.data_ptr(), agg.data_ptr(), zmin.data_ptr(), logkeep.data_ptr(),
        amin.data_ptr(), B, F_pad, win, _n_xb(win), float(inv_blur),
        float(znear), launches.pointer("fwd", dev),
        stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"raster forward kernel launch failed: CUDA "
                           f"error {err}")
    return zmin, logkeep, amin


def log1p_shortcut_mismatches(device) -> int:
    """The floats e in [0, expf(-19)] whose log1pf on the card is not e
    itself, bit for bit. The forward kernel takes log_sigmoid(x) as
    -expf(-x) where x >= 20 (raster_fwd.cu X_TINY), which is exact only
    if there are none."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    err = _library().mhmocap_raster_log1p_check(bad.data_ptr(),
                                                stream_ptr(device))
    if err != 0:
        raise RuntimeError(f"log1pf check kernel launch failed: CUDA "
                           f"error {err}")
    return int(bad)


def raster_bwd_cuda(tab, agg, dz, dlk, amin, win: int, inv_blur: float):
    """Launch the backward kernel -> d_planes (B, F_pad, 12). The kernel
    writes every entry once (chunks that reach no cell get zeros), so
    the output is not zero-filled first, and counts its launch in
    `launches`."""
    _check_window(win)
    B, _, F_pad = tab.shape
    nc = F_pad // FACE_CHUNK
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError("raster_bwd_cuda needs CUDA tensors")
    _check("tab", tab, torch.float32, (B, TAB_ROWS, nc * FACE_CHUNK), dev)
    _check("agg", agg, torch.float32, (B, nc, 4), dev)
    for name, t, dt in (("dz", dz, torch.float32),
                        ("dlk", dlk, torch.float32),
                        ("amin", amin, torch.int32)):
        _check(name, t, dt, (B, win, win), dev)
    dplanes = torch.empty((B, F_pad, 12), dtype=torch.float32, device=dev)
    err = _library().mhmocap_raster_bwd(
        tab.data_ptr(), agg.data_ptr(), dz.data_ptr(), dlk.data_ptr(),
        amin.data_ptr(), dplanes.data_ptr(), B, F_pad, win, _n_xb(win),
        float(inv_blur), launches.pointer("bwd", dev),
        stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"raster backward kernel launch failed: CUDA "
                           f"error {err}")
    return dplanes


# ---------------------------------------------------------------------------
# Tables and per-pixel glue of rasterizer.RasterFaces
# ---------------------------------------------------------------------------

def _reach(inv_blur: float) -> float:
    """The silhouette's reach past a face's bbox, in pixels: the x
    extents of the chunk aggregates."""
    return 3.0 / np.sqrt(inv_blur) + 1.0


def _tables(planes, bbox, lo_y, hi_y, ok_sil, ok_depth, inv_blur):
    return _fold_pack(planes, bbox, ok_sil, ok_depth, lo_y, hi_y,
                      _reach(inv_blur))


def _window_outputs(zmin, logkeep):
    """(zbuf, sil) from the forward's zmin and logkeep: zbuf is +inf
    where no face covers."""
    zbuf = torch.where(zmin >= BIG, torch.full_like(zmin, float("inf")),
                       zmin)
    return zbuf, 1.0 - torch.exp(logkeep)


def _cotangents(d_zbuf, d_sil, logkeep, amin):
    """The backward kernel's per-pixel cotangents (d_z, d_lk) from those
    of (zbuf, sil): d_z is 0 where no face covers or d_zbuf is not
    finite."""
    zero = torch.zeros((), dtype=torch.float32, device=logkeep.device)
    if d_zbuf is None:
        d_z = torch.zeros_like(logkeep)
    else:
        d_z = torch.where(torch.isfinite(d_zbuf) & (amin >= 0),
                          d_zbuf, zero).contiguous()
    if d_sil is None:
        d_lk = torch.zeros_like(logkeep)
    else:
        d_lk = (-torch.exp(logkeep) * d_sil).contiguous()
    return d_z, d_lk

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
  * `_strip_chunk_lists`: per strip, the chunks that overlap it in y,
    sorted by their bbox x-lo, and per (strip, x-block) cell the exact
    [lo, hi) slice of that list that can reach the cell in x. The list
    schedule is exact for any face order; a spatially coherent order
    (`rasterizer.preorder_faces`, which the Predictor applies) only
    makes it shorter. The TPU package's band-sorted prologue is not
    needed;
  * the plain torch version of both kernels, over all faces in face
    chunks (the CPU path, and the reference the card is held to);
  * `RasterPlanes`, the autograd.Function: on a CUDA tensor it
    launches the kernels (or raises), on a CPU tensor it runs the
    plain version;
  * the build-and-load helper: nvcc for sm_90a into build/ at first
    use, bound with ctypes.

Table layout (shared with csrc/raster_common.cuh): tab (B, 16, F_pad)
f32, rows 3*b + r = coefficient r (x, y, const) of plane b (edges 0-2,
then z), rows 12-15 = bbox (lox, hix, loy, hiy); agg (B, nc, 4).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

STRIP_H = 8
FACE_CHUNK = 128
TAB_ROWS = 16
AGG_XLO, AGG_XHI, AGG_YLO, AGG_YHI = 0, 1, 2, 3
BIG = 3.0e38
D_INVALID = 1.0e9
X_CELL_MIN = 16

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("raster_fwd.cu", "raster_bwd.cu")
_HEADERS = ("raster_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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

    edge = torch.where(oks[..., None], planes[..., :9],
                       torch.zeros((), dtype=f32, device=dev))
    edge = edge.reshape(B, Fn, 3, 3).clone()
    edge[..., 0, 2] = torch.where(oks, edge[..., 0, 2],
                                  torch.full_like(edge[..., 0, 2],
                                                  D_INVALID))
    zpl = torch.where(okd[..., None], planes[..., 9:12],
                      torch.tensor([0.0, 0.0, -D_INVALID], dtype=f32,
                                   device=dev))
    blocks = torch.cat([edge.reshape(B, Fn, 9), zpl], dim=-1)
    bbox_k = torch.where(oks[..., None], bbox,
                         torch.tensor([-BIG, BIG, -BIG, BIG], dtype=f32,
                                      device=dev))
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

def _build_dir() -> Path:
    return _CSRC.parents[2] / "build" / "mhmocap_tpu_torch"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the raster kernels are built with "
                       "the CUDA toolkit's nvcc (CUDA_HOME or PATH)")


def build_kernels() -> Tuple[Path, str]:
    """Compile csrc/ into a shared library under build/ unless a library
    of the same sources and flags is already there. Returns (path,
    nvcc's output); raises with the compiler's output if it fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _HEADERS + _SOURCES:
        h.update((_CSRC / name).read_bytes())
    out_dir = _build_dir()
    lib = out_dir / f"libmhmocap_raster_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(_CSRC / s) for s in _SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_kernels()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mhmocap_raster_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f,
                                       f, p]
    lib.mhmocap_raster_fwd.restype = i
    lib.mhmocap_raster_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                       f, p]
    lib.mhmocap_raster_bwd.restype = i
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
    if STRIP_H * (win // _n_xb(win)) > 1024:
        raise ValueError(f"raster window {win}: its {win // _n_xb(win)} "
                         f"px cells exceed 1024 threads per block")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raster_fwd_cuda(tab, agg, lists, bounds, win: int, inv_blur: float,
                    znear: float):
    """Launch the forward kernel -> (zmin, logkeep, amin) (B, win, win)."""
    _check_window(win)
    B, _, F_pad = tab.shape
    nc = F_pad // FACE_CHUNK
    n_strips, n_xb = win // STRIP_H, _n_xb(win)
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError("raster_fwd_cuda needs CUDA tensors")
    _check("tab", tab, torch.float32, (B, TAB_ROWS, nc * FACE_CHUNK), dev)
    _check("agg", agg, torch.float32, (B, nc, 4), dev)
    _check("lists", lists, torch.int32, (B, n_strips, nc), dev)
    _check("bounds", bounds, torch.int32, (B, n_strips * n_xb, 2), dev)
    zmin = torch.empty((B, win, win), dtype=torch.float32, device=dev)
    logkeep = torch.empty_like(zmin)
    amin = torch.empty((B, win, win), dtype=torch.int32, device=dev)
    err = _library().mhmocap_raster_fwd(
        tab.data_ptr(), agg.data_ptr(), lists.data_ptr(),
        bounds.data_ptr(), zmin.data_ptr(), logkeep.data_ptr(),
        amin.data_ptr(), B, F_pad, win, n_xb, float(inv_blur),
        float(znear), _stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"raster forward kernel launch failed: CUDA "
                           f"error {err}")
    RasterPlanes.launches["fwd"] += 1
    return zmin, logkeep, amin


def raster_bwd_cuda(tab, agg, lists, bounds, dz, dlk, amin, win: int,
                    inv_blur: float):
    """Launch the backward kernel -> d_planes (B, F_pad, 12)."""
    _check_window(win)
    B, _, F_pad = tab.shape
    nc = F_pad // FACE_CHUNK
    n_strips, n_xb = win // STRIP_H, _n_xb(win)
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError("raster_bwd_cuda needs CUDA tensors")
    _check("tab", tab, torch.float32, (B, TAB_ROWS, nc * FACE_CHUNK), dev)
    _check("agg", agg, torch.float32, (B, nc, 4), dev)
    _check("lists", lists, torch.int32, (B, n_strips, nc), dev)
    _check("bounds", bounds, torch.int32, (B, n_strips * n_xb, 2), dev)
    for name, t, dt in (("dz", dz, torch.float32),
                        ("dlk", dlk, torch.float32),
                        ("amin", amin, torch.int32)):
        _check(name, t, dt, (B, win, win), dev)
    dplanes = torch.zeros((B, F_pad, 12), dtype=torch.float32, device=dev)
    err = _library().mhmocap_raster_bwd(
        tab.data_ptr(), agg.data_ptr(), lists.data_ptr(),
        bounds.data_ptr(), dz.data_ptr(), dlk.data_ptr(), amin.data_ptr(),
        dplanes.data_ptr(), B, F_pad, win, n_xb, float(inv_blur),
        _stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"raster backward kernel launch failed: CUDA "
                           f"error {err}")
    RasterPlanes.launches["bwd"] += 1
    return dplanes


# ---------------------------------------------------------------------------
# autograd.Function
# ---------------------------------------------------------------------------

def _tables(planes, bbox, lo_y, hi_y, ok_sil, ok_depth, inv_blur):
    reach = 3.0 / np.sqrt(inv_blur) + 1.0
    return _fold_pack(planes, bbox, ok_sil, ok_depth, lo_y, hi_y, reach)


class RasterPlanes(torch.autograd.Function):
    """(zbuf, sil) of B bodies' windows from per-face planes.

    planes (B, F, 12) (differentiated); bbox (B, F, 4), lo_y/hi_y (B, F)
    reach-expanded y extents, ok_sil/ok_depth (B, F) bool (data only).
    zbuf is +inf where no face covers. CUDA tensors run the kernels,
    CPU tensors the plain version. `launches` counts kernel launches.
    """

    launches = {"fwd": 0, "bwd": 0}

    @staticmethod
    def forward(ctx, planes, bbox, lo_y, hi_y, ok_sil, ok_depth, win,
                inv_blur, znear):
        _check_window(win)
        with torch.no_grad():
            tab, agg = _tables(planes, bbox, lo_y, hi_y, ok_sil, ok_depth,
                               inv_blur)
            if planes.is_cuda:
                lists, bounds = _strip_chunk_lists(agg, win)
                zmin, logkeep, amin = raster_fwd_cuda(
                    tab, agg, lists, bounds, win, inv_blur, znear)
            else:
                lists = bounds = None
                zmin, logkeep, amin = raster_fwd_plain(tab, win, inv_blur,
                                                       znear)
            zbuf = torch.where(zmin >= BIG,
                               torch.full_like(zmin, float("inf")), zmin)
            sil = 1.0 - torch.exp(logkeep)
        # the backward walks the same tables and schedule
        ctx.save_for_backward(tab, agg, lists, bounds, logkeep, amin)
        ctx.win, ctx.inv_blur, ctx.n_faces = win, inv_blur, planes.shape[1]
        return zbuf, sil

    @staticmethod
    def backward(ctx, d_zbuf, d_sil):
        tab, agg, lists, bounds, logkeep, amin = ctx.saved_tensors
        win, inv_blur = ctx.win, ctx.inv_blur
        zero = torch.zeros((), dtype=torch.float32, device=tab.device)
        if d_zbuf is None:
            d_z = torch.zeros_like(logkeep)
        else:
            d_z = torch.where(torch.isfinite(d_zbuf) & (amin >= 0),
                              d_zbuf, zero).contiguous()
        if d_sil is None:
            d_lk = torch.zeros_like(logkeep)
        else:
            d_lk = (-torch.exp(logkeep) * d_sil).contiguous()
        with torch.no_grad():
            if tab.is_cuda:
                dtab = raster_bwd_cuda(tab, agg, lists, bounds, d_z, d_lk,
                                       amin, win, inv_blur)
            else:
                dtab = raster_bwd_plain(tab, d_z, d_lk, amin, win, inv_blur)
        return (dtab[:, :ctx.n_faces], None, None, None, None, None, None,
                None, None)


def raster_planes(planes, extents, win: int, inv_blur: float,
                  znear: float):
    """Functional entry: extents = (bbox, lo_y, hi_y, ok_sil, ok_depth).
    Returns (zbuf, sil), each (B, win, win)."""
    bbox, lo_y, hi_y, ok_sil, ok_depth = extents
    return RasterPlanes.apply(planes, bbox, lo_y, hi_y, ok_sil, ok_depth,
                              win, inv_blur, znear)

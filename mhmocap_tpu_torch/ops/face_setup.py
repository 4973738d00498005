"""The raster's face set-up: from projected vertices to the raster
kernels' tables and back, as a hand-written CUDA kernel pair and its
plain torch version.

The set-up is the first stage of `rasterizer.RasterFaces` forward and
the last of its backward (its docstring names the four kernel / plain
pairs). The kernels live in `csrc/face_setup.cu` (its header says what
each computes, what bounds it and how the design answers). This module
holds what surrounds them:

  * `face_planes`, `face_extents` and `face_tables`: the set-up in
    torch, from projected vertices (the face gather and `face_planes`)
    to the planes and extents, then the fold (`raster_cuda._tables`).
    `face_tables` is the forward kernel's plain version, and autograd
    through `face_extents`' planes the backward's on CPU tensors;
  * `incidence`: each vertex's (face, corner) incidences in ascending
    order (a CSR), and the faces as int32, built once per face table
    and device on the host and never evicted, since a captured CUDA
    graph reads them at their addresses;
  * `face_setup_bwd_plain`, the backward kernel's reference in the
    kernel's own order (the analytic derivative of each face's folded
    coefficients, summed per vertex over the CSR), which the CPU tests
    hold to the chain's autograd, and the card to the kernel;
  * the launchers and `launches` (`cuda_lib.LaunchCounts`: each kernel
    counts its own launches on the device);
  * the load of the library (`cuda_lib.load_library`: nvcc for sm_90a
    into build/ at first use), bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from . import raster_cuda as RC
from .cuda_lib import LaunchCounts, build_library, load_library, stream_ptr

_SOURCES = ("face_setup.cu",)
_HEADERS = ("raster_common.cuh",)
EDGE_EPS = 1e-12    # the clamp of an edge's squared length
AREA_EPS = 1e-9     # the least |double area| with a z plane

launches = LaunchCounts(("fwd", "bwd"))


# ---------------------------------------------------------------------------
# Plain torch version of the forward kernel
# ---------------------------------------------------------------------------

def face_planes(fuv, fz, znear, eps: float = EDGE_EPS):
    """Per-face affine plane coefficients.

    fuv: (..., F, 3, 2) screen-space face vertices; fz: (..., F, 3).
    Returns (planes (..., F, 12), bbox (..., F, 4) detached,
    ok_sil (..., F), ok_depth (..., F)). Columns are the three
    inside-negative unit edge lines (nx, ny, c) and the z plane
    (za, zb, zc); bbox = (lox, hix, loy, hiy).
    """
    ax, ay = fuv[..., 0, 0], fuv[..., 0, 1]
    bx, by = fuv[..., 1, 0], fuv[..., 1, 1]
    cx, cy = fuv[..., 2, 0], fuv[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    sgn = torch.where(area < 0, -1.0, 1.0).to(fuv.dtype)

    def edge(x0, y0, x1, y1):
        ex, ey = x1 - x0, y1 - y0
        inv_len = torch.rsqrt(torch.clamp(ex * ex + ey * ey, min=eps))
        return (sgn * ey * inv_len, -sgn * ex * inv_len,
                sgn * (ex * y0 - ey * x0) * inv_len)

    n0x, n0y, c0 = edge(ax, ay, bx, by)
    n1x, n1y, c1 = edge(bx, by, cx, cy)
    n2x, n2y, c2 = edge(cx, cy, ax, ay)

    ok_area = torch.abs(area) > AREA_EPS
    inv_a = (torch.where(ok_area, 1.0, 0.0).to(fuv.dtype)
             / torch.where(ok_area, area, torch.ones_like(area)))
    z0, z1, z2 = fz[..., 0], fz[..., 1], fz[..., 2]
    za = (z0 * (by - cy) + z1 * (cy - ay) + z2 * (ay - by)) * inv_a
    zb = (z0 * (cx - bx) + z1 * (ax - cx) + z2 * (bx - ax)) * inv_a
    zc = (z0 * (bx * cy - by * cx) + z1 * (cx * ay - cy * ax)
          + z2 * (ax * by - ay * bx)) * inv_a

    planes = torch.stack([n0x, n0y, c0, n1x, n1y, c1, n2x, n2y, c2,
                          za, zb, zc], dim=-1)
    u, v = fuv[..., 0].detach(), fuv[..., 1].detach()
    bbox = torch.stack([u.amin(dim=-1), u.amax(dim=-1),
                        v.amin(dim=-1), v.amax(dim=-1)], dim=-1)
    ok_sil = torch.all(fz > znear, dim=-1)
    return planes, bbox, ok_sil, ok_sil & ok_area


def face_extents(uvz, origin, faces, znear: float, reach_y: float):
    """The per-face planes of B bodies from their projected vertices uvz
    (B, V, 3), window origins (B, 2) int64 and faces (F, 3): (planes
    (B, F, 12), (bbox, lo_y, hi_y, ok_sil, ok_depth)), with the y
    extents reach_y past the bbox. Differentiable in uvz."""
    fuvz = uvz[:, faces]                                 # (B, F, 3, 3)
    planes, bbox, ok_sil, ok_depth = face_planes(
        fuvz[..., :2] - origin[:, None, None, :].to(uvz.dtype),
        fuvz[..., 2], znear)
    return planes, (bbox, bbox[..., 2] - reach_y, bbox[..., 3] + reach_y,
                    ok_sil, ok_depth)


def face_tables(uvz, origin, faces, znear: float, inv_blur: float,
                reach_y: float):
    """The raster kernels' inputs (tab (B, 16, F_pad), agg (B, nc, 4))
    from `face_extents`' planes: the plain version of the forward
    kernel."""
    planes, extents = face_extents(uvz, origin, faces, znear, reach_y)
    return RC._tables(planes, *extents, inv_blur)


# never evicted: a captured CUDA graph reads it at its address
@functools.cache
def incidence(faces, n_vertices: int, device):
    """(faces (F, 3) int32, ptr (V + 1,) int32, inc (3 F,) int32) on
    `device`: vertex v's incidences are inc[ptr[v]:ptr[v + 1]], each
    3 f + corner, ascending (the order of a stable sort of the flat face
    table). Built on the host at a face table's first call, which must
    not be inside a CUDA graph capture."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the face incidence is built by an eager call, "
                           "not inside a capture")
    flat = faces.detach().cpu().numpy().astype(np.int64).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= n_vertices):
        raise ValueError(f"face indices [{flat.min()}, {flat.max()}] lie "
                         f"outside {n_vertices} vertices")
    ptr = np.zeros(n_vertices + 1, np.int64)
    np.cumsum(np.bincount(flat, minlength=n_vertices), out=ptr[1:])
    inc = np.argsort(flat, kind="stable")

    def dev(a):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return dev(flat.reshape(-1, 3)), dev(ptr), dev(inc)


# ---------------------------------------------------------------------------
# Plain torch version of the backward kernel
# ---------------------------------------------------------------------------

def _corners(uvz, origin, faces):
    """Each face's window-local corners, 9 tensors (B, F): u, v, z of
    corner a, then b, then c."""
    shift = torch.cat([origin.to(uvz.dtype), uvz.new_zeros((len(uvz), 1))],
                      -1)
    c = uvz[:, faces] - shift[:, None, None, :]          # (B, F, 3, 3)
    return c.flatten(-2).unbind(-1)


def _face_grads(c, g, znear: float):
    """The derivative of each face's 12 folded coefficients, cotangents
    g (B, F, 12), with respect to its 9 corner inputs c (`_corners`):
    (B, F, 3, 3), corner by (u, v, z), in the kernel's operations and
    order (face_setup.cu face_grad)."""
    ax, ay, z0, bx, by, z1, cx, cy, z2 = c
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    sgn = torch.where(area < 0, -1.0, 1.0).to(area.dtype)
    ok_area = torch.abs(area) > AREA_EPS
    inv_a = (torch.where(ok_area, 1.0, 0.0).to(area.dtype)
             / torch.where(ok_area, area, torch.ones_like(area)))
    oks = (z0 > znear) & (z1 > znear) & (z2 > znear)
    okd = oks & ok_area
    u, v = [ax, bx, cx], [ay, by, cy]
    gu = [torch.zeros_like(ax) for _ in range(3)]
    gv = [torch.zeros_like(ax) for _ in range(3)]
    for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        gnx, gny, gc = g[..., 3 * e], g[..., 3 * e + 1], g[..., 3 * e + 2]
        x0, y0, x1, y1 = u[i], v[i], u[j], v[j]
        ex, ey = x1 - x0, y1 - y0
        s2 = ex * ex + ey * ey
        inv_len = torch.rsqrt(torch.clamp(s2, min=EDGE_EPS))
        sr = sgn * inv_len
        gw = sr * gc
        g_inv = sgn * (gnx * ey - gny * ex + gc * (ex * y0 - ey * x0))
        g_s2 = torch.where(s2 >= EDGE_EPS,
                           -0.5 * g_inv * (inv_len * inv_len * inv_len), 0.0)
        g_ex = gw * y0 - sr * gny + 2.0 * ex * g_s2
        g_ey = sr * gnx - gw * x0 + 2.0 * ey * g_s2
        gu[i] = gu[i] + torch.where(oks, -g_ex - gw * ey, 0.0)
        gv[i] = gv[i] + torch.where(oks, -g_ey + gw * ex, 0.0)
        gu[j] = gu[j] + torch.where(oks, g_ex, 0.0)
        gv[j] = gv[j] + torch.where(oks, g_ey, 0.0)
    na = z0 * (by - cy) + z1 * (cy - ay) + z2 * (ay - by)
    nb = z0 * (cx - bx) + z1 * (ax - cx) + z2 * (bx - ax)
    nc = (z0 * (bx * cy - by * cx) + z1 * (cx * ay - cy * ax)
          + z2 * (ax * by - ay * bx))
    ga, gb, gc = g[..., 9] * inv_a, g[..., 10] * inv_a, g[..., 11] * inv_a
    g_area = -(g[..., 9] * na + g[..., 10] * nb + g[..., 11] * nc) \
        * (inv_a / area)
    gz = [ga * (by - cy) + gb * (cx - bx) + gc * (bx * cy - by * cx),
          ga * (cy - ay) + gb * (ax - cx) + gc * (cx * ay - cy * ax),
          ga * (ay - by) + gb * (bx - ax) + gc * (ax * by - ay * bx)]
    du = [gb * (z1 - z2) + gc * (z2 * by - z1 * cy) + g_area * (by - cy),
          gb * (z2 - z0) + gc * (z0 * cy - z2 * ay) + g_area * (cy - ay),
          gb * (z0 - z1) + gc * (z1 * ay - z0 * by) + g_area * (ay - by)]
    dv = [ga * (z2 - z1) + gc * (z1 * cx - z2 * bx) + g_area * (cx - bx),
          ga * (z0 - z2) + gc * (z2 * ax - z0 * cx) + g_area * (ax - cx),
          ga * (z1 - z0) + gc * (z0 * bx - z1 * ax) + g_area * (bx - ax)]
    return torch.stack([torch.stack(
        [torch.where(okd, gu[k] + du[k], gu[k]),
         torch.where(okd, gv[k] + dv[k], gv[k]),
         torch.where(okd, gz[k], 0.0)], -1) for k in range(3)], -2)


def face_setup_bwd_plain(dtab, uvz, origin, faces, znear: float):
    """Plain version of the backward kernel: the raster backward's dtab
    (B, F_pad, 12) -> d_uvz (B, V, 3). Each vertex sums its incidences'
    corner derivatives (`_face_grads`) in ascending (face, corner)
    order, from 0."""
    B, V = uvz.shape[:2]
    Fn = faces.shape[0]
    _, ptr, inc = [x.long() for x in incidence(faces, V, uvz.device)]
    g = _face_grads(_corners(uvz, origin, faces), dtab[:, :Fn], znear)
    g = g.reshape(B, 3 * Fn, 3)
    deg = ptr[1:] - ptr[:-1]
    acc = torch.zeros((B, V, 3), dtype=uvz.dtype, device=uvz.device)
    for k in range(int(deg.max())):
        live = (deg > k)[None, :, None]
        rows = inc[torch.clamp(ptr[:-1] + k, max=inc.numel() - 1)]
        acc = torch.where(live, acc + g[:, rows], acc)
    return acc


# ---------------------------------------------------------------------------
# Build, load and launch
# ---------------------------------------------------------------------------

def build_kernels() -> Tuple[Path, str]:
    """Compile csrc/face_setup.cu into build/ unless it is built. Returns
    (path, nvcc's output); raises with the compiler's output if it
    fails."""
    return build_library("faces", _SOURCES, _HEADERS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("faces", _SOURCES, _HEADERS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mhmocap_face_setup_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, f,
                                           f, p, p]
    lib.mhmocap_face_setup_fwd.restype = i
    lib.mhmocap_face_setup_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, f,
                                           p, p]
    lib.mhmocap_face_setup_bwd.restype = i
    return lib


def _check_inputs(uvz, origin):
    dev = uvz.device
    if dev.type != "cuda":
        raise ValueError("the face set-up kernels need CUDA tensors")
    B, V = uvz.shape[:2]
    RC._check("uvz", uvz, torch.float32, (B, V, 3), dev)
    RC._check("origin", origin, torch.int64, (B, 2), dev)
    if B > 65535:
        raise ValueError(f"face set-up: {B} bodies exceed the grid's 65535")


def face_setup_fwd_cuda(uvz, origin, faces, znear: float, inv_blur: float,
                        reach_y: float):
    """Launch the forward kernel -> (tab (B, 16, F_pad), agg (B, nc, 4)),
    as `face_tables`; counts its launch in `launches`."""
    _check_inputs(uvz, origin)
    B, V = uvz.shape[:2]
    faces32, _, _ = incidence(faces, V, uvz.device)
    Fn = faces32.shape[0]
    F_pad = -(-Fn // RC.FACE_CHUNK) * RC.FACE_CHUNK
    dev = uvz.device
    tab = torch.empty((B, RC.TAB_ROWS, F_pad), dtype=torch.float32,
                      device=dev)
    agg = torch.empty((B, F_pad // RC.FACE_CHUNK, 4), dtype=torch.float32,
                      device=dev)
    err = _library().mhmocap_face_setup_fwd(
        uvz.data_ptr(), origin.data_ptr(), faces32.data_ptr(),
        tab.data_ptr(), agg.data_ptr(), B, V, Fn, F_pad, float(znear),
        float(RC._reach(inv_blur)), float(reach_y),
        launches.pointer("fwd", dev),
        stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"face set-up forward kernel launch failed: CUDA "
                           f"error {err}")
    return tab, agg


def face_setup_bwd_cuda(dtab, uvz, origin, faces, znear: float):
    """Launch the backward kernel: dtab (B, F_pad, 12) -> d_uvz
    (B, V, 3), as `face_setup_bwd_plain`; every entry written once, no
    atomics. Counts its launch in `launches`."""
    _check_inputs(uvz, origin)
    B, V = uvz.shape[:2]
    faces32, ptr, inc = incidence(faces, V, uvz.device)
    F_pad = -(-faces32.shape[0] // RC.FACE_CHUNK) * RC.FACE_CHUNK
    dev = uvz.device
    RC._check("dtab", dtab, torch.float32, (B, F_pad, 12), dev)
    duvz = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
    err = _library().mhmocap_face_setup_bwd(
        uvz.data_ptr(), origin.data_ptr(), faces32.data_ptr(),
        ptr.data_ptr(), inc.data_ptr(), dtab.data_ptr(), duvz.data_ptr(), B,
        V, F_pad, float(znear), launches.pointer("bwd", dev),
        stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"face set-up backward kernel launch failed: "
                           f"CUDA error {err}")
    return duvz

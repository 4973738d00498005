"""Differentiable mesh rasterization: z-buffer depth + soft silhouette.

Port of `mhmocap_tpu/ops/rasterizer.py` in its "edge_lines" semantics:
each body is rastered on a square crop window placed at its projected
bbox centre; per (pixel, face) the signed distance is the bbox-clamped
max of the face's three unit edge-line functions and the depth is the
plane-interpolated camera z (perspective_correct=False). Depth is the
hard z-min over covering faces; the silhouette is
1 - prod(1 - sigmoid(-d|d| / blur)) over all faces, summed in log space.

Backends (`RasterSettings.backend`):
  * "auto": the raster kernel pair of `raster_cuda`
    (hand-written CUDA on a GPU tensor; its plain torch version on a
    CPU tensor). This is the main path.
  * "brute": the all-faces-against-all-pixels reference
    `_raster_window_planes`, differentiated by autograd.
The body index is a batch axis throughout (the JAX package vmaps).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cameras import project_points
from .raster_cuda import raster_planes


class RasterSettings(NamedTuple):
    image_size: Tuple[int, int]      # (W, H)
    window: int = 128                # crop window side, pixels
    face_chunk: int = 128            # faces per step of the brute loop
    blur_ndc_sil: float = 2e-5
    znear: float = 1.0
    zfar: float = 100.0
    backend: str = "auto"            # "auto" | "brute"

    @property
    def sil_blur_px2(self) -> float:
        s = min(self.image_size) / 2.0
        return float(self.blur_ndc_sil * s * s)


def face_planes(fuv, fz, znear, eps: float = 1e-12):
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

    ok_area = torch.abs(area) > 1e-9
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


def spatial_face_order(v_template, faces, band: float = 0.05) -> np.ndarray:
    """Static spatially coherent face order from template geometry:
    5 cm y-bands, serpentine x within each band (numpy)."""
    v = np.asarray(v_template, np.float64)
    f = np.asarray(faces)
    c = v[f].mean(axis=1)
    b = np.floor((c[:, 1] - c[:, 1].min()) / band)
    x = np.where(b % 2 == 0, c[:, 0], -c[:, 0])
    return np.lexsort((x, b)).astype(np.int32)


def preorder_faces(model, band: float = 0.05, verts=None):
    """Copy of `model` with faces permuted by `spatial_face_order` of
    the template (or of `verts` (V, 3) when given)."""
    src = model.v_template if verts is None else verts
    src = src.detach().cpu().numpy() if torch.is_tensor(src) else src
    faces = model.faces.cpu().numpy()
    order = spatial_face_order(src, faces, band=band)
    return model.replace(faces=torch.as_tensor(
        faces[order], device=model.faces.device))


def eval_planes(px, py, planes, bbox, znear):
    """Pair quantities on broadcastable pixel grids -> (d|d|, z,
    inside)."""
    d0 = planes[..., 0] * px + planes[..., 1] * py + planes[..., 2]
    d1 = planes[..., 3] * px + planes[..., 4] * py + planes[..., 5]
    d2 = planes[..., 6] * px + planes[..., 7] * py + planes[..., 8]
    zi = planes[..., 9] * px + planes[..., 10] * py + planes[..., 11]
    bb = torch.maximum(torch.maximum(bbox[..., 0] - px, px - bbox[..., 1]),
                       torch.maximum(bbox[..., 2] - py, py - bbox[..., 3]))
    d = torch.maximum(torch.maximum(d0, torch.maximum(d1, d2)), bb)
    return d * torch.abs(d), zi, d <= 0


def window_origin(uv, z, settings: RasterSettings):
    """Crop-window origin (x0, y0) per body: uv (..., V, 2), z (..., V)
    -> (..., 2) int64, centred on the bbox of the in-front vertices and
    clamped to the image. torch.round, like jnp.round, rounds half to
    even."""
    W, H = settings.image_size
    win = settings.window
    ok = (z > settings.znear)[..., None]
    big = torch.tensor([W, H], dtype=uv.dtype, device=uv.device)
    lo = torch.where(ok, uv, big).amin(dim=-2)
    hi = torch.where(ok, uv, -big).amax(dim=-2)
    center = (0.5 * (lo + hi)).detach()
    origin = torch.round(center - win / 2.0).to(torch.int64)
    max_xy = torch.tensor([max(W - win, 0), max(H - win, 0)],
                          dtype=torch.int64, device=uv.device)
    return torch.minimum(torch.clamp(origin, min=0), max_xy)


def _raster_window_planes(fuv, fz, face_ok, origin,
                          settings: RasterSettings):
    """Brute "edge_lines" raster: all faces against all window pixels,
    in chunks of `face_chunk` faces. fuv (B, F, 3, 2), fz (B, F, 3),
    face_ok (B, F), origin (B, 2) -> (zbuf, sil) (B, win, win)."""
    win = settings.window
    chunk = settings.face_chunk
    fuv_l = fuv - origin[:, None, None, :].to(fuv.dtype)
    planes, bbox, ok_sil, ok_depth = face_planes(fuv_l, fz, settings.znear)
    ok_sil = ok_sil & face_ok
    ok_depth = ok_depth & face_ok

    xs = torch.arange(win, dtype=fuv.dtype, device=fuv.device) + 0.5
    px = xs[None, None, :, None]
    py = xs[None, :, None, None]
    inv_blur = 1.0 / settings.sil_blur_px2
    B, Fn = planes.shape[:2]
    zmin = torch.full((B, win, win), float("inf"), dtype=fuv.dtype,
                      device=fuv.device)
    logkeep = torch.zeros((B, win, win), dtype=fuv.dtype, device=fuv.device)
    for f0 in range(0, Fn, chunk):
        sl = slice(f0, f0 + chunk)
        d2s, zi, inside = eval_planes(px, py, planes[:, None, None, sl],
                                      bbox[:, None, None, sl],
                                      settings.znear)
        covered = (inside & ok_depth[:, None, None, sl]
                   & (zi > settings.znear))
        zmin = torch.minimum(zmin, torch.where(
            covered, zi, torch.full_like(zi, float("inf"))).amin(dim=-1))
        ls = F.logsigmoid(d2s * inv_blur)
        logkeep = logkeep + torch.sum(
            torch.where(ok_sil[:, None, None, sl], ls,
                        torch.zeros_like(ls)), dim=-1)
    return zmin, 1.0 - torch.exp(logkeep)


def rasterize_bodies(verts, faces, cam_K, settings: RasterSettings):
    """Depth + silhouette raster of B bodies on their crop windows.

    verts: (B, V, 3) camera space; faces: (F, 3); cam_K: (3, 3).
    Returns dict(zbuf (B, win, win), +inf where empty; sil
    (B, win, win); origin (B, 2) int64 window corner in the image).
    """
    uvz = project_points(verts, cam_K, return_depth=True)
    uv, z = uvz[..., :2], uvz[..., 2]
    origin = window_origin(uv, z, settings)
    fuvz = uvz[:, faces]                              # (B, F, 3, 3)
    fuv, fz = fuvz[..., :2], fuvz[..., 2]
    if settings.backend == "brute":
        face_ok = torch.all(fz > settings.znear, dim=-1)
        zbuf, sil = _raster_window_planes(fuv, fz, face_ok, origin,
                                          settings)
        return {"zbuf": zbuf, "sil": sil, "origin": origin}
    if settings.backend != "auto":
        raise ValueError(f"unknown raster backend {settings.backend!r}")
    fuv_l = fuv - origin[:, None, None, :].to(fuv.dtype)
    planes, bbox, ok_sil, ok_depth = face_planes(fuv_l, fz, settings.znear)
    reach = 3.0 * float(np.sqrt(settings.sil_blur_px2)) + 1.0
    zbuf, sil = raster_planes(
        planes, (bbox, bbox[..., 2] - reach, bbox[..., 3] + reach,
                 ok_sil, ok_depth),
        settings.window, 1.0 / settings.sil_blur_px2, settings.znear)
    return {"zbuf": zbuf, "sil": sil, "origin": origin}


def rasterize_body(verts, faces, cam_K, settings: RasterSettings):
    """One body: verts (V, 3) -> zbuf/sil (win, win), origin (2,)."""
    out = rasterize_bodies(verts[None], faces, cam_K, settings)
    return {k: v[0] for k, v in out.items()}

"""Plain depth + soft-silhouette raster of bodies on crop windows.

The semantics the port's raster kernels compute ("edge lines"): per
pixel centre p and face f, d = max(three inside-negative unit edge
functions, the distance outside the face's bbox); the silhouette is
1 - exp(sum over faces of log_sigmoid(d|d| / blur)) and the depth is
the smallest screen-space interpolated z over the faces that cover p
(d <= 0, z > znear), the lowest face index winning a tie.

This version visits only the pixel-face pairs whose term is not zero
in float32: a pair farther than sqrt(X_LIVE blur) from the face's bbox
has d|d| / blur > X_LIVE, where exp(-x) and with it the log-sigmoid
underflow. The pairs are enumerated per face from its bbox, so no face
order, table or schedule is shared with the kernels. Gradients come
from autograd: the silhouette through every live pair, the depth
through each pixel's winning face.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

X_LIVE = 104.0
# pairs per block of the enumeration (bounds its temporaries)
PAIR_BLOCK = 1 << 24


class Work(NamedTuple):
    """What a raster call's data needs, counted pair by pair: live
    pixel-face pairs (a term not zero), covered pairs, (body, window
    row, face) triples with a live pair, and pixels with a depth
    winner."""

    live: int
    covered: int
    rows: int
    winners: int


def face_planes(fuv, fz, znear: float, eps: float = 1e-12):
    """Per-face edge lines and z plane: fuv (..., F, 3, 2) window-local
    pixels, fz (..., F, 3) -> (planes (..., F, 12), bbox (..., F, 4)
    detached (lox, hix, loy, hiy), ok_sil, ok_depth)."""
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

    e0, e1, e2 = edge(ax, ay, bx, by), edge(bx, by, cx, cy), \
        edge(cx, cy, ax, ay)
    ok_area = torch.abs(area) > 1e-9
    inv_a = ok_area.to(fuv.dtype) / torch.where(ok_area, area,
                                                torch.ones_like(area))
    z0, z1, z2 = fz[..., 0], fz[..., 1], fz[..., 2]
    za = (z0 * (by - cy) + z1 * (cy - ay) + z2 * (ay - by)) * inv_a
    zb = (z0 * (cx - bx) + z1 * (ax - cx) + z2 * (bx - ax)) * inv_a
    zc = (z0 * (bx * cy - by * cx) + z1 * (cx * ay - cy * ax)
          + z2 * (ax * by - ay * bx)) * inv_a
    planes = torch.stack([*e0, *e1, *e2, za, zb, zc], dim=-1)
    u, v = fuv[..., 0].detach(), fuv[..., 1].detach()
    bbox = torch.stack([u.amin(-1), u.amax(-1), v.amin(-1), v.amax(-1)], -1)
    ok_sil = torch.all(fz > znear, dim=-1)
    return planes, bbox, ok_sil, ok_sil & ok_area


def window_origin(uv, z, win: int, image_size, znear: float):
    """Window corner per body: centred on the bbox of the vertices in
    front of znear, rounded half to even, clamped into the image."""
    W, H = image_size
    ok = (z > znear)[..., None]
    big = torch.tensor([W, H], dtype=uv.dtype, device=uv.device)
    lo = torch.where(ok, uv, big).amin(dim=-2)
    hi = torch.where(ok, uv, -big).amax(dim=-2)
    origin = torch.round(0.5 * (lo + hi).detach() - win / 2.0).long()
    top = torch.tensor([max(W - win, 0), max(H - win, 0)], device=uv.device)
    return torch.minimum(torch.clamp(origin, min=0), top)


def _enumerate(bbox, ok, win: int, reach: float):
    """(face, x, y) of every pixel whose centre lies within `reach` of
    the bbox of an ok face: bbox (M, 4), ok (M,) -> three int64 (P,)."""
    box = torch.where(ok[:, None], bbox, torch.zeros_like(bbox))
    x0 = torch.clamp(torch.ceil(box[:, 0] - reach - 0.5), min=0).long()
    x1 = torch.clamp(torch.floor(box[:, 1] + reach - 0.5), max=win - 1).long()
    y0 = torch.clamp(torch.ceil(box[:, 2] - reach - 0.5), min=0).long()
    y1 = torch.clamp(torch.floor(box[:, 3] + reach - 0.5), max=win - 1).long()
    nx = torch.clamp(x1 - x0 + 1, min=0)
    ny = torch.clamp(y1 - y0 + 1, min=0)
    cnt = nx * ny * ok.long()
    face = torch.repeat_interleave(torch.arange(len(cnt), device=cnt.device),
                                   cnt)
    start = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(len(face), device=cnt.device) - start[face]
    nxf = nx[face]
    return face, x0[face] + off % nxf, y0[face] + off // nxf


def _edge_d(P, bb, px, py):
    """d of pairs: P (n, >=9) edge coefficients, bb (n, 4), px, py (n,)."""
    d0 = P[:, 0] * px + P[:, 1] * py + P[:, 2]
    d1 = P[:, 3] * px + P[:, 4] * py + P[:, 5]
    d2 = P[:, 6] * px + P[:, 7] * py + P[:, 8]
    b = torch.maximum(torch.maximum(bb[:, 0] - px, px - bb[:, 1]),
                      torch.maximum(bb[:, 2] - py, py - bb[:, 3]))
    return torch.maximum(torch.maximum(d0, torch.maximum(d1, d2)), b)


def raster_window(verts, faces, K, win: int, image_size, znear: float,
                  blur_px2: float, count: bool = False):
    """Depth and silhouette of B bodies on their windows.

    verts (B, V, 3) camera space. Returns (zbuf (B, win, win), +inf
    where no face covers; sil (B, win, win); origin (B, 2) int64;
    Work or None)."""
    B, Fn = verts.shape[0], faces.shape[0]
    dev = verts.device
    inv_blur = 1.0 / blur_px2
    uvz = torch.cat([verts[..., :2] / verts[..., 2:3]
                     * torch.stack([K[0, 0], K[1, 1]]) + K[:2, 2],
                     verts[..., 2:3]], dim=-1)
    origin = window_origin(uvz[..., :2], uvz[..., 2], win, image_size, znear)
    fuvz = uvz[:, faces]
    fuv = fuvz[..., :2] - origin[:, None, None, :].to(verts.dtype)
    planes, bbox, ok_sil, ok_depth = face_planes(fuv, fuvz[..., 2], znear)
    planes = planes.reshape(B * Fn, 12)
    edges = planes[:, :9]
    bbox = bbox.reshape(B * Fn, 4)
    ok_sil, ok_depth = ok_sil.reshape(-1), ok_depth.reshape(-1)
    reach = (X_LIVE / inv_blur) ** 0.5

    P2 = win * win
    lk_idx, lk_val = [], []
    zpix, zface, zval = [], [], []
    live = covered = 0
    row_keys = []
    step = _faces_per_block(bbox[ok_sil], reach)
    for f0 in range(0, B * Fn, step):
        sl = slice(f0, min(f0 + step, B * Fn))
        face, ix, iy = _enumerate(bbox[sl], ok_sil[sl], win, reach)
        face = face + f0
        px = ix.to(verts.dtype) + 0.5
        py = iy.to(verts.dtype) + 0.5
        with torch.no_grad():
            d = _edge_d(edges.detach()[face], bbox[face], px, py)
            keep = d * torch.abs(d) * inv_blur < X_LIVE
        face, ix, iy, px, py = (t[keep] for t in (face, ix, iy, px, py))
        pix = (face // Fn) * P2 + iy * win + ix
        # index_select: its backward adds into the planes, with no sort
        d = _edge_d(edges.index_select(0, face), bbox[face], px, py)
        lk_idx.append(pix)
        lk_val.append(F.logsigmoid((d * torch.abs(d)) * inv_blur))
        with torch.no_grad():
            cand = (d.detach() <= 0) & ok_depth[face]
            fc, pc = face[cand], pix[cand]
            Pz = planes.detach()[:, 9:].index_select(0, fc)
            zi = Pz[:, 0] * px[cand] + Pz[:, 1] * py[cand] + Pz[:, 2]
            front = zi > znear
            zpix.append(pc[front])
            zface.append(fc[front])
            zval.append(zi[front])
        if count:
            live += len(face)
            covered += int(cand.sum())
            row_keys.append(face * win + iy)

    logkeep = torch.zeros(B * P2, dtype=verts.dtype, device=dev).index_add(
        0, torch.cat(lk_idx), torch.cat(lk_val))
    sil = (1.0 - torch.exp(logkeep)).reshape(B, win, win)

    zpix, zface, zval = torch.cat(zpix), torch.cat(zface), torch.cat(zval)
    inf = torch.full((B * P2,), float("inf"), dtype=verts.dtype, device=dev)
    zmin = inf.scatter_reduce(0, zpix, zval, "amin")
    tie = zval == zmin[zpix]
    nobody = torch.full((B * P2,), B * Fn, dtype=torch.int64, device=dev)
    win_face = nobody.scatter_reduce(0, zpix[tie], zface[tie], "amin")
    wpix = torch.nonzero(win_face < B * Fn).reshape(-1)
    wf = win_face[wpix]
    wx = (wpix % win).to(verts.dtype) + 0.5
    wy = ((wpix % P2) // win).to(verts.dtype) + 0.5
    Pw = planes.index_select(0, wf)
    zw = Pw[:, 9] * wx + Pw[:, 10] * wy + Pw[:, 11]
    zbuf = inf.index_put((wpix,), zw).reshape(B, win, win)
    work = None
    if count:
        rows = int(torch.unique(torch.cat(row_keys)).numel())
        work = Work(live, covered, rows, int(wpix.numel()))
    return zbuf, sil, origin, work


def _faces_per_block(bbox, reach: float) -> int:
    """Faces per enumeration block, from the largest face box, so that
    a block holds at most about PAIR_BLOCK pairs."""
    if not len(bbox):
        return 1 << 30
    span = (bbox[:, 1] - bbox[:, 0]).clamp(0, 1e4) + 2 * reach + 1
    span = span * ((bbox[:, 3] - bbox[:, 2]).clamp(0, 1e4) + 2 * reach + 1)
    return max(1, int(PAIR_BLOCK // max(float(span.mean()), 1.0)))

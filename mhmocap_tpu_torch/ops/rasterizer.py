"""Differentiable mesh rasterization: z-buffer depth + soft silhouette.

Port of `mhmocap_tpu/ops/rasterizer.py`. Each body is rastered on a
square crop window placed at its projected bbox centre. Depth is the
hard z-min over covering faces of the screen-space interpolated camera
z (perspective_correct=False); the silhouette is
1 - prod(1 - sigmoid(-d|d| / blur)) over all faces, summed in log space.

Two distance semantics (`RasterSettings.sil_mode`):
  * "edge_lines" (what the kernels compute): per (pixel, face) the
    signed distance is the bbox-clamped max of the face's three unit
    edge-line functions, affine in the pixel coordinates;
  * "segment": the exact point-to-triangle (segment) distance, the
    semantic reference.

Backends (`RasterSettings.backend`):
  * "auto": `RasterFaces`, in "edge_lines" semantics, on every
    device. This is the main path;
  * "brute": all faces against all window pixels in face chunks, in
    either semantics, differentiated by autograd;
  * "tiles": faces binned to tile x tile pixel blocks, each block
    evaluating only its `faces_per_tile` nearest overlapping faces
    (optionally after a back-face cull), in either semantics. Only a
    caller that names it gets it.
The body index is a batch axis throughout (the JAX package vmaps).
`full_image_raster` and `scatter_window_to_image` are the test and
visualization helpers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import face_setup as FS
from . import raster_cuda as RC
from .cameras import project_points
from .face_setup import face_planes


class RasterSettings(NamedTuple):
    image_size: Tuple[int, int]      # (W, H)
    window: int = 128                # crop window side, pixels
    face_chunk: int = 128            # faces per step of the brute loop
    blur_ndc_sil: float = 2e-5
    znear: float = 1.0
    zfar: float = 100.0
    # tiles backend: the `faces_per_tile` nearest faces whose
    # reach-expanded bbox overlaps each tile x tile block, gathered
    # `tile_chunk` at a time; exact wherever a tile holds fewer
    use_tiles: bool = True
    tile: int = 4
    faces_per_tile: int = 512
    tile_chunk: int = 64
    # tiles backend: drop faces facing away from the camera (outward
    # normal, keeping a grazing band of this cosine) before binning
    backface_cull: bool = False
    grazing_margin: float = 0.5
    backend: str = "auto"            # "auto" | "brute" | "tiles"
    sil_mode: str = "edge_lines"     # "edge_lines" | "segment"

    @property
    def sil_blur_px2(self) -> float:
        s = min(self.image_size) / 2.0
        return float(self.blur_ndc_sil * s * s)


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
    win = settings.window
    ok = (z > settings.znear)[..., None]
    big, max_xy = _window_bounds(tuple(settings.image_size), win, uv.dtype,
                                 uv.device)
    lo = torch.where(ok, uv, big).amin(dim=-2)
    hi = torch.where(ok, uv, -big).amax(dim=-2)
    center = (0.5 * (lo + hi)).detach()
    origin = torch.round(center - win / 2.0).to(torch.int64)
    return torch.minimum(torch.clamp(origin, min=0), max_xy)


# never evicted: a captured CUDA graph reads it at its address
@functools.cache
def _window_bounds(image_size, win: int, dtype, device):
    """`window_origin`'s (W, H) fill and its largest origin, built once
    per (image, window, device) so that a call copies nothing from the
    host (and can be captured in a CUDA graph)."""
    W, H = image_size
    return (torch.tensor([W, H], dtype=dtype, device=device),
            torch.tensor([max(W - win, 0), max(H - win, 0)],
                         dtype=torch.int64, device=device))


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


def _point_triangle_signed_d2(px, py, tri):
    """Signed squared distance of pixels to screen-space triangles:
    px, py broadcast against tri (..., 3, 2). Returns (d2_signed,
    inside), d2 negative inside the triangle."""
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]

    def edge(x0, y0, x1, y1):
        # cross((p - v0), (v1 - v0)) and squared distance to the segment
        ex, ey = x1 - x0, y1 - y0
        pxr, pyr = px - x0, py - y0
        cross = pxr * ey - pyr * ex
        ee = ex * ex + ey * ey
        t = torch.clamp((pxr * ex + pyr * ey) / torch.clamp(ee, min=1e-12),
                        0.0, 1.0)
        dx = pxr - t * ex
        dy = pyr - t * ey
        return cross, dx * dx + dy * dy

    c0, d0 = edge(ax, ay, bx, by)
    c1, d1 = edge(bx, by, cx, cy)
    c2, d2 = edge(cx, cy, ax, ay)
    area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    s = torch.sign(area2)
    # inside <=> s * c_i <= 0 for every edge, for either winding
    inside = ((s * c0 <= 0) & (s * c1 <= 0) & (s * c2 <= 0)
              & (torch.abs(area2) > 1e-9))
    dmin = torch.minimum(d0, torch.minimum(d1, d2))
    return torch.where(inside, -dmin, dmin), inside


def _barycentric_z(px, py, tri, z):
    """Screen-space barycentric interpolation of per-vertex z: tri
    (..., 3, 2), z (..., 3) (perspective_correct=False)."""
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inv = 1.0 / torch.where(torch.abs(area) > 1e-9, area,
                            torch.full_like(area, 1e-9))
    w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv
    w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv
    w2 = 1.0 - w0 - w1
    return w0 * z[..., 0] + w1 * z[..., 1] + w2 * z[..., 2]


def _segment_pairs(px, py, cuv, cz, cok, znear):
    """Segment-mode pair quantities of face slices cuv (..., k, 3, 2), cz
    (..., k, 3), cok (..., k) against pixels px, py broadcast to
    (..., P, 1): (d2s, zi, covered, sil_ok), each (..., P, k) but sil_ok
    (..., 1, k). Faces with a vertex at or behind znear are dropped."""
    ok = cok & torch.all(cz > znear, dim=-1)
    tri = cuv.unsqueeze(-4)
    d2s, inside = _point_triangle_signed_d2(px, py, tri)
    zi = _barycentric_z(px, py, tri, cz.unsqueeze(-3))
    ok = ok.unsqueeze(-2)
    return d2s, zi, inside & ok & (zi > znear), ok


def _raster_window(fuv, fz, face_ok, origin, settings: RasterSettings):
    """Brute raster of B bodies' faces onto their windows: fuv
    (B, F, 3, 2) image-space face vertices, fz (B, F, 3), face_ok (B, F),
    origin (B, 2) -> (zbuf, sil) (B, win, win), zbuf +inf where empty."""
    if settings.sil_mode == "edge_lines":
        return _raster_window_planes(fuv, fz, face_ok, origin, settings)
    if settings.sil_mode != "segment":
        raise ValueError(f"unknown sil_mode {settings.sil_mode!r}")
    win, chunk = settings.window, settings.face_chunk
    B, Fn = fuv.shape[:2]
    ar = torch.arange(win, dtype=fuv.dtype, device=fuv.device)
    o = origin.to(fuv.dtype)
    px = ((o[:, 0, None] + ar) + 0.5)[:, None, :, None]   # (B, 1, win, 1)
    py = ((o[:, 1, None] + ar) + 0.5)[:, :, None, None]   # (B, win, 1, 1)
    inv_blur = 1.0 / settings.sil_blur_px2
    zmin = torch.full((B, win, win), float("inf"), dtype=fuv.dtype,
                      device=fuv.device)
    logkeep = torch.zeros((B, win, win), dtype=fuv.dtype, device=fuv.device)
    for f0 in range(0, Fn, chunk):
        sl = slice(f0, f0 + chunk)
        d2s, zi, covered, sil_ok = _segment_pairs(
            px, py, fuv[:, None, sl], fz[:, None, sl], face_ok[:, None, sl],
            settings.znear)
        zmin = torch.minimum(zmin, torch.where(
            covered, zi, torch.full_like(zi, float("inf"))).amin(dim=-1))
        ls = F.logsigmoid(d2s * inv_blur)
        logkeep = logkeep + torch.sum(
            torch.where(sil_ok, ls, torch.zeros_like(ls)), dim=-1)
    return zmin, 1.0 - torch.exp(logkeep)


def _bin_faces_to_tiles(fuv_local, fz, face_ok, settings: RasterSettings):
    """Per-tile nearest-K overlapping face indices: fuv_local
    (B, F, 3, 2) window-local -> (idx (B, NT, K) int64, valid (B, NT, K)
    bool), NT = (win / tile)^2 tiles in row-major (ty, tx) order. Faces
    whose bbox, expanded by the soft edge's reach, overlaps a tile are
    ranked by their nearest vertex z; the silhouette band and the front
    surface survive a full tile."""
    win, tile = settings.window, settings.tile
    nt = win // tile
    K = min(settings.faces_per_tile, fuv_local.shape[1])
    reach = 3.0 * float(np.sqrt(settings.sil_blur_px2)) + 1.0
    lo = fuv_local.amin(dim=2) - reach                  # (B, F, 2)
    hi = fuv_local.amax(dim=2) + reach
    t0 = torch.arange(nt, dtype=fuv_local.dtype,
                      device=fuv_local.device) * tile
    ovx = ((lo[:, None, :, 0] < t0[:, None] + tile)
           & (hi[:, None, :, 0] >= t0[:, None]))         # (B, nt, F)
    ovy = ((lo[:, None, :, 1] < t0[:, None] + tile)
           & (hi[:, None, :, 1] >= t0[:, None]))
    overlap = (ovy[:, :, None] & ovx[:, None]).reshape(
        fuv_local.shape[0], nt * nt, -1) & face_ok[:, None]
    zmin = fz.amin(dim=-1)                              # (B, F)
    priority = torch.where(overlap, -zmin[:, None],
                           torch.full_like(overlap, float("-inf"),
                                           dtype=fz.dtype))
    neg_key, idx = torch.topk(priority, K, dim=-1)
    return idx, torch.isfinite(neg_key)


def _raster_window_tiled(fuv, fz, face_ok, origin, settings: RasterSettings):
    """Tile-binned raster of B bodies' windows: the same outputs as
    `_raster_window` where no tile exceeds its cap."""
    win, tile = settings.window, settings.tile
    nt = win // tile
    NT = nt * nt
    B = fuv.shape[0]
    fuv_local = fuv - origin[:, None, None, :].to(fuv.dtype)
    idx, valid = _bin_faces_to_tiles(fuv_local.detach(), fz.detach(),
                                     face_ok, settings)
    K = idx.shape[-1]
    kc = min(settings.tile_chunk, K)
    pad = (-K) % kc
    if pad:
        idx = torch.cat([idx, idx.new_zeros((B, NT, pad))], dim=-1)
        valid = torch.cat([valid, valid.new_zeros((B, NT, pad))], dim=-1)
        K += pad

    dev, dt = fuv.device, fuv.dtype
    t_idx = torch.arange(NT, device=dev)
    ty0 = (t_idx // nt * tile).to(dt)
    tx0 = (t_idx % nt * tile).to(dt)
    off = torch.arange(tile, dtype=dt, device=dev) + 0.5
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    px = tx0[:, None, None] + ox.reshape(1, tile * tile, 1)   # (NT, tt, 1)
    py = ty0[:, None, None] + oy.reshape(1, tile * tile, 1)

    inv_blur = 1.0 / settings.sil_blur_px2
    planes_mode = settings.sil_mode == "edge_lines"
    if planes_mode:
        planes, pbbox, ok_sil, ok_depth = face_planes(fuv_local, fz,
                                                      settings.znear)
        ok_sil = ok_sil & face_ok
        ok_depth = ok_depth & face_ok
    elif settings.sil_mode != "segment":
        raise ValueError(f"unknown sil_mode {settings.sil_mode!r}")
    bi = torch.arange(B, device=dev)[:, None, None]
    zmin = torch.full((B, NT, tile * tile), float("inf"), dtype=dt,
                      device=dev)
    logkeep = torch.zeros((B, NT, tile * tile), dtype=dt, device=dev)
    for k0 in range(0, K, kc):
        cidx, cok = idx[..., k0:k0 + kc], valid[..., k0:k0 + kc]
        if planes_mode:
            d2s, zi, inside = eval_planes(px, py, planes[bi, cidx][:, :, None],
                                          pbbox[bi, cidx][:, :, None],
                                          settings.znear)
            covered = (inside & (cok & ok_depth[bi, cidx])[:, :, None]
                       & (zi > settings.znear))
            sil_ok = (cok & ok_sil[bi, cidx])[:, :, None]
        else:
            d2s, zi, covered, sil_ok = _segment_pairs(
                px, py, fuv_local[bi, cidx], fz[bi, cidx], cok,
                settings.znear)
        zmin = torch.minimum(zmin, torch.where(
            covered, zi, torch.full_like(zi, float("inf"))).amin(dim=-1))
        ls = F.logsigmoid(d2s * inv_blur)
        logkeep = logkeep + torch.sum(
            torch.where(sil_ok, ls, torch.zeros_like(ls)), dim=-1)

    def untile(x):
        return x.reshape(B, nt, nt, tile, tile).permute(0, 1, 3, 2, 4) \
            .reshape(B, win, win)

    return untile(zmin), untile(1.0 - torch.exp(logkeep))


def _backface_ok(verts, faces, margin: float):
    """Faces not clearly facing away from the camera: the cosine between
    the outward normal and the ray to the face centre is below
    `margin`. verts (B, V, 3) camera space -> (B, F) bool."""
    tri3 = verts[:, faces]                               # (B, F, 3, 3)
    nrm = torch.cross(tri3[:, :, 1] - tri3[:, :, 0],
                      tri3[:, :, 2] - tri3[:, :, 0], dim=-1)
    c = tri3.mean(dim=2)
    cosang = (torch.sum(nrm * c, dim=-1)
              / torch.clamp(torch.linalg.norm(nrm, dim=-1)
                            * torch.linalg.norm(c, dim=-1), min=1e-9))
    return cosang < margin


def full_frame_window(image_size) -> int:
    """The square window that covers a whole (W, H) frame on the main
    path: the longer side rounded up to a multiple of 16, so that the
    kernels take it in 16 px cells (the JAX package rounds to 8). The
    window origin then clamps to (0, 0) and the strip past the frame is
    cropped by the caller."""
    return -(-max(image_size) // 16) * 16


class RasterFaces(torch.autograd.Function):
    """(zbuf, sil) of B bodies' windows from their projected vertices uvz
    (B, V, 3) (differentiated), window origins (B, 2) int64 and faces
    (F, 3); reach_y is the silhouette reach of the tables' y extents.
    zbuf is +inf where no face covers. The one raster of the main path.

    Each of its four stages is a hand-written kernel on CUDA tensors and
    that kernel's plain version on CPU tensors (kernel | plain):

      set-up forward:  face_setup.face_setup_fwd_cuda | face_tables
      raster forward:  raster_cuda.raster_fwd_cuda | raster_fwd_plain
      raster backward: raster_cuda.raster_bwd_cuda | raster_bwd_plain
      set-up backward: face_setup.face_setup_bwd_cuda | autograd of
                       face_setup.face_extents' planes

    `face_setup.face_setup_bwd_plain`, in the kernel's order, is that
    kernel's reference only: it rounds apart from the chain's autograd,
    and RMSprop's sign-driven steps amplify the gap.
    """

    @staticmethod
    def forward(ctx, uvz, origin, faces, win, inv_blur, znear, reach_y):
        RC._check_window(win)
        if uvz.is_cuda:
            tab, agg = FS.face_setup_fwd_cuda(uvz, origin, faces, znear,
                                              inv_blur, reach_y)
            zmin, logkeep, amin = RC.raster_fwd_cuda(tab, agg, win, inv_blur,
                                                     znear)
        else:
            tab, agg = FS.face_tables(uvz, origin, faces, znear, inv_blur,
                                      reach_y)
            zmin, logkeep, amin = RC.raster_fwd_plain(tab, win, inv_blur,
                                                      znear)
        ctx.save_for_backward(uvz, origin, tab, agg, logkeep, amin)
        ctx.faces, ctx.win, ctx.inv_blur = faces, win, inv_blur
        ctx.znear, ctx.reach_y = znear, reach_y
        return RC._window_outputs(zmin, logkeep)

    @staticmethod
    def backward(ctx, d_zbuf, d_sil):
        uvz, origin, tab, agg, logkeep, amin = ctx.saved_tensors
        d_z, d_lk = RC._cotangents(d_zbuf, d_sil, logkeep, amin)
        if uvz.is_cuda:
            dtab = RC.raster_bwd_cuda(tab, agg, d_z, d_lk, amin, ctx.win,
                                      ctx.inv_blur)
            duvz = FS.face_setup_bwd_cuda(dtab, uvz, origin, ctx.faces,
                                          ctx.znear)
        else:
            dtab = RC.raster_bwd_plain(tab, d_z, d_lk, amin, ctx.win,
                                       ctx.inv_blur)
            with torch.enable_grad():
                x = uvz.detach().requires_grad_()
                planes, _ = FS.face_extents(x, origin, ctx.faces, ctx.znear,
                                            ctx.reach_y)
                duvz, = torch.autograd.grad(planes, x,
                                            dtab[:, :planes.shape[1]])
        return duvz, None, None, None, None, None, None


def rasterize_bodies(verts, faces, cam_K, settings: RasterSettings):
    """Depth + silhouette raster of B bodies on their crop windows.

    verts: (B, V, 3) camera space; faces: (F, 3); cam_K: (3, 3).
    Returns dict(zbuf (B, win, win), +inf where empty; sil
    (B, win, win); origin (B, 2) int64 window corner in the image).
    """
    uvz = project_points(verts, cam_K, return_depth=True)
    origin = window_origin(uvz[..., :2], uvz[..., 2], settings)
    if settings.backend in ("brute", "tiles"):
        fuvz = uvz[:, faces]                          # (B, F, 3, 3)
        fuv, fz = fuvz[..., :2], fuvz[..., 2]
        face_ok = torch.all(fz > settings.znear, dim=-1)
        if (settings.backend == "tiles" and settings.use_tiles
                and settings.window % settings.tile == 0):
            if settings.backface_cull:
                face_ok = face_ok & _backface_ok(verts, faces,
                                                 settings.grazing_margin)
            zbuf, sil = _raster_window_tiled(fuv, fz, face_ok, origin,
                                             settings)
        else:
            zbuf, sil = _raster_window(fuv, fz, face_ok, origin, settings)
        return {"zbuf": zbuf, "sil": sil, "origin": origin}
    if settings.backend != "auto":
        raise ValueError(f"unknown raster backend {settings.backend!r}")
    if settings.sil_mode != "edge_lines":
        raise ValueError("the raster kernels compute the edge_lines "
                         "semantics; name backend 'brute' or 'tiles' for "
                         f"sil_mode {settings.sil_mode!r}")
    reach = 3.0 * float(np.sqrt(settings.sil_blur_px2)) + 1.0
    zbuf, sil = RasterFaces.apply(
        uvz.contiguous(), origin.contiguous(), faces, settings.window,
        1.0 / settings.sil_blur_px2, settings.znear, reach)
    return {"zbuf": zbuf, "sil": sil, "origin": origin}


def rasterize_body(verts, faces, cam_K, settings: RasterSettings):
    """One body: verts (V, 3) -> zbuf/sil (win, win), origin (2,)."""
    out = rasterize_bodies(verts[None], faces, cam_K, settings)
    return {k: v[0] for k, v in out.items()}


def full_image_raster(verts, faces, cam_K, image_size,
                      face_chunk: int = 256, **kw):
    """Rasterize one body over a whole square image (window == image),
    for tests and small images."""
    W, H = image_size
    if W != H:
        raise ValueError("full_image_raster expects a square image")
    settings = RasterSettings(image_size=image_size, window=W,
                              face_chunk=face_chunk, **kw)
    return rasterize_body(verts, faces, cam_K, settings)


def scatter_window_to_image(window_vals, origin, image_size, fill=0.0):
    """Place (..., win, win) window values into a (..., H, W) image at
    origin (x0, y0) as lax.dynamic_update_slice places them: a negative
    start counts from the end, then the start is clamped so that the
    window fits."""
    W, H = image_size
    win = window_vals.shape[-1]
    img = torch.full(window_vals.shape[:-2] + (H, W), fill,
                     dtype=window_vals.dtype, device=window_vals.device)

    def start(o, size):
        o = int(o)
        return min(max(o + size if o < 0 else o, 0), size - win)
    x0, y0 = start(origin[0], W), start(origin[1], H)
    img[..., y0:y0 + win, x0:x0 + win] = window_vals
    return img

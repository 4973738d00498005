"""Frustum Human-Scene Occupancy Grids (FHSOG) and related geometry.

Port of `mhmocap_tpu/engine/fhsog.py` (the research path of the
reference `mhmocap/fhsog.py`), as plain functions on tensors that run
on their inputs' device:

  * an exact Euclidean distance transform of binary masks and the
    Gaussian distance fields built on it;
  * front-to-back over-compositing of fog slabs into a depth map;
  * the frustum occupancy grid from background RGB-D;
  * points-inside-mesh queries and fog carving with body meshes;
  * the SMPL-conditioned FHSOG, whose per-frame full-frame raster of
    every body goes through `rasterize_bodies`: on CUDA tensors that is
    the face set-up's and the raster's forward kernels at a window
    covering the whole frame.

Differences of form, not of result, from the JAX package:
  * the 1-D EDT of a binary seed is the squared distance to the nearest
    zero on either side, found with a forward and a backward `cummax`
    of indices (the JAX package relaxes a double sequential scan); the
    second pass of the 2-D EDT is the same O(n^2) parabola envelope,
    taken over blocks of rows;
  * frames are rastered FRAMES_PER_CALL at a time (the last call is
    padded with the last frame), so that the kernel sees one body
    count; the fog is accumulated one frame at a time in frame order;
  * the raster window is `rasterizer.full_frame_window` (a multiple of
    16) where the JAX package rounds to 8; pixels are independent and
    the strip past the frame is cropped, so the frame is the same;
  * `points_inside_mesh` takes the points in blocks, so the (points x
    faces) distance table is never held whole. The distance is the
    direct sum of squared coordinate differences, as in JAX (the
    |p|^2 + |c|^2 - 2 p.c form moves the argmin on near-ties).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cameras import unproject_points

# elements of one block of the envelope and of the inside test
_BLOCK_ELEMS = 1 << 25
# frames rastered a call by build_fhsog_from_smpl (N bodies each)
FRAMES_PER_CALL = 4


# ---------------------------------------------------------------------------
# Euclidean distance transform (exact)
# ---------------------------------------------------------------------------

def _edt_1d_sq(mask: torch.Tensor, spacing: float) -> torch.Tensor:
    """Squared distance along the last axis from each cell to the
    nearest zero cell of `mask` (0 there, +inf where the line has
    none), float32."""
    n = mask.shape[-1]
    zero = mask == 0
    i = torch.arange(n, device=mask.device)
    left = torch.cummax(torch.where(zero, i, -1), dim=-1).values
    right = n - 1 - torch.cummax(
        torch.where(zero.flip(-1), i, -1), dim=-1).values.flip(-1)
    inf = torch.full((), float("inf"), device=mask.device)
    s2 = torch.tensor(spacing * spacing, dtype=torch.float32,
                      device=mask.device)
    dl = torch.where(left >= 0, ((i - left) ** 2).float() * s2, inf)
    dr = torch.where(right < n, ((right - i) ** 2).float() * s2, inf)
    return torch.minimum(dl, dr)


def _lower_envelope(f: torch.Tensor, spacing: float) -> torch.Tensor:
    """d[..., i] = min_j f[..., j] + (spacing (i - j))^2 over the last
    axis, exact, O(n^2) per line, in blocks of lines."""
    n = f.shape[-1]
    i = torch.arange(n, dtype=f.dtype, device=f.device)
    diff = (i[:, None] - i[None, :]) * spacing
    d2 = diff * diff
    lines = f.reshape(-1, n)
    step = max(1, _BLOCK_ELEMS // (n * n))
    out = torch.cat([(lines[a:a + step, None, :] + d2).amin(dim=-1)
                     for a in range(0, lines.shape[0], step)])
    return out.reshape(f.shape)


def _edt_2d_sq(mask: torch.Tensor, sy: float, sx: float) -> torch.Tensor:
    """Squared EDT of (..., H, W) masks."""
    d = _edt_1d_sq(mask.transpose(-1, -2), sy).transpose(-1, -2)
    return _lower_envelope(d, sx)


def distance_transform_edt(mask: torch.Tensor,
                           sampling: Optional[Tuple[float, ...]] = None
                           ) -> torch.Tensor:
    """Exact Euclidean distance from each nonzero cell to the nearest
    zero cell (scipy's semantics) of an (n,) or (H, W) mask."""
    if mask.ndim == 1:
        s = sampling[0] if sampling else 1.0
        return torch.sqrt(_edt_1d_sq(mask, s))
    if mask.ndim != 2:
        raise ValueError(f"mask of shape {tuple(mask.shape)}: (n,) or "
                         f"(H, W) expected")
    sy, sx = sampling if sampling else (1.0, 1.0)
    return torch.sqrt(_edt_2d_sq(mask, sy, sx))


def _gauss(edt, sigma: float):
    return (float(1.0 / (sigma * np.sqrt(2 * math.pi)))
            * torch.exp(-torch.square(edt) / sigma ** 2)).to(torch.float32)


def gaussian_distance_field_1d(x: torch.Tensor, sampling=None,
                               sigma: float = 1.0) -> torch.Tensor:
    """Gaussian of the EDT of (..., n) lines, spacing 1 / n by
    default."""
    n = x.shape[-1]
    s = sampling[0] if sampling else 1.0 / n
    return _gauss(torch.sqrt(_edt_1d_sq(x, s)), sigma)


def gaussian_distance_field_2d(omap: torch.Tensor, sampling=None,
                               sigma: float = 1.0) -> torch.Tensor:
    """Gaussian of the EDT of (..., H, W) maps, zeroed at the feature
    cells; spacing (1 / H, 1 / W) by default."""
    H, W = omap.shape[-2:]
    sy, sx = sampling if sampling else (1.0 / H, 1.0 / W)
    edt = torch.sqrt(_edt_2d_sq(omap, sy, sx))
    return _gauss(edt, sigma) * (edt > 0)


# ---------------------------------------------------------------------------
# Occupancy grids
# ---------------------------------------------------------------------------

def over_composite_from_fog(fog_alpha: torch.Tensor, near_z: float = 1.0,
                            far_z: float = 100.0) -> torch.Tensor:
    """Front-to-back over-compositing of log-spaced fog slabs (D, H, W)
    into a depth map (H, W)."""
    D, H, W = fog_alpha.shape
    dval = torch.linspace(float(np.log(near_z)), float(np.log(far_z)), D,
                          device=fog_alpha.device)[:, None, None]
    trans = torch.cumprod(1.0 - fog_alpha, dim=0)
    blend = torch.cat([torch.ones((1, H, W), device=fog_alpha.device),
                       trans[:-1]], dim=0)
    return torch.exp(torch.sum(dval * fog_alpha * blend, dim=0))


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values of an even count."""
    v = torch.sort(x.reshape(-1)).values
    k = v.numel()
    if k % 2:
        return v[k // 2]
    return v[k // 2 - 1] * 0.5 + v[k // 2] * 0.5


def build_fhs_occupancy_grid(depths, images, backmasks, min_z, max_z,
                             cam_K=None, num_depth_bins: int = 128):
    """Frustum occupancy grid and background texture from per-frame
    background RGB-D.

    depths: (T, H, W) normalized disparity; images: (T, H, W, 3);
    backmasks: (T, H, W); min_z/max_z: (T, 1, 1). Returns (fog_alpha
    (D, H, W) f32, back_mask (H, W) bool, texture (H, W, 3) uint8,
    near_z, far_z).
    """
    T, H, W = depths.shape
    D = num_depth_bins
    dev = depths.device
    de = 1.0 / (depths * (1.0 / min_z - 1.0 / max_z) + 1.0 / max_z)
    near_z = 0.999 * _median(min_z)
    far_z = 1.001 * _median(max_z)

    mask = (backmasks > 0.5) & (de >= near_z) & (de <= far_z)
    lnear = torch.log(near_z)
    vlog = ((torch.log(torch.minimum(torch.maximum(de, near_z), far_z))
             - lnear) / (torch.log(far_z) - lnear))
    idx = torch.where(mask, 1 + (D * vlog).to(torch.int64),
                      torch.zeros((), dtype=torch.int64, device=dev))
    idx = idx.clamp(0, D)

    # per-pixel histogram over the depth bins
    pix = torch.arange(H * W, device=dev)
    grid = torch.bincount((idx.reshape(T, -1) * (H * W) + pix).reshape(-1),
                          minlength=(D + 1) * H * W).reshape(D + 1, H, W)

    mask_acc = T - grid[0]
    texture = (torch.sum(images.to(torch.float32) * mask[..., None], dim=0)
               / mask_acc.clamp(min=1)[..., None].to(torch.float32))
    back_mask = mask_acc > 0
    texture = torch.where(back_mask[..., None], texture,
                          torch.full((), 255.0, device=dev))

    # occupied from the per-pixel argmax bin on
    amax = torch.argmax(grid[1:], dim=0)
    d_idx = torch.arange(D, device=dev)[:, None, None]
    fog_alpha = (back_mask[None] & (amax[None] <= d_idx)).to(torch.float32)
    return fog_alpha, back_mask, texture.to(torch.uint8), near_z, far_z


def points_inside_mesh(verts, faces, points, eps: float = 1e-2):
    """Inside test of points against a closed mesh by the closest face:
    a point is inside when the vector from the closest face centre to it
    opposes the face's outward normal.

    verts: (V, 3); faces: (F, 3); points: (N, 3) -> (N,) bool.
    """
    tri = verts[faces]                       # (F, 3, 3)
    centers = tri.mean(dim=1)                # (F, 3)
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    step = max(1, _BLOCK_ELEMS // max(1, centers.shape[0]))
    closest = []
    for a in range(0, points.shape[0], step):
        p = points[a:a + step]
        d2 = torch.square(p[:, 0, None] - cx)
        d2 = d2 + torch.square(p[:, 1, None] - cy)
        d2 = d2 + torch.square(p[:, 2, None] - cz)
        closest.append(torch.argmin(d2, dim=1))
    closest = (torch.cat(closest) if closest
               else torch.zeros(0, dtype=torch.int64, device=points.device))
    ctri = tri[closest]
    c = centers[closest]
    nrm = torch.cross(ctri[:, 1] - ctri[:, 0], ctri[:, 2] - ctri[:, 1],
                      dim=-1)
    nrm = nrm / torch.linalg.norm(nrm, dim=1, keepdim=True).clamp(min=1e-3)
    v = points - c
    v = v / torch.linalg.norm(v, dim=1, keepdim=True).clamp(min=eps)
    return torch.sum(nrm * v, dim=1) < -eps / 10


def fog_voxel_points(shape, near_z: float, far_z: float, cam_K):
    """Camera-space centres (H * W * D, 3) of a (D, H, W) fog grid's
    voxels in (row, column, bin) order: pixel centres unprojected at
    log-spaced depths."""
    D, H, W = shape
    dev = cam_K.device
    uu = torch.linspace(0.5, W - 0.5, W, device=dev)
    vv = torch.linspace(0.5, H - 0.5, H, device=dev)
    dd = torch.exp(torch.linspace(float(np.log(near_z)),
                                  float(np.log(far_z)), D, device=dev))
    gv, gu, gd = torch.meshgrid(vv, uu, dd, indexing="ij")
    uvd = torch.stack([gu, gv, gd], dim=-1).reshape(-1, 3)
    return unproject_points(uvd, cam_K)


def carve_fog_with_meshes(fog, verts, faces, near_z, far_z, cam_K):
    """The solid fog voxels that lie inside any of the given body meshes,
    as a boolean grid of the fog's shape (D, H, W). verts: (B, V, 3)
    camera-space bodies. Only the solid voxels are tested."""
    D, H, W = fog.shape
    pts = fog_voxel_points(fog.shape, near_z, far_z, cam_K)
    solid = fog.permute(1, 2, 0).reshape(-1) > 0
    sel = torch.nonzero(solid).squeeze(1)
    inside_any = torch.zeros(sel.shape[0], dtype=torch.bool,
                             device=fog.device)
    for b in range(verts.shape[0]):
        inside_any |= points_inside_mesh(verts[b], faces, pts[sel])
    carved = torch.zeros_like(solid)
    carved[sel] = inside_any
    return carved.reshape(H, W, D).permute(2, 0, 1)


@torch.no_grad()
def build_fhsog_from_smpl(depths_metric, images, backmasks, verts, faces,
                          cam_K, near_z: float, far_z: float,
                          num_depth_bins: int = 128, sigma: float = 0.25,
                          person_sigma: float = 5.0):
    """SMPL-conditioned FHSOG.

    Accumulates, over frames, a Gaussian-distance-field-weighted
    occupancy along log-spaced depth bins, gated in depth by where the
    rastered people are: each frame renders its N bodies over the whole
    frame, masks the background to cells that are neither body nor out
    of the frustum, and adds GDF mass at each pixel's depth bin weighted
    by a 1-D GDF around the per-person average depths. A body with no
    rastered pixel gets average depth 0, which the clip maps to near_z
    (the reference's behaviour).

    depths_metric: (T, H, W) metric depth; images: (T, H, W, 3);
    backmasks: (T, H, W); verts: (T, N, V, 3) camera space; faces:
    (F, 3); cam_K: (3, 3), all on one device. Returns (fhsog_alpha
    (D, H, W), texture (H, W, 3), outmask (H, W), smpl_masks (T, H, W),
    gdfs (T, H, W)).
    """
    from ..ops.rasterizer import (RasterSettings, full_frame_window,
                                  rasterize_bodies)

    T, N = verts.shape[:2]
    H, W = depths_metric.shape[1:]
    D = num_depth_bins
    dev = depths_metric.device
    st = RasterSettings(image_size=(W, H), window=full_frame_window((W, H)))
    backseg = ((backmasks > 0.5) & (depths_metric > near_z)
               & (depths_metric < far_z))
    log_near = float(np.float32(np.log(near_z)))
    log_span = float(np.log(far_z) - np.log(near_z))

    def bins(v):
        return torch.clamp((v - 0.5).to(torch.int64), 0, D - 1)

    fhsog_alpha = torch.zeros((D, H * W), dtype=torch.float32, device=dev)
    texture = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    smpl_masks, gdfs = [], []
    fpc = FRAMES_PER_CALL
    for t0 in range(0, T, fpc):
        sl = torch.arange(t0, t0 + fpc, device=dev).clamp(max=T - 1)
        n_real = min(fpc, T - t0)
        r = rasterize_bodies(verts[sl].reshape(fpc * N, -1, 3), faces, cam_K,
                             st)
        zb = r["zbuf"].reshape(fpc, N, st.window, st.window)[
            :n_real, :, :H, :W]
        zmask = torch.isfinite(zb) & (zb > 0)
        zb_safe = torch.where(zmask, zb, torch.zeros((), device=dev))
        smpl_mask = zmask.any(dim=1)                          # (k, H, W)
        avg_pd = (zb_safe.sum(dim=(2, 3))
                  / zmask.sum(dim=(2, 3)).clamp(min=1))       # (k, N)
        avg_pd = avg_pd.clamp(near_z, far_z)

        gdf2 = gaussian_distance_field_2d(
            (backseg[t0:t0 + n_real] & ~smpl_mask).to(torch.float32),
            sigma=sigma)
        person_vec = torch.ones((n_real, D), device=dev)
        person_vec.scatter_(
            1, bins(D * (torch.log(avg_pd) - log_near) / log_span), 0.0)
        person_gdf = gaussian_distance_field_1d(person_vec,
                                                sigma=person_sigma)
        idx = bins(D * ((torch.log(depths_metric[t0:t0 + n_real].clamp(
            near_z, far_z)) - log_near) / log_span))
        gval = gdf2 * torch.gather(person_gdf, 1, idx.reshape(n_real, -1)
                                   ).reshape(n_real, H, W)
        img = images[t0:t0 + n_real].to(torch.float32)
        for k in range(n_real):
            # one add per (bin, pixel) a frame, frames in order
            fhsog_alpha.scatter_add_(0, idx[k].reshape(1, -1),
                                     gval[k].reshape(1, -1))
            texture = texture + gval[k, ..., None] * img[k]
        smpl_masks.append(smpl_mask)
        gdfs.append(gdf2)

    fhsog_alpha = fhsog_alpha.reshape(D, H, W)
    outmask = fhsog_alpha.sum(dim=0)
    texture = torch.clamp(texture / outmask[..., None].clamp(min=0.1), 0,
                          255)
    return (fhsog_alpha, texture, outmask, torch.cat(smpl_masks),
            torch.cat(gdfs))

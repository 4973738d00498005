"""Visualization exports: loss curves, overlay renders, data pickle.

Port of `mhmocap_tpu/viz/export.py` without matplotlib: the same files
by name and count (fig_optim_curves_init.png, vis_init/vis_%04d.png for
the first 25 frames, fig_optim_curves_stage1.png, vis_stage1/vis_%04d.png
for the first 20, visualization_data_stage1.pkl with the JAX package's
keys, shapes and dtypes). The figures are drawn into uint8 arrays at the
image's own resolution and written with `io.write_png`:

  * loss curves: log(loss) polylines on a grey grid, one colour per key
    (the JAX package's colours and key order), with a colour swatch per
    key in that order at the top right; no text;
  * init overlay: the image twice side by side, the confident 2D
    skeleton over the left copy, the projected vertices (alpha 0.05)
    and white joint markers over the right;
  * stage-1 overlay: the image with the projected skeleton and white
    markers at the visible 2D keypoints, the image with the projected
    vertices, and the log-depth map in viridis.

The pixels are not matplotlib's. The SMPL forward and the projections
run batched on the model's device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..io import write_png
from ..models.smpl import smpl_forward
from ..ops.cameras import project_points

PLOT_COLORS = ["red", "green", "blue", "yellow", "cyan", "magenta",
               "gold", "olive", "deeppink", "darkorange", "navy"]

# COCO-17 limb links
ALPHAPOSE_LINKS = [
    [0, 1], [0, 2], [1, 3], [2, 4], [5, 7], [7, 9], [6, 8], [8, 10],
    [5, 11], [6, 12], [11, 13], [13, 15], [12, 14], [14, 16],
]

# matplotlib's RGB values of the colour names used here
RGB = {
    "red": (255, 0, 0), "green": (0, 128, 0), "blue": (0, 0, 255),
    "yellow": (255, 255, 0), "cyan": (0, 255, 255),
    "magenta": (255, 0, 255), "gold": (255, 215, 0),
    "olive": (128, 128, 0), "deeppink": (255, 20, 147),
    "darkorange": (255, 140, 0), "navy": (0, 0, 128),
    "darkgreen": (0, 100, 0), "r": (255, 0, 0), "g": (0, 128, 0),
    "b": (0, 0, 255), "m": (191, 0, 191), "y": (191, 191, 0),
    "k": (0, 0, 0), "w": (255, 255, 255),
}

INIT_CURVES = (("loss_2d", "r"),)
STAGE1_CURVES = (
    ("loss_pose24j", "r"), ("loss_depth", "b"), ("loss_silhouette", "g"),
    ("reg_vel", "darkorange"), ("reg_filter_verts", "darkgreen"),
    ("reg_ref_poses", "m"), ("reg_scale", "y"), ("reg_contact", "k"),
    ("reg_foot_sliding", "gold"))

# viridis sampled at 9 evenly spaced points (linear in between)
_VIRIDIS = np.array([
    (68, 1, 84), (71, 44, 122), (59, 82, 139), (44, 113, 142),
    (33, 145, 140), (39, 173, 129), (92, 200, 99), (170, 220, 50),
    (253, 231, 37)], np.float64)

CURVE_SIZE = (1200, 450)              # (W, H) of the loss-curve figures
GRID_RGB = (176, 176, 176)


# ---------------------------------------------------------------------------
# Drawing on uint8 (H, W, 3) arrays
# ---------------------------------------------------------------------------

def clip_segments(p0, p1, w: int, h: int):
    """Liang-Barsky clip of segments p0 -> p1 ((M, 2) x, y) to the pixel
    box [0, w-1] x [0, h-1]; segments with a non-finite end or wholly
    outside are dropped. Returns the clipped (q0, q1)."""
    p0 = np.asarray(p0, np.float64).reshape(-1, 2)
    p1 = np.asarray(p1, np.float64).reshape(-1, 2)
    keep = np.isfinite(p0).all(-1) & np.isfinite(p1).all(-1)
    p0, p1 = p0[keep], p1[keep]
    d = p1 - p0
    t0, t1 = np.zeros(len(p0)), np.ones(len(p0))
    vis = np.ones(len(p0), bool)
    for k, hi in ((0, w - 1), (1, h - 1)):
        # p0 + t d stays in [0, hi]: -d t <= p0 and d t <= hi - p0
        for pk, qk in ((-d[:, k], p0[:, k]), (d[:, k], hi - p0[:, k])):
            with np.errstate(divide="ignore", invalid="ignore"):
                r = qk / pk
            t0 = np.where(pk < 0, np.maximum(t0, r), t0)
            t1 = np.where(pk > 0, np.minimum(t1, r), t1)
            vis &= ~((pk == 0) & (qk < 0))
    vis &= t0 <= t1
    t0, t1, p0, d = t0[vis], t1[vis], p0[vis], d[vis]
    return p0 + t0[:, None] * d, p0 + t1[:, None] * d


def draw_lines(img: np.ndarray, p0, p1, color, width: int = 1):
    """Opaque lines of `width` px from p0 to p1 ((M, 2) x, y), sampled
    at one point per pixel step (DDA) and clipped to the image."""
    h, w = img.shape[:2]
    q0, q1 = clip_segments(p0, p1, w, h)
    if not len(q0):
        return
    n = np.ceil(np.abs(q1 - q0).max(-1)).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(q0)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    t = k / np.maximum(n[seg] - 1, 1)
    xy = np.rint(q0[seg] + t[:, None] * (q1 - q0)[seg]).astype(np.int64)
    lo = -(width // 2)
    offs = np.arange(lo, lo + width)
    x = (xy[:, 0, None, None] + offs[None, :, None]).ravel()
    y = (xy[:, 1, None, None] + offs[None, None, :]).ravel()
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    img[y[ok], x[ok]] = color


def blend_points(img: np.ndarray, xy, color, alpha: float):
    """One-pixel points of `color` at opacity `alpha` composited in
    turn: a pixel hit k times keeps (1 - alpha)^k of its colour."""
    h, w = img.shape[:2]
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    xy = xy[np.isfinite(xy).all(-1)]
    x, y = np.rint(xy[:, 0]).astype(np.int64), np.rint(xy[:, 1]).astype(
        np.int64)
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    idx, hits = np.unique(y[ok] * w + x[ok], return_counts=True)
    if not len(idx):
        return
    keep = (1.0 - alpha) ** hits[:, None]
    flat = img.reshape(-1, img.shape[-1])
    flat[idx] = np.rint(flat[idx] * keep + np.asarray(color, np.float64)
                        * (1.0 - keep)).astype(np.uint8)


# a small upward triangle (matplotlib's "^" marker at s=8)
_TRIANGLE = np.array([(0, -1), (-1, 0), (0, 0), (1, 0), (-2, 1), (-1, 1),
                      (0, 1), (1, 1), (2, 1)])


def draw_markers(img: np.ndarray, xy, color):
    """Opaque triangle markers centred at `xy` ((M, 2) x, y)."""
    h, w = img.shape[:2]
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    xy = np.rint(xy[np.isfinite(xy).all(-1)]).astype(np.int64)
    pts = (xy[:, None, :] + _TRIANGLE[None]).reshape(-1, 2)
    ok = ((pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0)
          & (pts[:, 1] < h))
    img[pts[ok, 1], pts[ok, 0]] = color


def viridis(x: np.ndarray) -> np.ndarray:
    """Map an array to uint8 RGB, scaled from its finite min to max."""
    x = np.asarray(x, np.float64)
    fin = np.isfinite(x)
    lo, hi = (x[fin].min(), x[fin].max()) if fin.any() else (0.0, 1.0)
    u = np.clip((np.where(fin, x, lo) - lo) / max(hi - lo, 1e-12), 0, 1)
    pos = u * (len(_VIRIDIS) - 1)
    i = np.minimum(pos.astype(np.int64), len(_VIRIDIS) - 2)
    f = (pos - i)[..., None]
    return np.rint(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(
        np.uint8)


def curves_figure(series, size=CURVE_SIZE) -> np.ndarray:
    """log(loss) polylines: `series` is a list of (values, colour name);
    a light grid of 10 x 5 cells, a black frame, a swatch per series at
    the top right in list order."""
    W, H = size
    m = 30
    img = np.full((H, W, 3), 255, np.uint8)
    logs = [np.log(np.clip(np.asarray(v, np.float64), 1e-12, None))
            for v, _ in series]
    fin = np.concatenate([x[np.isfinite(x)] for x in logs] + [np.zeros(0)])
    lo, hi = (fin.min(), fin.max()) if fin.size else (0.0, 1.0)
    if hi - lo < 1e-9:
        lo, hi = lo - 1.0, hi + 1.0
    n = max(max((len(x) for x in logs), default=1), 2)
    for gx in np.linspace(m, W - m, 11):
        draw_lines(img, [(gx, m)], [(gx, H - m)], GRID_RGB)
    for gy in np.linspace(m, H - m, 6):
        draw_lines(img, [(m, gy)], [(W - m, gy)], GRID_RGB)
    corners = np.array([(m, m), (W - m, m), (W - m, H - m), (m, H - m)])
    draw_lines(img, corners, np.roll(corners, -1, axis=0), RGB["k"])
    for x, (_, name) in zip(logs, series):
        px = m + np.arange(len(x)) * (W - 2 * m) / (n - 1)
        py = H - m - (x - lo) / (hi - lo) * (H - 2 * m)
        pts = np.stack([px, py], -1)
        if len(pts) == 1:
            draw_markers(img, pts, RGB[name])
        draw_lines(img, pts[:-1], pts[1:], RGB[name], width=2)
    for k, (_, name) in enumerate(series):
        x0 = W - m - 14 * (len(series) - k)
        img[m + 4:m + 14, x0:x0 + 10] = RGB[name]
    return img


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------

def _bodies(model, optvar, n_frames: int, block: int = 64):
    """Absolute vertices and AlphaPose joints (numpy, (F, N, V, 3) and
    (F, N, 17, 3)) of the first `n_frames` frames of an optvar dict:
    the SMPL forward on the model's device, `block` frames at a time,
    then scale and translation in numpy as the JAX package does."""
    poses = optvar["poses_smpl"][:n_frames]
    N = poses.shape[1]
    betas = np.ascontiguousarray(np.broadcast_to(
        optvar["betas_smpl"][:1], (min(block, n_frames), N, 10)),
        np.float32)
    verts, joints = [], []
    with torch.no_grad():
        for a in range(0, n_frames, block):
            p = poses[a:a + block]
            out = smpl_forward(
                model,
                torch.as_tensor(betas[:len(p)].reshape(-1, 10),
                                device=model.device),
                torch.as_tensor(np.asarray(p, np.float32).reshape(-1, 72),
                                device=model.device))
            verts.append(out["verts"].cpu().numpy().reshape(len(p), N, -1,
                                                            3))
            joints.append(out["joints_alphapose"].cpu().numpy().reshape(
                len(p), N, -1, 3))
    scale = optvar["scale_factor"][0]
    pT = optvar["poses_T"][:n_frames]
    return (scale * np.concatenate(verts) + pT,
            scale * np.concatenate(joints) + pT)


def _project(points: np.ndarray, K, device) -> np.ndarray:
    """(..., P, 3) camera points -> (..., P, 2) pixels, on `device`."""
    uv = project_points(
        torch.as_tensor(points.reshape(1, -1, 3), device=device),
        torch.as_tensor(np.asarray(K, np.float32), device=device))
    return uv.cpu().numpy().reshape(points.shape[:-1] + (2,))


# ---------------------------------------------------------------------------
# The exports
# ---------------------------------------------------------------------------

def save_visualization_init_data(output_path, seq, model, init_optvar,
                                 loss_2d, joints_thr=0.5, max_frames=25):
    """Init-stage loss curve and the first `max_frames` frame overlays."""
    write_png(os.path.join(output_path, "fig_optim_curves_init.png"),
              curves_figure([(loss_2d, INIT_CURVES[0][1])]))

    vis_path = os.path.join(output_path, "vis_init")
    os.makedirs(vis_path, exist_ok=True)
    n_f = min(seq.images.shape[0], max_frames)
    N = init_optvar["poses_smpl"].shape[1]
    v3d, j3d = _bodies(model, init_optvar, n_f)
    v2d_all = _project(v3d, seq.cam["K"], model.device)
    j2d_all = _project(j3d, seq.cam["K"], model.device)
    links = np.asarray(ALPHAPOSE_LINKS)

    for i in range(n_f):
        left, right = seq.images[i].copy(), seq.images[i].copy()
        ref2d = init_optvar["pose2d"][i]
        for n in range(N):
            c = RGB[PLOT_COLORS[n % len(PLOT_COLORS)]]
            blend_points(right, v2d_all[i, n], c, 0.05)
            p1, p2 = ref2d[n, links[:, 0]], ref2d[n, links[:, 1]]
            ok = (p1[:, 2] > joints_thr) & (p2[:, 2] > joints_thr)
            draw_lines(left, p1[ok, :2], p2[ok, :2], c, width=2)
            draw_markers(right, j2d_all[i, n], RGB["w"])
        write_png(os.path.join(vis_path, f"vis_{i:04d}.png"),
                  np.concatenate([left, right], axis=1))


def save_visualization_stage1(output_path, seq, model, stage1_optvar,
                              poses2d, log, max_overlays=20):
    """Stage-1 loss curves, the first `max_overlays` frame overlays and
    `visualization_data_stage1.pkl`."""
    write_png(
        os.path.join(output_path, "fig_optim_curves_stage1.png"),
        curves_figure([(np.asarray([v[key] for v in log], np.float64), c)
                       for key, c in STAGE1_CURVES]))

    vis_path = os.path.join(output_path, "vis_stage1")
    os.makedirs(vis_path, exist_ok=True)
    T = seq.images.shape[0]
    N = stage1_optvar["poses_smpl"].shape[1]
    v3d_all, j3d_all = _bodies(model, stage1_optvar, T)
    n_ov = min(T, max_overlays)
    j2d_all = _project(j3d_all[:n_ov], seq.cam["K"], model.device)
    v2d_all = _project(v3d_all[:n_ov], seq.cam["K"], model.device)

    # per-frame absolute depth from the de-normalized disparity
    min_z, max_z = stage1_optvar["min_z"], stage1_optvar["max_z"]
    depths = 1.0 / (seq.depths * (1.0 / min_z - 1.0 / max_z) + 1.0 / max_z)
    links = np.asarray(ALPHAPOSE_LINKS)
    for i in range(n_ov):
        left, mid = seq.images[i].copy(), seq.images[i].copy()
        for n in range(N):
            c = RGB[PLOT_COLORS[n % len(PLOT_COLORS)]]
            j2d = j2d_all[i, n]
            draw_lines(left, j2d[links[:, 0]], j2d[links[:, 1]], c, width=2)
            ref = poses2d[i, n]
            draw_markers(left, ref[ref[:, 2] > 0.5, :2], RGB["w"])
            blend_points(mid, v2d_all[i, n], c, 0.05)
        depth_rgb = viridis(np.log(np.clip(depths[i], 1e-3, None)))
        write_png(os.path.join(vis_path, f"vis_{i:04d}.png"),
                  np.concatenate([left, mid, depth_rgb], axis=1))

    vis_data = {
        "images": seq.images,
        "depths": depths,
        "backmasks": seq.backmasks,
        "cam_smpl": seq.cam_smpl,
        "cam": seq.cam,
        "verts": v3d_all,
        "valid": seq.valid_smpl,
        "pose2d": poses2d.copy(),
    }
    with open(os.path.join(output_path,
                           "visualization_data_stage1.pkl"), "wb") as f:
        pickle.dump(vis_data, f)

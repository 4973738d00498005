"""Plain reference of the stage-1 fit: init solve, cycle, refreshes.

Written from the semantics the port implements (the JAX package's
stage 1), in plain torch and numpy, with nothing of the port imported
or handed over: it derives its own time layout, person windows, padded
data, eroded masks, scene, filtered targets and raster from the
benchmark's inputs (or from a state it is given). One cycle:

  * from `warmup` on, the scene rebuild (masked temporal median of the
    de-normalized background depth, bilateral filter, Sobel outlier
    mask, median fill-in, unprojection) every cycle and the One-Euro
    refresh of the vertex-trajectory targets every `filter_every`;
  * the full-batch loss over frame chunks (a one-frame left halo for
    the temporal pairs): 2D keypoints, per-window log-disparity and
    silhouette terms on the raster of `raster.raster_window`, contact
    and foot sliding against the scene, pose / shape / velocity /
    target regularizers, and the scale term once per cycle;
  * one RMSprop step (decay 0.5, momentum 0.9, eps 1e-8, learning rate
    0.01 * 0.99**step).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .body import Body, project, skin
from .raster import raster_window

LEAVES = ("poses_T", "poses_smpl", "betas", "zmin_lin", "zmax_lin", "xscale")
PARTS = ("loss_pose24j", "loss_depth", "loss_silhouette", "reg_ref_poses",
         "reg_scale", "reg_contact", "reg_foot_sliding", "reg_vel",
         "reg_filter_verts")
BIG = 3.4e38


@dataclass(frozen=True)
class Layout:
    """The fit's static sizes, worked out from the inputs."""

    T: int
    N: int
    size: Tuple[int, int]     # the frame (W, H)
    chunk: int
    windows: Tuple[int, ...]
    coefs: Tuple[Tuple[str, float], ...]
    joint_thr: float = 0.5
    znear: float = 1.0
    eps: float = 1e-3
    min_delta_z: float = 1.0
    knn: int = 32
    contact_offset: float = 0.02
    contact_thr: float = 0.20
    frame_rate: float = 25.0
    min_cutoff2: float = 0.001
    beta2: float = 0.5
    filter_every: int = 25
    warmup: int = 30
    batch_size: int = 10
    blur_ndc: float = 2e-5

    @property
    def padded(self) -> int:
        return -(-self.T // self.chunk) * self.chunk

    @property
    def num_chunks(self) -> int:
        return self.padded // self.chunk

    @property
    def blur_px2(self) -> float:
        # NDC as PyTorch3D's: the short side spans [-1, 1]
        s = min(self.size) / 2.0
        return float(self.blur_ndc * s * s)

    def coef(self, k: str) -> float:
        return dict(self.coefs)[k]

    def groups(self):
        """People grouped by window, larger windows first."""
        return tuple((w, tuple(n for n in range(self.N)
                               if self.windows[n] == w))
                     for w in sorted(set(self.windows), reverse=True))


def time_chunk(T: int) -> int:
    """The frame chunk that pads T least (16..48, or 2..8 under 32
    frames), the larger on a tie."""
    cands = range(2, 9) if T < 32 else range(16, 49)
    return min(cands, key=lambda c: (-(-T // c) * c, -c))


def person_windows(pose2d: np.ndarray, size, base: int,
                   thr: float) -> Tuple[int, ...]:
    """Each person's raster window: the 99th percentile over frames of
    1.3x the bbox side of the confident keypoints, in multiples of 16
    from 48 px up to the short side of the frame `size` (W, H)."""
    W, H = size
    vis = pose2d[..., 2] > thr
    uv = pose2d[..., :2]
    big = np.float32(W + H)
    lo = np.min(np.where(vis[..., None], uv, big), axis=2)
    hi = np.max(np.where(vis[..., None], uv, -big), axis=2)
    extent = np.max(hi - lo, axis=-1)
    ok = np.sum(vis, axis=-1) >= 2
    cap = (min(W, H) // 16) * 16
    wins = []
    for n in range(pose2d.shape[1]):
        need = 1.3 * extent[ok[:, n], n]
        if need.size == 0:
            wins.append(min(max(48, -(-base // 16) * 16), cap))
            continue
        req = int(np.ceil(float(np.percentile(need, 99))))
        wins.append(min(max(48, -(-req // 16) * 16), cap))
    return tuple(wins)


class Data(NamedTuple):
    """The inputs on the device, padded to the layout's frames."""

    depths: torch.Tensor      # (Tp, H, W)
    seg: torch.Tensor         # (Tp, N, H, W) f32 {0, 1}
    seg_er: torch.Tensor      # (Tp, N, H, W) f32, 3x3 erosion twice
    backmask: torch.Tensor    # (Tp, H, W) bool
    pose2d: torch.Tensor      # (Tp, N, 17, 3)
    poses_ref: torch.Tensor   # (Tp, N, 72)
    valid_smpl: torch.Tensor  # (Tp, N, 1)
    frame_valid: torch.Tensor  # (Tp,)
    K: torch.Tensor           # (3, 3)
    betas_ref: torch.Tensor   # (1, N, 10)


def _pad(x: torch.Tensor, tp: int) -> torch.Tensor:
    if x.shape[0] == tp:
        return x
    return torch.cat([x, x.new_zeros((tp - x.shape[0],) + x.shape[1:])])


def erode(x, k: int = 3, iterations: int = 1):
    y = (x >= 0.5).to(torch.float32)
    lead = y.shape[:-2]
    y = y.reshape((-1, 1) + y.shape[-2:])
    for _ in range(iterations):
        y = -F.max_pool2d(-y, k, stride=1, padding=k // 2)
    return y.reshape(lead + y.shape[-2:])


def prepare(inputs: Dict[str, torch.Tensor], lay: Layout) -> Data:
    """Data from the benchmark's input tensors (the generator's)."""
    tp = lay.padded
    fv = torch.zeros(tp, device=inputs["depths"].device)
    fv[:lay.T] = 1.0
    seg = _pad((inputs["seg_mask"] > 0.5).to(torch.float32), tp)
    seg_er = torch.cat([erode(b, 3, 2) for b in torch.split(seg, lay.chunk)])
    return Data(
        depths=_pad(inputs["depths"].float(), tp), seg=seg, seg_er=seg_er,
        backmask=_pad(inputs["backmasks"] > 0.5, tp),
        pose2d=_pad(inputs["pose2d"].float(), tp),
        poses_ref=_pad(inputs["poses_smpl"].float(), tp),
        valid_smpl=_pad((inputs["valid_smpl"] > 0.7).float(), tp),
        frame_valid=fv, K=inputs["K"].float(),
        betas_ref=inputs["betas_smpl"].float().mean(0, keepdim=True))


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def decayed(init: float, rate: float, count: int) -> float:
    """init * rate**count in float32, as a float."""
    return float(torch.tensor(init, dtype=torch.float32) * torch.pow(
        torch.tensor(rate, dtype=torch.float32),
        torch.tensor(float(count), dtype=torch.float32)))


def rmsprop(params, grads, nu, trace, count: int):
    """One RMSprop step on tuples of tensors -> (params, nu, trace)."""
    lr = decayed(0.01, 0.99, count)
    out_p, out_nu, out_tr = [], [], []
    for p, g, n, tr in zip(params, grads, nu, trace):
        n = 0.5 * (g * g) + 0.5 * n
        upd = -lr * (g * torch.rsqrt(n + 1e-8))
        tr = upd + 0.9 * tr
        out_p.append(p + tr)
        out_nu.append(n)
        out_tr.append(tr)
    return tuple(out_p), tuple(out_nu), tuple(out_tr)


# ---------------------------------------------------------------------------
# Init solve
# ---------------------------------------------------------------------------

def init_solve(body: Body, inputs, lay: Layout, steps: int = 100):
    """Per-frame root translations from the confident 2D keypoints:
    Adam (b1 = b2 = 0.5, eps 1e-6, learning rate 0.5 * 0.95**step) on
    the mean squared reprojection error plus 0.05 x the squared frame
    differences, from (0, 0, 1). Returns the stage-1 start: a tuple in
    LEAVES order, padded."""
    T, N = lay.T, lay.N
    pose2d = inputs["pose2d"].float()
    poses = inputs["poses_smpl"].float()
    betas = inputs["betas_smpl"].float()
    K = inputs["K"].float()
    with torch.no_grad():
        joints = torch.cat([
            skin(body, b.reshape(-1, 10), p.reshape(-1, 72))[1]
            for b, p in zip(torch.split(betas, lay.chunk),
                            torch.split(poses, lay.chunk))]).reshape(
                                T, N, 17, 3)
    vis = (pose2d[..., 2:] > 0.15).float()
    gt = pose2d[..., :2]
    pT = torch.zeros((T, N, 1, 3), device=K.device)
    pT[..., 2] = 1.0
    mu, nu = torch.zeros_like(pT), torch.zeros_like(pT)
    for i in range(steps):
        p = pT.detach().requires_grad_(True)
        proj = project(joints + p, K)[..., :2]
        loss = (torch.mean(torch.square(vis * proj - vis * gt))
                + 0.05 * torch.sum(torch.square(p[1:] - p[:-1])))
        (g,) = torch.autograd.grad(loss, p)
        mu = 0.5 * g + 0.5 * mu
        nu = 0.5 * (g * g) + 0.5 * nu
        mh = mu / float(np.float32(1 - 0.5 ** (i + 1)))
        nh = nu / float(np.float32(1 - 0.5 ** (i + 1)))
        pT = pT - decayed(0.5, 0.95, i) * (mh / (torch.sqrt(nh) + 1e-6))
    tp = lay.padded
    max_z = torch.clamp(pT[..., 2:].amax(dim=1), min=2.0)
    dev = K.device
    return (_pad(pT, tp), _pad(poses, tp),
            betas.mean(0, keepdim=True),
            _pad(torch.ones_like(max_z), tp), _pad(2.0 * max_z, tp),
            torch.zeros((1, N, 1, 1), device=dev))


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------

def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def z_bounds(params, lay: Layout):
    min_z = softplus(params[3])
    return min_z, min_z.detach() + lay.min_delta_z + softplus(params[4])


def _unfold(x, k: int, fill: float):
    pad = k // 2
    xp = F.pad(x, (pad, pad, pad, pad), value=fill)
    H, W = x.shape[-2:]
    return torch.stack([xp[..., i:i + H, j:j + W] for i in range(k)
                        for j in range(k)], dim=-1)


def _median_sorted(sv, n, dim):
    lo = torch.gather(sv, dim, torch.clamp((n - 1) // 2, min=0).unsqueeze(dim))
    hi = torch.gather(sv, dim, (n // 2).unsqueeze(dim))
    return (0.5 * (lo + hi)).squeeze(dim)


def window_median(x, m, k: int):
    """Median of the valid values of each k x k window (the mean of the
    two middle ones), 0 where none is valid -> (median, any valid).
    Stable sort on a key where -0.0 equals 0.0."""
    vals = _unfold(x, k, 0.0)
    ok = _unfold(m, k, 0.0) > 0.5
    n = ok.sum(-1)
    vals = torch.where(ok, vals, torch.full_like(vals, BIG))
    key = torch.where(vals == 0, torch.zeros_like(vals), vals)
    order = torch.sort(key, dim=-1, stable=True).indices
    med = _median_sorted(torch.gather(vals, -1, order), n, -1)
    return torch.where(n > 0, med, torch.zeros_like(med)), n > 0


def fill_in(x, m, k: int, rounds: int = 64):
    """Fill the invalid pixels with their window median, round after
    round, until a round fills nothing."""
    x, m = x.clone(), m.clone()
    for _ in range(rounds):
        med, ok = window_median(x, m, k)
        new = (m < 0.5) & ok
        if not bool(new.any()):
            break
        x = torch.where(new, med, x)
        m = torch.where(new, torch.ones_like(m), m)
    return x


def sobel_mag(x):
    kx = torch.tensor([[-1., 0, 1], [-2, 0, 2], [-1, 0, 1]], device=x.device)
    w = torch.stack([kx, kx.T])[:, None]
    g = F.conv2d(F.pad(x[None, None], (1, 1, 1, 1), mode="reflect"), w)[0]
    return torch.abs(g[0]) + torch.abs(g[1])


def bilateral(x, d: int = 9, sigma_color: float = 0.05,
              sigma_space: float = 25.0):
    r = d // 2
    o = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)
    sw = torch.exp(-(o[:, None] ** 2 + o[None, :] ** 2)
                   / (2.0 * sigma_space ** 2)).reshape(-1)
    vals = _unfold(x, d, float("nan"))
    ok = ~torch.isnan(vals)
    vals = torch.nan_to_num(vals)
    w = sw * torch.exp(-torch.square(vals - x[..., None])
                       / (2.0 * sigma_color ** 2)) * ok
    return (w * vals).sum(-1) / torch.clamp(w.sum(-1), min=1e-8)


class Scene(NamedTuple):
    points: torch.Tensor   # (H*W, 3)
    valid: torch.Tensor    # (H*W,) bool
    depth: torch.Tensor    # (H, W)


@torch.no_grad()
def rebuild_scene(params, data: Data, lay: Layout) -> Scene:
    """The static scene from the current disparity de-normalization."""
    min_z, max_z = z_bounds(params, lay)
    depth = 1.0 / (data.depths * (1.0 / min_z - 1.0 / max_z) + 1.0 / max_z)
    ok = data.backmask & (data.frame_valid[:, None, None] > 0.5)
    sv = torch.sort(torch.where(ok, depth, torch.full_like(depth, BIG)),
                    dim=0).values
    n = ok.sum(0)
    med = torch.where(n > 0, _median_sorted(sv, n, 0), torch.zeros(
        (), device=depth.device))
    valid = (n > 0).float()
    disp_f = bilateral(1.0 / torch.clamp(med, 0.01, 100.0))
    dep = 1.0 / torch.clamp(disp_f, 0.01, 100.0)
    disp = 1.0 / torch.clamp(dep, 0.1, 100.0)

    def std(t):
        return torch.clamp(torch.std(t, correction=0), min=1e-8)
    gd, gz = sobel_mag(disp), sobel_mag(dep)
    g = gd / std(gd) + gz / std(gz)
    clean = erode(1.0 - (g > 3.0 * g.mean()).float(), 3, 2)
    post = fill_in(dep, clean * valid, 7)
    H, W = post.shape
    gy, gx = torch.meshgrid(torch.arange(H, device=post.device) + 0.5,
                            torch.arange(W, device=post.device) + 0.5,
                            indexing="ij")
    K = data.K
    xy = post[..., None] * (torch.stack([gx, gy], -1) - K[:2, 2]) \
        / torch.stack([K[0, 0], K[1, 1]])
    pts = torch.cat([xy, post[..., None]], -1).reshape(-1, 3)
    return Scene(pts, valid.reshape(-1) > 0.5, post)


def knn_mean(q, scene: Scene, k: int):
    """Mean of the k nearest valid scene points of each query (..., 3)."""
    flat = q.detach().reshape(-1, 3)
    out = []
    for b in torch.split(flat, 1024):
        d2 = torch.sum(torch.square(b[:, None] - scene.points[None]), -1)
        d2 = torch.where(scene.valid[None], d2,
                         torch.full((), float("inf"), device=d2.device))
        idx = torch.topk(d2, k, dim=-1, largest=False).indices
        ok = scene.valid[idx][..., None]
        pts = torch.where(ok, scene.points[idx], torch.zeros(
            (), device=d2.device))
        out.append(pts.sum(1) / torch.clamp(ok.sum(1), min=1))
    return torch.cat(out).reshape(q.shape)


# ---------------------------------------------------------------------------
# Filtered targets
# ---------------------------------------------------------------------------

def _alpha(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


@torch.no_grad()
def filtered_targets(params, body: Body, lay: Layout) -> torch.Tensor:
    """One-Euro ('ramp' time base) over each vertex trajectory; the
    per-frame differences of the filtered positions, as bfloat16
    (Tp, N, V, 3)."""
    scale = torch.pow(1.1, params[5])
    verts = torch.cat([_bodies(body, params[1][t0:t0 + lay.chunk], params[2],
                               scale, params[0][t0:t0 + lay.chunk])[0]
                       for t0 in range(0, lay.padded, lay.chunk)])
    diffs = [torch.zeros_like(verts[0])]
    x_prev, dx_prev, prev = verts[0], torch.zeros_like(verts[0]), verts[0]
    for t in range(1, lay.padded):
        t_e = torch.clamp(torch.tensor(float(t), dtype=torch.float32)
                          / lay.frame_rate, min=1e-6)
        a_d = _alpha(t_e, 1.0)
        dx_hat = a_d * ((verts[t] - x_prev) / t_e) + (1 - a_d) * dx_prev
        a = _alpha(t_e, lay.min_cutoff2 + lay.beta2 * torch.abs(dx_hat))
        xf = a * verts[t] + (1 - a) * x_prev
        x_prev, dx_prev = xf, dx_hat
        diffs.append(xf - prev)
        prev = xf
    return torch.stack(diffs).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

def _bodies(body: Body, poses, betas, scale, poses_T):
    C, N = poses.shape[:2]
    v, j = skin(body, betas.expand(C, N, 10).reshape(C * N, 10),
                poses.reshape(C * N, 72))
    return (scale * v.reshape(C, N, -1, 3) + poses_T,
            scale * j.reshape(C, N, -1, 3) + poses_T)


def _windows(imgs, origins, win: int):
    """imgs (C, M, H, W) or (C, H, W); origins (C, N, 2) -> (C, N, win,
    win) crops."""
    C, N = origins.shape[:2]
    ar = torch.arange(win, device=origins.device)
    rows = (origins[..., 1, None] + ar)[..., :, None]
    cols = (origins[..., 0, None] + ar)[..., None, :]
    c = torch.arange(C, device=imgs.device)[:, None, None, None]
    if imgs.ndim == 3:
        return imgs[c, rows, cols]
    n = torch.arange(N, device=imgs.device)[None, :, None, None]
    return imgs[c, n, rows, cols]


def _l1(x):
    return torch.where(x >= 0, x, -x)


def chunk_loss(params, i: int, body: Body, data: Data, scene, dvf,
               lay: Layout, work: Optional[list] = None):
    """Loss of frame chunk i and its parts (len(PARTS),); with `work`
    a list, each raster call appends (window, bodies, Work)."""
    C, N = lay.chunk, lay.N
    W, H = lay.size
    dev = data.K.device
    t0 = i * C
    hidx = torch.clamp(t0 - 1 + torch.arange(C + 1, device=dev), min=0)
    pT_h, ps_h = params[0][hidx], params[1][hidx]
    betas, scale = params[2], torch.pow(1.1, params[5])
    min_z, max_z = z_bounds(params, lay)
    c = slice(t0, t0 + C)
    fv_h = data.frame_valid[hidx]
    fv_c = fv_h[1:]
    gt = t0 + torch.arange(C, device=dev)
    pair_valid = fv_h[:-1] * fv_c * (gt > 0).float()
    seg_c, pose2d_c = data.seg[c], data.pose2d[c]

    verts_h, joints_h = _bodies(body, ps_h, betas, scale, pT_h)
    verts, joints = verts_h[1:], joints_h[1:]
    conf_ok = (pose2d_c[..., 2:] >= lay.joint_thr).float()
    pose2d_valid = (conf_ok.sum((2, 3)) >= 2).float()
    mask_valid = (seg_c.sum((2, 3)) >= 0.005 * H * W).float()
    fv = fv_c[:, None]
    K = data.K
    proj = project(joints, K)[..., :2]
    norm = torch.tensor([W, H], dtype=torch.float32, device=dev)
    loss_pose = torch.sum(torch.square(conf_ok * fv[..., None, None]
                                       * (proj - pose2d_c[..., :2]) / norm))
    target = data.depths[c] * (1.0 / min_z[c] - 1.0 / max_z[c]) \
        + 1.0 / max_z[c]

    z = pT_h[1:, :, 0, 2].detach()
    idx = torch.arange(N, device=dev)
    in_front = ((z[:, None, :] < z[:, :, None])
                | ((z[:, None, :] == z[:, :, None])
                   & (idx[None, None, :] < idx[None, :, None])))
    closer = torch.einsum("cpq,cqx->cpx", in_front.float(),
                          seg_c.reshape(C, N, -1)).reshape(C, N, H, W)
    keep_m = 1.0 - (closer > 0).float()
    n_keep = keep_m.sum((2, 3)) + 1.0
    seg_keep_total = (keep_m * seg_c).sum((2, 3))
    dw = pose2d_valid * fv
    sil_gate = mask_valid * pose2d_valid * fv

    loss_depth = torch.zeros((), device=dev)
    loss_sil = torch.zeros((), device=dev)
    for win, group in lay.groups():
        g = torch.tensor(group, device=dev)
        ng = len(group)
        zbuf, sil, origin, wk = raster_window(
            verts[:, g].reshape(C * ng, -1, 3), body.faces, K, win,
            (W, H), lay.znear, lay.blur_px2, count=work is not None)
        if work is not None:
            work.append((win, C * ng, wk))
        zbuf = zbuf.reshape(C, ng, win, win)
        sil = sil.reshape(C, ng, win, win)
        origins = origin.reshape(C, ng, 2)
        t_win = _windows(target, origins, win)
        er_win = _windows(data.seg_er[c][:, g], origins, win)
        zv = torch.isfinite(zbuf)
        zdisp = 1.0 / torch.clamp(torch.where(zv, zbuf, torch.ones_like(
            zbuf)) + 0.2, min=lay.eps)
        dmask = zv.float() * er_win * dw[:, g][..., None, None]
        npx = dmask.sum((2, 3)) + 1.0
        mp = (dmask * torch.log(torch.clamp(zdisp, min=lay.eps))).sum(
            (2, 3)) / npx
        mt = (dmask * torch.log(torch.clamp(t_win, min=lay.eps))).sum(
            (2, 3)) / npx
        loss_depth = loss_depth + torch.sum(torch.square(mp - mt))
        keep_w = _windows(keep_m[:, g], origins, win)
        seg_w = _windows(seg_c[:, g], origins, win)
        in_win = torch.square(keep_w * (sil - seg_w)).sum((2, 3))
        outside = seg_keep_total[:, g] - (keep_w * seg_w).sum((2, 3))
        loss_sil = loss_sil + torch.sum(sil_gate[:, g] * (in_win + outside)
                                        / n_keep[:, g])

    pT_c = pT_h[1:]
    pv = pair_valid[:, None, None, None]
    zero = torch.zeros((), device=dev)
    reg_contact = reg_fs = zero
    if scene is not None:
        li = torch.argmax(verts[..., 1], dim=-1)
        low = torch.gather(verts, -2, li[..., None, None].expand(C, N, 1, 3))
        cdist = (knn_mean(low, scene, lay.knn) - low)[..., 1:2]
        shift = torch.cat([torch.zeros_like(cdist),
                           cdist + lay.contact_offset,
                           torch.zeros_like(cdist)], -1)
        reg_contact = torch.sum(fv[..., None, None]
                                * _l1(pT_c - (pT_c + shift).detach()))
        in_contact = (cdist > -lay.contact_thr).float()
        li_h = torch.argmax(verts_h[..., 1], dim=-1)
        low_prev = torch.gather(verts_h[:-1], -2,
                                li_h[1:, :, None, None].expand(C, N, 1, 3))
        fs_gate = pv * in_contact
        reg_fs = (torch.sum(_l1(fs_gate * (low - low_prev)))
                  / torch.clamp(fs_gate.sum(), min=1.0))
    w_ref = data.valid_smpl[c] * fv[..., None]
    reg_ref = torch.sum(_l1(w_ref * (data.poses_ref[c] - ps_h[1:])))
    reg_ref = reg_ref + fv_c.sum() * torch.sum(_l1(betas - data.betas_ref))
    reg_filt = zero
    if dvf is not None:
        reg_filt = torch.sum(torch.square(
            pv * ((verts - verts_h[:-1]) - dvf[c].float())))
    reg_vel = torch.sum(torch.square(pv * (pT_h[1:] - pT_h[:-1])))
    co = lay.coef
    loss = (co("proj2d") * loss_pose + co("depth") * loss_depth
            + co("silhouette") * loss_sil + co("reg_poses") * reg_ref
            + co("reg_contact") * reg_contact
            + co("reg_foot_sliding") * reg_fs
            + co("reg_verts_filter") * reg_filt
            + co("reg_velocity") * reg_vel)
    parts = torch.stack([loss_pose, loss_depth, loss_sil, reg_ref, zero,
                         reg_contact, reg_fs, reg_vel, reg_filt])
    return loss, parts


def scale_reg(params, lay: Layout):
    """The per-person scale term, once per cycle, counted as the
    reference implementation's ceil(T / batch size) batches would ->
    (loss, logged)."""
    scale = torch.pow(1.1, params[5])
    nb = -(-lay.T // lay.batch_size)
    avg = torch.square(torch.sum(scale - 1.0))
    person = torch.mean(torch.square(scale - 1.0))
    rs = lay.coef("reg_scales")
    return nb * (rs * person + float(rs > 0) * avg), nb * (avg + person)


class State(NamedTuple):
    """The fit's state between cycles (tuples in LEAVES order)."""

    params: tuple
    nu: tuple
    trace: tuple
    count: int
    scene: Optional[Scene] = None
    dvf: Optional[torch.Tensor] = None


def start_state(params) -> State:
    zeros = tuple(torch.zeros_like(p) for p in params)
    return State(tuple(params), zeros, zeros, 0)


def cycle(st: State, c: int, body: Body, data: Data, lay: Layout,
          work: Optional[list] = None, chunks=None, loss_scale: float = 1.0):
    """Cycle c from state st -> (state, loss, parts, grads). `chunks`
    and `loss_scale` restrict the gradient to some chunks, scaled (a
    planted fault; the fit uses every chunk at scale 1)."""
    do_aux = c >= lay.warmup
    scene = rebuild_scene(st.params, data, lay) if do_aux else st.scene
    dvf = (filtered_targets(st.params, body, lay)
           if do_aux and c % lay.filter_every == 0 else st.dvf)
    leaves = [p.detach().requires_grad_(True) for p in st.params]
    total = torch.zeros((), device=data.K.device)
    parts = torch.zeros(len(PARTS), device=data.K.device)
    for i in (range(lay.num_chunks) if chunks is None else chunks):
        loss, p = chunk_loss(leaves, i, body, data, scene, dvf, lay, work)
        (loss_scale * loss).backward()
        total = total + loss_scale * loss.detach()
        parts = parts + loss_scale * p.detach()
    reg, logged = scale_reg(leaves, lay)
    reg.backward()
    total = total + reg.detach()
    parts[4] = logged.detach()
    grads = tuple(torch.zeros_like(p) if p.grad is None else p.grad
                  for p in leaves)
    with torch.no_grad():
        params, nu, trace = rmsprop(st.params, grads, st.nu, st.trace,
                                    st.count)
    return (State(params, nu, trace, st.count + 1, scene, dvf), total,
            parts, grads)

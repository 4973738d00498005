"""Two-stage space-time SMPL sequence optimizer.

Port of `mhmocap_tpu/engine/optimizer.py` (stage init + stage 1). The
JAX package runs one cycle as one jitted program; here a cycle is
eager PyTorch:

  * the full-batch gradient is accumulated chunk by chunk: each frame
    chunk's loss is built and `.backward()`-ed into the leaf parameters
    before the next chunk, so memory holds one chunk's graph (the JAX
    package scans the chunks under remat). The global scale term is
    added once per cycle;
  * the `lax.cond`s on the scene/filter refresh cadence and on the
    scene's existence become Python `if`s on host-side state computed
    from the cycle index, so the cycle reads nothing back from the
    device;
  * Adam (init solve) and RMSprop (stage 1) are written out by hand to
    match optax's update order exactly (`adam_update`,
    `rmsprop_update`); `torch.optim.RMSprop` with `ExponentialLR`
    differs once the learning rate decays.

The robust-profile branch (`gap_aware_temporal`) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.smpl import SMPLModel, smpl_forward
from ..ops.cameras import project_points, softplus
from ..ops.morphology import erode
from ..ops.one_euro import one_euro_filter, one_euro_step
from ..ops.rasterizer import RasterSettings, rasterize_bodies
from .scene import (ScenePointCloud, aggregate_scene_depth,
                    build_scene_pointcloud, contact_targets)


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineConfig:
    """Static configuration; fields as in the JAX package's
    EngineConfig (minus its remat switch: the port's per-chunk backward
    holds one chunk's graph at a time)."""

    image_size: Tuple[int, int]          # (W, H)
    num_people: int
    num_frames: int                      # real T (before padding)
    chunk: int = 16
    window: int = 128
    windows: Optional[Tuple[int, ...]] = None
    face_chunk: int = 128
    joint_confidence_thr: float = 0.5
    eps: float = 1e-3
    znear: float = 1.0
    zfar: float = 100.0
    min_delta_z: float = 1.0
    batch_size_ref: int = 10
    knn: int = 32
    contact_offset: float = 0.02
    contact_thr: float = 0.20
    frame_rate: float = 25.0
    min_cutoff2: float = 0.001
    beta2: float = 0.5
    update_filters_every: int = 25
    warmup_cycles: int = 30
    scene_update_every: int = 1
    cam_dist_coef: Optional[Tuple[float, ...]] = None
    pose17j_weights: Optional[Tuple[float, ...]] = None
    frame_bucket: int = 64
    gap_aware_temporal: bool = False

    def __post_init__(self):
        if self.gap_aware_temporal:
            raise NotImplementedError(
                "gap_aware_temporal (the robust profile) is not ported "
                "to mhmocap_tpu_torch yet")

    @property
    def padded_frames(self) -> int:
        b = -(-max(self.chunk, self.frame_bucket) // self.chunk)
        b = b * self.chunk
        return ((self.num_frames + b - 1) // b) * b

    @property
    def num_chunks(self) -> int:
        return self.padded_frames // self.chunk

    @property
    def person_windows(self) -> Tuple[int, ...]:
        if self.windows is None:
            return (self.window,) * self.num_people
        if len(self.windows) != self.num_people:
            raise ValueError("windows needs one entry per person")
        return self.windows

    @property
    def window_groups(self) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """Person indices grouped by window size, descending size."""
        pw = self.person_windows
        return tuple(
            (w, tuple(n for n in range(self.num_people) if pw[n] == w))
            for w in sorted(set(pw), reverse=True))

    def raster_settings_for_window(self, window: int) -> RasterSettings:
        return RasterSettings(
            image_size=self.image_size, window=window,
            face_chunk=self.face_chunk, znear=self.znear, zfar=self.zfar)


PARAM_NAMES = ("poses_T", "poses_smpl", "betas", "zmin_lin", "zmax_lin",
               "xscale")


class StageParams(NamedTuple):
    """Optimized variables. Tp = padded T."""

    poses_T: torch.Tensor      # (Tp, N, 1, 3)
    poses_smpl: torch.Tensor   # (Tp, N, 72)
    betas: torch.Tensor        # (1, N, 10)
    zmin_lin: torch.Tensor     # (Tp, 1, 1)
    zmax_lin: torch.Tensor     # (Tp, 1, 1)
    xscale: torch.Tensor       # (1, N, 1, 1) log_1.1 per-person scale


class SeqData(NamedTuple):
    """Per-sequence device data, padded to Tp frames."""

    depths: torch.Tensor       # (Tp, H, W) f32 normalized disparity
    seg_mask: torch.Tensor     # (Tp, N, H, W) bool
    seg_eroded: torch.Tensor   # (Tp, N, H, W) bool, k3 x2 erosion
    backmask: torch.Tensor     # (Tp, H, W) bool
    pose2d: torch.Tensor       # (Tp, N, 17, 3)
    poses_smpl_ref: torch.Tensor  # (Tp, N, 72)
    valid_smpl: torch.Tensor   # (Tp, N, 1)
    frame_valid: torch.Tensor  # (Tp,)
    cam_K: torch.Tensor        # (3, 3)
    stale_tn: torch.Tensor     # (Tp, N)


class StageAux(NamedTuple):
    """Non-optimized cycle state. have_scene / have_filters live on the
    host: they follow from the cycle index alone."""

    betas_ref: torch.Tensor          # (1, N, 10)
    scene: ScenePointCloud
    have_scene: bool
    verts_filt_diff: torch.Tensor    # (Tp, N, V, 3) bf16 targets
    have_filters: bool


class RMSpropState(NamedTuple):
    nu: StageParams
    trace: StageParams
    count: int


def normalize_joint_weights(w) -> np.ndarray:
    w = np.asarray(w, np.float32)
    return w * (len(w) / np.sum(w))


def _j17_weights(cfg: EngineConfig, device) -> Optional[torch.Tensor]:
    if cfg.pose17j_weights is None:
        return None
    return torch.as_tensor(normalize_joint_weights(cfg.pose17j_weights),
                           device=device)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at 0, as jnp.abs (torch.abs has 0 there).
    The L1 terms sit exactly at 0 on the first cycle (poses = their
    reference), so the choice shows in the gradient."""
    return torch.where(x >= 0, x, -x)


def _dist_coef(cfg: EngineConfig, device) -> Optional[torch.Tensor]:
    if cfg.cam_dist_coef is None:
        return None
    return torch.tensor(cfg.cam_dist_coef, dtype=torch.float32,
                        device=device)


def default_coefs() -> Dict[str, float]:
    """Loss coefficients as in configs/predict_mupots.yml."""
    return {
        "proj2d": 1.0, "depth": 0.05, "silhouette": 0.1,
        "reg_poses": 0.002, "reg_scales": 1e-4, "reg_velocity": 0.05,
        "reg_verts_filter": 0.002, "reg_contact": 0.001,
        "reg_foot_sliding": 0.01, "reg_gap_accel": 0.05,
    }


# ---------------------------------------------------------------------------
# Data preparation
# ---------------------------------------------------------------------------

def _pad_t(x: np.ndarray, tp: int) -> np.ndarray:
    pad = tp - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], 0)


def prepare_seq_data(seq, cfg: EngineConfig, device="cpu") -> SeqData:
    """SequenceArrays (host) -> SeqData (device, padded). The k3 x2
    erosion runs one chunk of frames at a time to bound its
    intermediates."""
    tp = cfg.padded_frames
    frame_valid = np.zeros((tp,), np.float32)
    frame_valid[:cfg.num_frames] = 1.0
    dev = torch.device(device)

    def put(a, dtype=None):
        x = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        return x if dtype is None else x.to(dtype)

    seg = put(_pad_t(seq.seg_mask > 0.5, tp))
    seg_er = torch.cat([
        erode(blk.to(torch.float32), kernel_size=3, iterations=2) > 0.5
        for blk in torch.split(seg, cfg.chunk, dim=0)], dim=0)
    stale = (np.zeros((cfg.num_frames, cfg.num_people), np.float32)
             if getattr(seq, "lagged_tn", None) is None
             else np.asarray(seq.lagged_tn, np.float32))
    return SeqData(
        depths=put(_pad_t(seq.depths.astype(np.float32), tp)),
        seg_mask=seg,
        seg_eroded=seg_er,
        backmask=put(_pad_t(seq.backmasks > 0.5, tp)),
        pose2d=put(_pad_t(seq.pose2d.astype(np.float32), tp)),
        poses_smpl_ref=put(_pad_t(seq.poses_smpl.astype(np.float32), tp)),
        valid_smpl=put(_pad_t((seq.valid_smpl > 0.7).astype(np.float32),
                              tp)),
        frame_valid=put(frame_valid),
        cam_K=put(seq.cam["K"].astype(np.float32)),
        stale_tn=put(_pad_t(stale, tp)),
    )


def empty_scene(cfg: EngineConfig, device="cpu") -> ScenePointCloud:
    W, H = cfg.image_size
    return ScenePointCloud(
        points=torch.zeros((H * W, 3), device=device),
        valid=torch.zeros((H * W,), dtype=torch.bool, device=device),
        depth=torch.zeros((H, W), device=device),
        depth_valid=torch.zeros((H, W), dtype=torch.bool, device=device))


def init_aux(cfg: EngineConfig, num_vertices: int,
             betas_ref: torch.Tensor) -> StageAux:
    dev = betas_ref.device
    return StageAux(
        betas_ref=betas_ref,
        scene=empty_scene(cfg, dev),
        have_scene=False,
        verts_filt_diff=torch.zeros(
            (cfg.padded_frames, cfg.num_people, num_vertices, 3),
            dtype=torch.bfloat16, device=dev),
        have_filters=False)


# ---------------------------------------------------------------------------
# Hand-written optimizers (optax semantics)
# ---------------------------------------------------------------------------

def _exp_decay(init: float, rate: float, count: int) -> torch.Tensor:
    """optax.exponential_decay(init, 1, rate) at `count`, in float32."""
    return init * torch.pow(torch.tensor(rate, dtype=torch.float32),
                            torch.tensor(float(count), dtype=torch.float32))


def adam_update(g, mu, nu, count: int, lr, b1: float, b2: float,
                eps: float):
    """optax.scale_by_adam (bias-corrected, eps outside the sqrt)
    followed by -lr. Returns (update, mu, nu)."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    k = count + 1
    mu_hat = mu / float(np.float32(1 - b1 ** k))
    nu_hat = nu / float(np.float32(1 - b2 ** k))
    upd = mu_hat / (torch.sqrt(nu_hat) + eps)
    return upd * (-lr).to(upd.device), mu, nu


def rmsprop_init(params: StageParams) -> RMSpropState:
    def zeros():
        return StageParams(*[torch.zeros_like(p) for p in params])
    return RMSpropState(nu=zeros(), trace=zeros(), count=0)


def rmsprop_update(grads: StageParams, state: RMSpropState,
                   params: StageParams, lr: float = 0.01,
                   decay: float = 0.5, momentum: float = 0.9,
                   gamma: float = 0.99, eps: float = 1e-8):
    """optax.rmsprop(exponential_decay(lr, 1, gamma), decay, eps,
    momentum): scale_by_rms (g * rsqrt(nu + eps), nu starting at 0),
    then -lr(count), then trace(momentum). Returns (params, state)."""
    step = -_exp_decay(lr, gamma, state.count)
    new_p, new_nu, new_tr = [], [], []
    for p, g, nu, tr in zip(params, grads, state.nu, state.trace):
        nu = (1 - decay) * (g * g) + decay * nu
        upd = torch.rsqrt(nu + eps) * g
        upd = upd * step.to(upd.device)
        tr = upd + momentum * tr
        new_p.append(p + tr)
        new_nu.append(nu)
        new_tr.append(tr)
    return StageParams(*new_p), RMSpropState(
        nu=StageParams(*new_nu), trace=StageParams(*new_tr),
        count=state.count + 1)


# ---------------------------------------------------------------------------
# Stage init: per-frame global translation solve
# ---------------------------------------------------------------------------

def init_global_poses(model: SMPLModel, pose2d, poses_smpl, betas_smpl,
                      cam_K, xscale, dist_coef=None,
                      proj2d_coef: float = 1.0,
                      reg_velocity_coef: float = 0.05,
                      num_iter: int = 100, joints_thr: float = 0.15,
                      pose_weights=None):
    """Per-frame 3D root translations from weighted 2D reprojection:
    Adam(exponential_decay(0.5, 1, 0.95), b1 = b2 = 0.5, eps 1e-6).
    The SMPL joints do not depend on poses_T and are computed once.
    Returns (poses_T (T, N, 1, 3), loss_2d history (num_iter,))."""
    T, N = pose2d.shape[:2]
    with torch.no_grad():
        out = smpl_forward(model, betas_smpl.reshape(T * N, -1),
                           poses_smpl.reshape(T * N, -1))
        joints = torch.pow(1.1, xscale) * out["joints_alphapose"].reshape(
            T, N, -1, 3)
    vis = (pose2d[..., 2:] > joints_thr).to(torch.float32)
    if pose_weights is not None:
        vis = vis * pose_weights[None, None, :, None]
    gt2d = pose2d[..., 0:2]

    poses_T = torch.tensor([0.0, 0.0, 1.0], device=pose2d.device).expand(
        T, N, 1, 3).contiguous()
    mu = torch.zeros_like(poses_T)
    nu = torch.zeros_like(poses_T)
    hist = []
    for i in range(num_iter):
        p = poses_T.detach().requires_grad_(True)
        proj = project_points(joints + p, cam_K, dist_coef=dist_coef)
        loss_2d = torch.mean(torch.square(vis * proj - vis * gt2d))
        speed = torch.sum(torch.square(p[1:] - p[:-1]))
        loss = proj2d_coef * loss_2d + reg_velocity_coef * speed
        (g,) = torch.autograd.grad(loss, p)
        upd, mu, nu = adam_update(g, mu, nu, i, _exp_decay(0.5, 0.95, i),
                                  0.5, 0.5, 1e-6)
        poses_T = poses_T + upd
        hist.append(loss_2d.detach())
    return poses_T, torch.stack(hist)


def init_params(model: SMPLModel, data_pose2d: np.ndarray,
                data_poses_smpl: np.ndarray, data_betas_smpl: np.ndarray,
                cam_K: np.ndarray, cfg: EngineConfig,
                scale_factor: Optional[np.ndarray] = None,
                num_iter: int = 100):
    """Initial StageParams on the model's device. Returns (params,
    init history (numpy), optimize_scale)."""
    dev = model.device
    T, N = data_pose2d.shape[:2]
    if scale_factor is not None:
        xs = (np.log(scale_factor) / np.log(1.1)).astype(np.float32)
        xscale = torch.as_tensor(xs[None, :, None, None], device=dev)
        optimize_scale = False
    else:
        xscale = torch.zeros((1, N, 1, 1), device=dev)
        optimize_scale = True

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    poses_T, hist = init_global_poses(
        model, put(data_pose2d), put(data_poses_smpl),
        put(data_betas_smpl), put(cam_K), xscale,
        dist_coef=_dist_coef(cfg, dev), num_iter=num_iter,
        pose_weights=_j17_weights(cfg, dev))
    poses_T = poses_T.cpu().numpy()

    max_z = np.clip(np.max(poses_T[..., 2:], axis=1), 2, None)
    avg_betas = np.mean(data_betas_smpl, axis=0, keepdims=True)
    tp = cfg.padded_frames
    params = StageParams(
        poses_T=put(_pad_t(poses_T.astype(np.float32), tp)),
        poses_smpl=put(_pad_t(data_poses_smpl.astype(np.float32), tp)),
        betas=put(avg_betas),
        zmin_lin=put(_pad_t(np.ones_like(max_z, np.float32), tp)),
        zmax_lin=put(_pad_t((2.0 * max_z).astype(np.float32), tp)),
        xscale=xscale,
    )
    return params, hist.cpu().numpy(), optimize_scale


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def scale_factor_of(params: StageParams) -> torch.Tensor:
    return torch.pow(1.1, params.xscale)


def z_bounds_of(params: StageParams, cfg: EngineConfig):
    """(min_z, max_z) (Tp, 1, 1); max_z = sg(min_z) + dz + sp(zmax_lin)."""
    min_z = softplus(params.zmin_lin)
    max_z = min_z.detach() + cfg.min_delta_z + softplus(params.zmax_lin)
    return min_z, max_z


def _smpl_bodies(model, poses, betas, scale, poses_T):
    """SMPL forward of an (F, N) block -> absolute verts and joints."""
    F, N = poses.shape[:2]
    out = smpl_forward(model, betas.expand(F, N, 10).reshape(F * N, 10),
                       poses.reshape(F * N, 72))
    verts = out["verts"].reshape(F, N, -1, 3)
    joints = out["joints_alphapose"].reshape(F, N, -1, 3)
    return scale * verts + poses_T, scale * joints + poses_T


def _window_index(origins, win):
    ar = torch.arange(win, device=origins.device)
    rows = origins[..., 1, None] + ar             # (C, N, win)
    cols = origins[..., 0, None] + ar
    return rows[..., :, None], cols[..., None, :]


def _gather_windows(imgs, origins, win):
    """imgs (C, N, H, W), origins (C, N, 2) -> (C, N, win, win)."""
    C, N = origins.shape[:2]
    rows, cols = _window_index(origins, win)
    c = torch.arange(C, device=imgs.device)[:, None, None, None]
    n = torch.arange(N, device=imgs.device)[None, :, None, None]
    return imgs[c, n, rows, cols]


def _gather_windows_shared(img_c, origins, win):
    """One image per frame shared by all people: img_c (C, H, W),
    origins (C, N, 2) -> (C, N, win, win)."""
    C = origins.shape[0]
    rows, cols = _window_index(origins, win)
    c = torch.arange(C, device=img_c.device)[:, None, None, None]
    return img_c[c, rows, cols]


# ---------------------------------------------------------------------------
# The per-chunk loss
# ---------------------------------------------------------------------------

LOG_KEYS = ("loss_pose24j", "loss_depth", "loss_silhouette",
            "reg_ref_poses", "reg_scale", "reg_contact",
            "reg_foot_sliding", "reg_vel", "reg_filter_verts",
            "reg_gap_accel")


class ChunkInputs(NamedTuple):
    """One frame chunk [t0, t0+C) with a 1-frame left halo on *_h."""

    poses_T_h: torch.Tensor       # (C+1, N, 1, 3)
    poses_smpl_h: torch.Tensor    # (C+1, N, 72)
    min_z_c: torch.Tensor         # (C, 1, 1)
    max_z_c: torch.Tensor         # (C, 1, 1)
    depths_c: torch.Tensor        # (C, H, W)
    seg_c: torch.Tensor           # (C, N, H, W) f32
    seg_er_c: torch.Tensor        # (C, N, H, W) f32
    pose2d_c: torch.Tensor        # (C, N, 17, 3)
    ref_poses_c: torch.Tensor     # (C, N, 72)
    valid_smpl_c: torch.Tensor    # (C, N, 1)
    frame_valid_h: torch.Tensor   # (C+1,)
    global_t: torch.Tensor        # (C,)
    dvf_c: torch.Tensor           # (C, N, V, 3) bf16


def _slice_chunk(params: StageParams, data: SeqData, aux: StageAux,
                 cfg: EngineConfig, chunk_idx: int) -> ChunkInputs:
    C = cfg.chunk
    t0 = chunk_idx * C
    dev = params.poses_T.device
    halo_idx = torch.clamp(t0 - 1 + torch.arange(C + 1, device=dev), min=0)
    c = slice(t0, t0 + C)
    min_z, max_z = z_bounds_of(params, cfg)
    return ChunkInputs(
        poses_T_h=params.poses_T[halo_idx],
        poses_smpl_h=params.poses_smpl[halo_idx],
        min_z_c=min_z[c],
        max_z_c=max_z[c],
        depths_c=data.depths[c],
        seg_c=data.seg_mask[c].to(torch.float32),
        seg_er_c=data.seg_eroded[c].to(torch.float32),
        pose2d_c=data.pose2d[c],
        ref_poses_c=data.poses_smpl_ref[c],
        valid_smpl_c=data.valid_smpl[c],
        frame_valid_h=data.frame_valid[halo_idx],
        global_t=t0 + torch.arange(C, device=dev),
        dvf_c=aux.verts_filt_diff[c],
    )


def _chunk_loss_core(chunk: ChunkInputs, model: SMPLModel, betas, scale,
                     cam_K, aux: StageAux, coefs: Dict[str, float],
                     cfg: EngineConfig):
    """Loss of one frame chunk -> (scalar loss, parts (10,)). Covers the
    per-frame terms and the chunk's (t-1, t) temporal pairs, so the
    total over chunks counts every consecutive pair once."""
    C, N = cfg.chunk, cfg.num_people
    W, H = cfg.image_size
    dev = cam_K.device
    f32 = torch.float32

    poses_T_h, poses_smpl_h = chunk.poses_T_h, chunk.poses_smpl_h
    min_z_c, max_z_c = chunk.min_z_c, chunk.max_z_c
    depths_c, seg_c = chunk.depths_c, chunk.seg_c
    pose2d_c, ref_poses_c = chunk.pose2d_c, chunk.ref_poses_c
    valid_smpl_c = chunk.valid_smpl_c
    frame_valid_h = chunk.frame_valid_h
    frame_valid_c = frame_valid_h[1:]
    pair_valid = (frame_valid_h[:-1] * frame_valid_c
                  * (chunk.global_t > 0).to(f32))

    verts_abs_h, joints_abs_h = _smpl_bodies(
        model, poses_smpl_h, betas, scale, poses_T_h)
    verts_abs = verts_abs_h[1:]
    joints_abs = joints_abs_h[1:]

    conf_ok = (pose2d_c[..., 2:] >= cfg.joint_confidence_thr).to(f32)
    pose2d_valid = (torch.sum(conf_ok, dim=(2, 3)) >= 2).to(f32)
    mask_valid = (torch.sum(seg_c, dim=(2, 3)) >= 0.005 * H * W).to(f32)
    fv = frame_valid_c[:, None]

    # 2D keypoint loss
    proj = project_points(joints_abs, cam_K, dist_coef=_dist_coef(cfg, dev))
    norm = torch.tensor([W, H], dtype=f32, device=dev)
    w2d = conf_ok * fv[..., None, None]
    jw = _j17_weights(cfg, dev)
    if jw is not None:
        w2d = w2d * jw[None, None, :, None]
    loss_pose = torch.sum(torch.square(w2d * (proj - pose2d_c[..., :2])
                                       / norm))

    target_disp = (depths_c * (1.0 / min_z_c - 1.0 / max_z_c)
                   + 1.0 / max_z_c)

    # occlusion keep masks: person q in front of p (z, then index)
    z = poses_T_h[1:, :, 0, 2].detach()
    idx = torch.arange(N, device=dev)
    in_front = ((z[:, None, :] < z[:, :, None])
                | ((z[:, None, :] == z[:, :, None])
                   & (idx[None, None, :] < idx[None, :, None])))
    closer = torch.einsum("cpq,cqx->cpx", in_front.to(f32),
                          seg_c.reshape(C, N, -1)).reshape(C, N, H, W)
    keep = 1.0 - (closer > 0).to(f32)
    n_keep = torch.sum(keep, dim=(2, 3)) + 1.0
    seg_keep_total = torch.sum(keep * seg_c, dim=(2, 3))
    dw = pose2d_valid * fv
    sil_gate = mask_valid * pose2d_valid * fv

    loss_depth = torch.zeros((), device=dev)
    loss_sil = torch.zeros((), device=dev)
    for win, group in cfg.window_groups:
        g = torch.as_tensor(group, device=dev)
        ng = len(group)
        raster = rasterize_bodies(
            verts_abs[:, g].reshape(C * ng, -1, 3), model.faces, cam_K,
            cfg.raster_settings_for_window(win))
        zbuf = raster["zbuf"].reshape(C, ng, win, win)
        sil = raster["sil"].reshape(C, ng, win, win)
        origins = raster["origin"].reshape(C, ng, 2)

        target_win = _gather_windows_shared(target_disp, origins, win)
        seg_er_win = _gather_windows(chunk.seg_er_c[:, g], origins, win)
        zbuf_valid = torch.isfinite(zbuf)
        zbuf_safe = torch.where(zbuf_valid, zbuf, torch.ones_like(zbuf))
        zbuf_disp = 1.0 / torch.clamp(zbuf_safe + 0.2, min=cfg.eps)
        dmask = (zbuf_valid.to(f32) * seg_er_win
                 * dw[:, g][..., None, None])
        n_pix = torch.sum(dmask, dim=(2, 3)) + 1.0
        mean_pred = torch.sum(
            dmask * torch.log(torch.clamp(zbuf_disp, min=cfg.eps)),
            dim=(2, 3)) / n_pix
        mean_true = torch.sum(
            dmask * torch.log(torch.clamp(target_win, min=cfg.eps)),
            dim=(2, 3)) / n_pix
        loss_depth = loss_depth + torch.sum(
            torch.square(mean_pred - mean_true))

        keep_win = _gather_windows(keep[:, g], origins, win)
        seg_win = _gather_windows(seg_c[:, g], origins, win)
        in_win = torch.sum(torch.square(keep_win * (sil - seg_win)),
                           dim=(2, 3))
        seg_keep_win = torch.sum(keep_win * seg_win, dim=(2, 3))
        outside = seg_keep_total[:, g] - seg_keep_win
        loss_sil = loss_sil + torch.sum(
            sil_gate[:, g] * (in_win + outside) / n_keep[:, g])

    # contact + foot sliding, only once the scene exists
    poses_T_c = poses_T_h[1:]
    pv = pair_valid[:, None, None, None]
    if aux.have_scene:
        low, cdist, target_T = contact_targets(
            verts_abs, poses_T_c, aux.scene, k=cfg.knn,
            offset=cfg.contact_offset)
        reg_contact = torch.sum(fv[..., None, None]
                                * _abs(poses_T_c - target_T))
        in_contact = (cdist > -cfg.contact_thr).to(f32)
        idx_low = torch.argmax(verts_abs_h[..., 1], dim=-1)
        low_tm1 = torch.gather(
            verts_abs_h[:-1], -2,
            idx_low[1:, :, None, None].expand(C, N, 1, 3))
        fs_gate = pv * in_contact
        fs_num = torch.sum(_abs(fs_gate * (low - low_tm1)))
        fs_den = torch.clamp(torch.sum(fs_gate), min=1.0)
        reg_foot_sliding = fs_num / fs_den
    else:
        reg_contact = torch.zeros((), device=dev)
        reg_foot_sliding = torch.zeros((), device=dev)

    w_ref = valid_smpl_c * fv[..., None]
    reg_ref = torch.sum(_abs(w_ref * (ref_poses_c - poses_smpl_h[1:])))
    reg_ref = reg_ref + torch.sum(frame_valid_c) * torch.sum(
        _abs(betas - aux.betas_ref))

    dvf = chunk.dvf_c.to(f32)
    gv_diff = verts_abs - verts_abs_h[:-1]
    if aux.have_filters:
        reg_filter_verts = torch.sum(torch.square(pv * (gv_diff - dvf)))
    else:
        reg_filter_verts = torch.zeros((), device=dev)

    reg_vel = torch.sum(torch.square(pv * (poses_T_h[1:] - poses_T_h[:-1])))
    reg_gap_accel = torch.zeros((), device=dev)

    loss = (coefs["proj2d"] * loss_pose
            + coefs["depth"] * loss_depth
            + coefs["silhouette"] * loss_sil
            + coefs["reg_poses"] * reg_ref
            + coefs["reg_contact"] * reg_contact
            + coefs["reg_foot_sliding"] * reg_foot_sliding
            + coefs["reg_verts_filter"] * reg_filter_verts
            + coefs["reg_velocity"] * reg_vel)
    parts = torch.stack([loss_pose, loss_depth, loss_sil, reg_ref,
                         torch.zeros((), device=dev), reg_contact,
                         reg_foot_sliding, reg_vel, reg_filter_verts,
                         reg_gap_accel])
    return loss, parts


def _scale_reg(params: StageParams, coefs, cfg: EngineConfig):
    """Scale regularization, once per cycle, scaled to the reference's
    per-batch accounting (ceil(T / batch_size) batches)."""
    scale = scale_factor_of(params)
    n_batches = -(-cfg.num_frames // cfg.batch_size_ref)
    reg_scale_avg = torch.square(torch.sum(scale - 1.0))
    reg_scale_person = torch.mean(torch.square(scale - 1.0))
    loss = n_batches * (coefs["reg_scales"] * reg_scale_person
                        + float(coefs["reg_scales"] > 0) * reg_scale_avg)
    logged = n_batches * (reg_scale_avg + reg_scale_person)
    return loss, logged


def cycle_loss_and_grads(params: StageParams, model: SMPLModel,
                         data: SeqData, aux: StageAux, coefs,
                         cfg: EngineConfig):
    """Full-sequence loss, its log parts and its gradient. Each chunk's
    loss is back-propagated before the next chunk is built, so the
    gradient accumulates in the leaf copies of `params` while memory
    holds one chunk's graph. Returns (loss, parts, grads); loss and
    parts stay on the device."""
    leaves = StageParams(*[p.detach().requires_grad_(True) for p in params])
    dev = leaves.poses_T.device
    total = torch.zeros((), device=dev)
    parts = torch.zeros((len(LOG_KEYS),), device=dev)
    for i in range(cfg.num_chunks):
        chunk = _slice_chunk(leaves, data, aux, cfg, i)
        loss, p = _chunk_loss_core(chunk, model, leaves.betas,
                                   scale_factor_of(leaves), data.cam_K,
                                   aux, coefs, cfg)
        loss.backward()
        total = total + loss.detach()
        parts = parts + p.detach()
    reg, logged = _scale_reg(leaves, coefs, cfg)
    reg.backward()
    total = total + reg.detach()
    parts[4] = logged.detach()
    grads = StageParams(*[torch.zeros_like(p) if p.grad is None else p.grad
                          for p in leaves])
    return total, parts, grads


# ---------------------------------------------------------------------------
# Cycle step + auxiliary updates
# ---------------------------------------------------------------------------

def grad_step(params: StageParams, opt_state: RMSpropState, model, data,
              aux, coefs, cfg: EngineConfig, optimize_scale: bool):
    loss, parts, grads = cycle_loss_and_grads(params, model, data, aux,
                                              coefs, cfg)
    if not optimize_scale:
        grads = grads._replace(xscale=torch.zeros_like(grads.xscale))
    with torch.no_grad():
        params, opt_state = rmsprop_update(grads, opt_state, params)
    return params, opt_state, loss, parts


@torch.no_grad()
def update_scene(params: StageParams, data: SeqData,
                 cfg: EngineConfig) -> ScenePointCloud:
    """Rebuild the static scene point cloud from the current disparity
    de-normalization."""
    min_z, max_z = z_bounds_of(params, cfg)
    valid = data.backmask & (data.frame_valid[:, None, None] > 0.5)
    med, ok = aggregate_scene_depth(data.depths, valid, min_z, max_z)
    return build_scene_pointcloud(med, ok, data.cam_K, use_bilateral=True)


@torch.no_grad()
def update_filtered_targets(params: StageParams, model: SMPLModel,
                            cfg: EngineConfig) -> torch.Tensor:
    """One-Euro-filter the absolute vertex trajectories ('ramp' time
    base, min_cutoff2/beta2) and return the per-frame filtered
    differences (Tp, N, V, 3) in bf16, chunk by chunk with the filter
    state carried across chunks."""
    C = cfg.chunk
    scale = scale_factor_of(params)
    diffs = []
    state, prev = None, None
    for i in range(cfg.num_chunks):
        t0 = i * C
        v, _ = _smpl_bodies(model, params.poses_smpl[t0:t0 + C],
                            params.betas, scale, params.poses_T[t0:t0 + C])
        if prev is None:
            prev = torch.zeros_like(v[0])
        for k in range(C):
            t, x = t0 + k, v[k]
            if t == 0:
                state, xf = (x, torch.zeros_like(x)), x
                diffs.append(torch.zeros_like(x))
            else:
                # t_e as a float32 scalar, like the JAX package's
                # t.astype(f32) / frame_rate
                te = torch.clamp(torch.tensor(float(t), dtype=torch.float32)
                                 / cfg.frame_rate, min=1e-6)
                state, xf = one_euro_step(state, x, te, cfg.min_cutoff2,
                                          cfg.beta2)
                diffs.append(xf - prev)
            prev = xf
    return torch.stack(diffs).to(torch.bfloat16)


def fused_aux_refresh(params: StageParams, aux: StageAux, cycle_idx: int,
                      model: SMPLModel, data: SeqData,
                      cfg: EngineConfig) -> StageAux:
    """The scene rebuild (every `scene_update_every` cycles from
    `warmup_cycles`) and the One-Euro target refresh (every
    `update_filters_every`), decided on the host from the cycle index."""
    do_aux = cycle_idx >= cfg.warmup_cycles
    do_scene = do_aux and cycle_idx % cfg.scene_update_every == 0
    do_filt = do_aux and cycle_idx % cfg.update_filters_every == 0
    scene = update_scene(params, data, cfg) if do_scene else aux.scene
    dvf = (update_filtered_targets(params, model, cfg) if do_filt
           else aux.verts_filt_diff)
    return aux._replace(scene=scene,
                        have_scene=aux.have_scene or do_scene,
                        verts_filt_diff=dvf,
                        have_filters=aux.have_filters or do_filt)


def stage1_cycle_fused(params: StageParams, opt_state: RMSpropState,
                       aux: StageAux, cycle_idx: int, model: SMPLModel,
                       data: SeqData, coefs, cfg: EngineConfig,
                       optimize_scale: bool = True):
    """One production cycle: the conditional aux refreshes, then the
    full-batch gradient and one RMSprop update. Returns (params,
    opt_state, aux, loss, parts); loss and parts stay on the device."""
    aux = fused_aux_refresh(params, aux, cycle_idx, model, data, cfg)
    params, opt_state, loss, parts = grad_step(
        params, opt_state, model, data, aux, coefs, cfg, optimize_scale)
    return params, opt_state, aux, loss, parts


@torch.no_grad()
def get_filtered_vertices(params: StageParams, model: SMPLModel,
                          cfg: EngineConfig, min_cutoff_T: float = 0.004,
                          min_cutoff_angles: float = 0.1,
                          beta_T: float = 0.7, beta_angles: float = 0.1):
    """Final-output smoothing: One-Euro-filter poses_T and the pose
    angles ('uniform' time base), then rebuild absolute vertices
    (Tp, N, V, 3)."""
    poses_T_f = one_euro_filter(params.poses_T, min_cutoff=min_cutoff_T,
                                beta=beta_T, frame_rate=cfg.frame_rate,
                                dt_mode="uniform")
    poses_f = one_euro_filter(params.poses_smpl,
                              min_cutoff=min_cutoff_angles,
                              beta=beta_angles, frame_rate=cfg.frame_rate,
                              dt_mode="uniform")
    scale = scale_factor_of(params)
    C = cfg.chunk
    verts = [_smpl_bodies(model, poses_f[t0:t0 + C], params.betas, scale,
                          poses_T_f[t0:t0 + C])[0]
             for t0 in range(0, cfg.padded_frames, C)]
    return torch.cat(verts, dim=0)


def get_optimized_variables(params: StageParams, cfg: EngineConfig,
                            data_valid_smpl: np.ndarray,
                            scene: Optional[Dict] = None) -> Dict:
    """The optvar dict with the reference's pickle schema, unpadded to
    the real T."""
    T = cfg.num_frames
    with torch.no_grad():
        min_z, max_z = z_bounds_of(params, cfg)
        host = lambda x: x.detach().cpu().numpy()
        out = {
            "scale_factor": host(scale_factor_of(params)),
            "poses_T": host(params.poses_T)[:T],
            "poses_smpl": host(params.poses_smpl)[:T],
            "betas_smpl": host(params.betas),
            "valid_smpl": np.asarray(data_valid_smpl)[:T],
            "min_z": host(min_z)[:T],
            "max_z": host(max_z)[:T],
            "scene_depth": None,
            "scene_img": None,
            "scene_mask": None,
        }
    if scene:
        out.update(scene)
    return out

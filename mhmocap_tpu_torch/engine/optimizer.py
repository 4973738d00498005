"""Two-stage space-time SMPL sequence optimizer.

Port of `mhmocap_tpu/engine/optimizer.py` (stage init + stage 1). The
JAX package runs one cycle as one jitted program; here a cycle is
written as eager PyTorch (`stage1_cycle_eager`), and on the card it runs
as one replay of a CUDA graph captured over static state
(`engine/cycle_graph.py`; `stage1_cycle{,s}_fused` dispatch there on
CUDA tensors). In the cycle:

  * the full-batch gradient is accumulated chunk by chunk: each frame
    chunk's loss is built and `.backward()`-ed into the leaf parameters
    before the next chunk, so memory holds one chunk's graph (the JAX
    package scans the chunks under remat). The global scale term is
    added once per cycle;
  * the `lax.cond`s on the scene/filter refresh cadence and on the
    scene's existence become Python `if`s on host-side state computed
    from the cycle index (`refresh_flags`), so the cycle reads nothing
    back from the device, and the constants it reads are built once per
    device, so it copies nothing to it after its first call;
  * Adam (init solve) and RMSprop (stage 1) are written out by hand to
    match optax's update order exactly (`adam_update`,
    `rmsprop_update`); `torch.optim.RMSprop` with `ExponentialLR`
    differs once the learning rate decays. Their learning rates come
    from tables uploaded once (`exp_decay_table`), indexed by a Python
    or a device step count.

`EngineConfig.gap_aware_temporal` (the robust profile) widens the chunk
halo to 2 frames, drops the temporal pairs with a stale endpoint,
releases the 2D term on stale frames and adds `reg_gap_accel`, as the
JAX package does; with the flag off the cycle is unchanged.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.smpl import SMPLModel, smpl_forward
from ..ops.cameras import project_points, softplus
from ..ops.morphology import erode
from ..ops.one_euro import one_euro_filter, one_euro_step
from ..ops.rasterizer import RasterSettings, rasterize_bodies
from ..ops.window_loss import window_losses
from ..spans import span
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
    # the robust profile: stale-aware temporal terms (needs
    # SeqData.stale_tn; clean sequences are unchanged)
    gap_aware_temporal: bool = False

    @property
    def halo(self) -> int:
        """Left-halo frames per chunk: 1 for the pair terms, 2 for the
        gap acceleration stencil."""
        return 2 if self.gap_aware_temporal else 1

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


# The constants a cycle or the init solve reads are built once per
# (value, device) by the cached helpers below: after a body's first
# call nothing is copied from the host, so the body can be captured in
# a CUDA graph (engine/cycle_graph.py), and the eager path does not
# synchronize on the copies either. The caches are never evicted: a
# captured graph reads each tensor at its address for as long as it
# lives.

def _j17_weights(cfg: EngineConfig, device) -> Optional[torch.Tensor]:
    if cfg.pose17j_weights is None:
        return None
    return _on_device(tuple(normalize_joint_weights(cfg.pose17j_weights)),
                      torch.float32, torch.device(device))


@functools.cache
def _on_device(values: Tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at 0, as jnp.abs (torch.abs has 0 there).
    The L1 terms sit exactly at 0 on the first cycle (poses = their
    reference), so the choice shows in the gradient."""
    return torch.where(x >= 0, x, -x)


def _dist_coef(cfg: EngineConfig, device) -> Optional[torch.Tensor]:
    if cfg.cam_dist_coef is None:
        return None
    return _on_device(tuple(cfg.cam_dist_coef), torch.float32,
                      torch.device(device))


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


@span("prepare_seq_data")
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


@span("init_aux")
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


def schedule_len(steps: int) -> int:
    """The length of the schedule tables that cover steps [0, steps): a
    power of two, at least 256, so that few tables are ever built."""
    return max(256, 1 << (max(int(steps), 1) - 1).bit_length())


@functools.cache
def exp_decay_table(init: float, rate: float, length: int,
                    device) -> torch.Tensor:
    """`_exp_decay(init, rate, c)` for c in [0, length) on `device`: each
    entry computed on the host exactly as `_exp_decay` computes it
    (torch's vectorized pow rounds differently), uploaded once."""
    return torch.stack([_exp_decay(init, rate, c)
                        for c in range(length)]).to(device)


def _decayed(init: float, rate: float, count, device,
             steps: Optional[int] = None) -> torch.Tensor:
    """exponential_decay(init, 1, rate) at `count` on `device`, read from
    `exp_decay_table`: at a Python count its entry (a view of a table
    long enough for it), at a device count (an int64 tensor) a (1,)
    gather from the table that covers `steps` steps. Neither copies to
    the device nor synchronizes after the table is built."""
    if torch.is_tensor(count):
        table = exp_decay_table(init, rate, schedule_len(steps),
                                torch.device(device))
        return table.index_select(0, count.reshape(1))
    return exp_decay_table(init, rate, schedule_len(count + 1),
                           torch.device(device))[count]


@functools.cache
def adam_bias_table(b: float, length: int, device) -> torch.Tensor:
    """Adam's bias correction 1 - b**(c + 1) for c in [0, length), as
    float32, in the form `_unbias` applies it on `device`: the divisor
    on the CPU, its float32 reciprocal on CUDA."""
    d = np.asarray([1 - b ** (c + 1) for c in range(length)], np.float32)
    if torch.device(device).type == "cuda":
        d = np.float32(1) / d
    return torch.from_numpy(d).to(device)


def _unbias(x, b: float, count, steps: Optional[int]) -> torch.Tensor:
    """x / (1 - b**(count + 1)), the divisor rounded to float32, as torch
    divides a tensor by a Python float: on CUDA x times the divisor's
    float32 reciprocal, on the CPU a true division. At a device count
    the divisor or reciprocal is gathered from `adam_bias_table`, so
    both counts give the same bits."""
    if not torch.is_tensor(count):
        return x / float(np.float32(1 - b ** (count + 1)))
    r = adam_bias_table(b, schedule_len(steps), x.device).index_select(
        0, count.reshape(1))
    return x * r if x.is_cuda else x / r


def adam_update(g, mu, nu, count, lr, b1: float, b2: float, eps: float,
                steps: Optional[int] = None):
    """optax.scale_by_adam (bias-corrected, eps outside the sqrt)
    followed by -lr. `count` is a Python int or an int64 device count
    whose tables cover `steps` steps. Returns (update, mu, nu)."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    mu_hat = _unbias(mu, b1, count, steps)
    nu_hat = _unbias(nu, b2, count, steps)
    upd = mu_hat / (torch.sqrt(nu_hat) + eps)
    return upd * (-lr).to(upd.device), mu, nu


def rmsprop_init(params: StageParams) -> RMSpropState:
    def zeros():
        return StageParams(*[torch.zeros_like(p) for p in params])
    return RMSpropState(nu=zeros(), trace=zeros(), count=0)


def rmsprop_update(grads: StageParams, state: RMSpropState,
                   params: StageParams, lr: float = 0.01,
                   decay: float = 0.5, momentum: float = 0.9,
                   gamma: float = 0.99, eps: float = 1e-8,
                   steps: Optional[int] = None):
    """optax.rmsprop(exponential_decay(lr, 1, gamma), decay, eps,
    momentum): scale_by_rms (g * rsqrt(nu + eps), nu starting at 0),
    then -lr(count), then trace(momentum). `state.count` is a Python int
    or, in the static state, an int64 device tensor whose schedule table
    covers `steps` steps; without `steps` (the eager cycle handed a
    static state) a device count is read back. Returns (params,
    state)."""
    if torch.is_tensor(state.count) and steps is None:
        state = state._replace(count=int(state.count))
    step = -_decayed(lr, gamma, state.count, params[0].device, steps)
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
    The SMPL joints do not depend on poses_T and are computed once. The
    eager loop of `init_step`; `cycle_graph.init_global_poses_fused`
    replays a captured step. Returns (poses_T (T, N, 1, 3), loss_2d
    history (num_iter,))."""
    problem = InitProblem.create(model, pose2d, poses_smpl, betas_smpl,
                                 cam_K, xscale, dist_coef, proj2d_coef,
                                 reg_velocity_coef, joints_thr, pose_weights)
    poses_T = problem.start()
    mu = torch.zeros_like(poses_T)
    nu = torch.zeros_like(poses_T)
    hist = []
    for i in range(num_iter):
        poses_T, mu, nu, loss_2d = init_step(problem, poses_T, mu, nu, i)
        hist.append(loss_2d)
    return poses_T, torch.stack(hist)


class InitProblem(NamedTuple):
    """What the init solve's steps read: the SMPL joints (computed once;
    they do not depend on poses_T), the visibility weights and targets,
    the camera and the coefficients."""

    joints: torch.Tensor             # (T, N, J, 3)
    vis: torch.Tensor                # (T, N, J, 1)
    gt2d: torch.Tensor               # (T, N, J, 2)
    cam_K: torch.Tensor
    dist_coef: Optional[torch.Tensor]
    proj2d_coef: float
    reg_velocity_coef: float

    @classmethod
    def create(cls, model: SMPLModel, pose2d, poses_smpl, betas_smpl,
               cam_K, xscale, dist_coef, proj2d_coef, reg_velocity_coef,
               joints_thr, pose_weights) -> "InitProblem":
        T, N = pose2d.shape[:2]
        with torch.no_grad():
            out = smpl_forward(model, betas_smpl.reshape(T * N, -1),
                               poses_smpl.reshape(T * N, -1))
            joints = torch.pow(1.1, xscale) * out[
                "joints_alphapose"].reshape(T, N, -1, 3)
        vis = (pose2d[..., 2:] > joints_thr).to(torch.float32)
        if pose_weights is not None:
            vis = vis * pose_weights[None, None, :, None]
        return cls(joints, vis, pose2d[..., 0:2], cam_K, dist_coef,
                   proj2d_coef, reg_velocity_coef)

    def start(self) -> torch.Tensor:
        """The initial poses_T: (0, 0, 1) for every person and frame."""
        T, N = self.joints.shape[:2]
        return _on_device((0.0, 0.0, 1.0), torch.float32,
                          self.joints.device).expand(T, N, 1, 3).contiguous()


def init_step(problem: InitProblem, poses_T, mu, nu, i, steps=None):
    """Adam step `i` of the init solve (a Python int, or an int64 device
    count whose schedule tables cover `steps` steps). Returns (poses_T,
    mu, nu, loss_2d)."""
    pr = problem
    p = poses_T.detach().requires_grad_(True)
    proj = project_points(pr.joints + p, pr.cam_K, dist_coef=pr.dist_coef)
    loss_2d = torch.mean(torch.square(pr.vis * proj - pr.vis * pr.gt2d))
    speed = torch.sum(torch.square(p[1:] - p[:-1]))
    loss = pr.proj2d_coef * loss_2d + pr.reg_velocity_coef * speed
    (g,) = torch.autograd.grad(loss, p)
    upd, mu, nu = adam_update(
        g, mu, nu, i, _decayed(0.5, 0.95, i, poses_T.device, steps), 0.5,
        0.5, 1e-6, steps)
    return poses_T + upd, mu, nu, loss_2d.detach()


@span("init_params")
def init_params(model: SMPLModel, data_pose2d: np.ndarray,
                data_poses_smpl: np.ndarray, data_betas_smpl: np.ndarray,
                cam_K: np.ndarray, cfg: EngineConfig,
                scale_factor: Optional[np.ndarray] = None,
                num_iter: int = 100):
    """Initial StageParams on the model's device, the init solve run over
    static buffers (`cycle_graph.init_global_poses_fused`: on the card
    one captured Adam step, replayed). Returns
    (params, init history (numpy), optimize_scale)."""
    from .cycle_graph import init_global_poses_fused
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

    poses_T, hist = init_global_poses_fused(
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


# ---------------------------------------------------------------------------
# The per-chunk loss
# ---------------------------------------------------------------------------

LOG_KEYS = ("loss_pose24j", "loss_depth", "loss_silhouette",
            "reg_ref_poses", "reg_scale", "reg_contact",
            "reg_foot_sliding", "reg_vel", "reg_filter_verts",
            "reg_gap_accel")


class ChunkInputs(NamedTuple):
    """One frame chunk [t0, t0+C) with a left halo of `cfg.halo` frames
    on *_h (frames t0-halo .. t0-1, clamped to 0)."""

    poses_T_h: torch.Tensor       # (C+halo, N, 1, 3)
    poses_smpl_h: torch.Tensor    # (C+halo, N, 72)
    min_z_c: torch.Tensor         # (C, 1, 1)
    max_z_c: torch.Tensor         # (C, 1, 1)
    depths_c: torch.Tensor        # (C, H, W)
    seg_c: torch.Tensor           # (C, N, H, W) f32
    seg_er_c: torch.Tensor        # (C, N, H, W) f32
    pose2d_c: torch.Tensor        # (C, N, 17, 3)
    ref_poses_c: torch.Tensor     # (C, N, 72)
    valid_smpl_c: torch.Tensor    # (C, N, 1)
    frame_valid_h: torch.Tensor   # (C+halo,)
    global_t: torch.Tensor        # (C,)
    dvf_c: torch.Tensor           # (C, N, V, 3) bf16
    # (C+2, N) stale-frame mask, only with cfg.gap_aware_temporal
    stale_h: Optional[torch.Tensor] = None


def _slice_chunk(params: StageParams, data: SeqData, aux: StageAux,
                 cfg: EngineConfig, chunk_idx: int) -> ChunkInputs:
    C, hl = cfg.chunk, cfg.halo
    t0 = chunk_idx * C
    dev = params.poses_T.device
    halo_idx = torch.clamp(t0 - hl + torch.arange(C + hl, device=dev), min=0)
    c = slice(t0, t0 + C)
    min_z, max_z = z_bounds_of(params, cfg)
    return ChunkInputs(
        stale_h=(data.stale_tn[halo_idx] if cfg.gap_aware_temporal
                 else None),
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
    total over chunks counts every consecutive pair once; with
    cfg.gap_aware_temporal the acceleration triples centred at
    [t0-1, t0+C-2] likewise tile the sequence once."""
    C, N = cfg.chunk, cfg.num_people
    W, H = cfg.image_size
    dev = cam_K.device
    f32 = torch.float32

    # everything but the acceleration stencil reads the 1-frame-halo
    # view; with halo 1 that is the arrays themselves, not sliced,
    # because the backward of even a full slice launches a zero fill
    # and a copy
    def halo1(x):
        return x[cfg.halo - 1:] if cfg.halo > 1 else x

    poses_T_h = halo1(chunk.poses_T_h)
    poses_smpl_h = halo1(chunk.poses_smpl_h)
    min_z_c, max_z_c = chunk.min_z_c, chunk.max_z_c
    depths_c, seg_c = chunk.depths_c, chunk.seg_c
    pose2d_c, ref_poses_c = chunk.pose2d_c, chunk.ref_poses_c
    valid_smpl_c = chunk.valid_smpl_c
    frame_valid_h = halo1(chunk.frame_valid_h)
    frame_valid_c = frame_valid_h[1:]
    pair_valid = (frame_valid_h[:-1] * frame_valid_c
                  * (chunk.global_t > 0).to(f32))
    # the robust profile drops the pairs with a stale endpoint (pair_w)
    # and the 2D term of stale frames (obs_w), whose keypoints are the
    # last detection repeated by ingestion; without it both are 1 and
    # are not multiplied in
    pair_w = obs_w = None
    if cfg.gap_aware_temporal:
        stale_h2 = chunk.stale_h                          # (C+2, N)
        pair_w = (1.0 - torch.maximum(stale_h2[1:-1], stale_h2[2:])
                  )[:, :, None, None]
        obs_w = (1.0 - stale_h2[2:])[:, :, None, None]

    def gate(x, w):
        return x if w is None else x * w

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
    norm = _on_device((W, H), f32, dev)
    w2d = gate(conf_ok * fv[..., None, None], obs_w)
    jw = _j17_weights(cfg, dev)
    if jw is not None:
        w2d = w2d * jw[None, None, :, None]
    loss_pose = torch.sum(torch.square(w2d * (proj - pose2d_c[..., :2])
                                       / norm))

    # the window depth and silhouette terms: every group's raster, then
    # one WindowLosses call (the kernel pair on the card); z orders the
    # occlusion (root depth, then index)
    rasters = []
    for win, group in cfg.window_groups:
        g = _on_device(group, torch.int64, dev)
        raster = rasterize_bodies(
            verts_abs[:, g].reshape(C * len(group), -1, 3), model.faces,
            cam_K, cfg.raster_settings_for_window(win))
        rasters.append((raster["zbuf"], raster["sil"], raster["origin"]))
    dw = pose2d_valid * fv
    sil_gate = mask_valid * pose2d_valid * fv
    loss_depth, loss_sil = window_losses(
        cfg.window_groups, rasters, depths_c, min_z_c, max_z_c, seg_c,
        chunk.seg_er_c, poses_T_h[1:, :, 0, 2].detach(), dw, sil_gate,
        cfg.eps)

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
        fs_gate = gate(pv, pair_w) * in_contact
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
        reg_filter_verts = torch.sum(torch.square(
            gate(pv, pair_w) * (gv_diff - dvf)))
    else:
        reg_filter_verts = torch.zeros((), device=dev)

    reg_vel = torch.sum(torch.square(
        gate(pv, pair_w) * (poses_T_h[1:] - poses_T_h[:-1])))

    # gap acceleration: squared second differences of the root and the
    # pose angles over triples (t-1, t, t+1) touching a stale frame, so
    # an unobserved span interpolates between its observed ends
    reg_gap_accel = torch.zeros((), device=dev)
    if cfg.gap_aware_temporal:
        pT2, pS2 = chunk.poses_T_h, chunk.poses_smpl_h    # (C+2, ...)
        fv2 = chunk.frame_valid_h
        tri_stale = torch.maximum(torch.maximum(stale_h2[:-2],
                                                stale_h2[1:-1]),
                                  stale_h2[2:])            # (C, N)
        center_t = chunk.global_t - 1
        tri_valid = fv2[:-2] * fv2[1:-1] * fv2[2:] * (center_t >= 1).to(f32)
        w_tri = tri_valid[:, None] * tri_stale
        accel_T = pT2[2:] - 2.0 * pT2[1:-1] + pT2[:-2]
        accel_P = pS2[2:] - 2.0 * pS2[1:-1] + pS2[:-2]
        reg_gap_accel = (
            torch.sum(torch.square(w_tri[:, :, None, None] * accel_T))
            + torch.sum(torch.square(w_tri[:, :, None] * accel_P)))

    loss = (coefs["proj2d"] * loss_pose
            + coefs["depth"] * loss_depth
            + coefs["silhouette"] * loss_sil
            + coefs["reg_poses"] * reg_ref
            + coefs["reg_contact"] * reg_contact
            + coefs["reg_foot_sliding"] * reg_foot_sliding
            + coefs["reg_verts_filter"] * reg_filter_verts
            + coefs["reg_velocity"] * reg_vel)
    if cfg.gap_aware_temporal:
        loss = loss + coefs["reg_gap_accel"] * reg_gap_accel
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
                         cfg: EngineConfig, mark=None):
    """Full-sequence loss, its log parts and its gradient. Each chunk's
    loss is back-propagated before the next chunk is built, so the
    gradient accumulates in the leaf copies of `params` while memory
    holds one chunk's graph. `mark` (`ops.phase_marks.PhaseMarks`), if
    given, marks the end of each chunk's forward and backward and of
    the scale regularizer. Returns (loss, parts, grads); loss and parts
    stay on the device."""
    leaves = StageParams(*[p.detach().requires_grad_(True) for p in params])
    dev = leaves.poses_T.device
    total = torch.zeros((), device=dev)
    parts = torch.zeros((len(LOG_KEYS),), device=dev)
    for i in range(cfg.num_chunks):
        chunk = _slice_chunk(leaves, data, aux, cfg, i)
        loss, p = _chunk_loss_core(chunk, model, leaves.betas,
                                   scale_factor_of(leaves), data.cam_K,
                                   aux, coefs, cfg)
        if mark:
            mark(f"forward{i}")
        loss.backward()
        if mark:
            mark(f"backward{i}")
        total = total + loss.detach()
        parts = parts + p.detach()
    reg, logged = _scale_reg(leaves, coefs, cfg)
    reg.backward()
    if mark:
        mark("scale_reg")
    total = total + reg.detach()
    parts[4] = logged.detach()
    grads = StageParams(*[torch.zeros_like(p) if p.grad is None else p.grad
                          for p in leaves])
    return total, parts, grads


# ---------------------------------------------------------------------------
# Cycle step + auxiliary updates
# ---------------------------------------------------------------------------

def grad_step(params: StageParams, opt_state: RMSpropState, model, data,
              aux, coefs, cfg: EngineConfig, optimize_scale: bool,
              steps: Optional[int] = None, mark=None):
    """The full-batch gradient and one RMSprop update (`steps`: the
    steps a device count's schedule table covers; `mark`: as
    `cycle_loss_and_grads` takes it)."""
    # without marks, the six-argument call that wrappers of it take
    args = (params, model, data, aux, coefs, cfg)
    loss, parts, grads = (cycle_loss_and_grads(*args) if mark is None
                          else cycle_loss_and_grads(*args, mark))
    if not optimize_scale:
        grads = grads._replace(xscale=torch.zeros_like(grads.xscale))
    with torch.no_grad():
        params, opt_state = rmsprop_update(grads, opt_state, params,
                                           steps=steps)
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
    t_e = _filter_time_base(cfg.padded_frames, cfg.frame_rate)
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
                state, xf = one_euro_step(state, x, t_e[t], cfg.min_cutoff2,
                                          cfg.beta2)
                diffs.append(xf - prev)
            prev = xf
    return torch.stack(diffs).to(torch.bfloat16)


@functools.cache
def _filter_time_base(frames: int, frame_rate: float) -> torch.Tensor:
    """The filtered-target refresh's 'ramp' time base t_e(t) for t in
    [0, frames) as float32 CPU scalars, like the JAX package's
    t.astype(f32) / frame_rate, built once: a CPU scalar enters the
    device's arithmetic as a kernel argument, with no copy."""
    return torch.stack([torch.clamp(torch.tensor(float(t),
                                                 dtype=torch.float32)
                                    / frame_rate, min=1e-6)
                        for t in range(frames)])


def refresh_flags(cycle_idx: int, cfg: EngineConfig) -> Tuple[bool, bool]:
    """(do_scene, do_filt) of cycle `cycle_idx`, decided on the host from
    the index: the scene rebuild every `scene_update_every` cycles and
    the One-Euro target refresh every `update_filters_every`, both from
    `warmup_cycles` on."""
    do_aux = cycle_idx >= cfg.warmup_cycles
    return (do_aux and cycle_idx % cfg.scene_update_every == 0,
            do_aux and cycle_idx % cfg.update_filters_every == 0)


def fused_aux_refresh(params: StageParams, aux: StageAux, cycle_idx: int,
                      model: SMPLModel, data: SeqData,
                      cfg: EngineConfig) -> StageAux:
    """The scene rebuild and the One-Euro target refresh of cycle
    `cycle_idx` (`refresh_flags`)."""
    do_scene, do_filt = refresh_flags(cycle_idx, cfg)
    scene = update_scene(params, data, cfg) if do_scene else aux.scene
    dvf = (update_filtered_targets(params, model, cfg) if do_filt
           else aux.verts_filt_diff)
    return aux._replace(scene=scene,
                        have_scene=aux.have_scene or do_scene,
                        verts_filt_diff=dvf,
                        have_filters=aux.have_filters or do_filt)


def stage1_cycle(params: StageParams, opt_state: RMSpropState,
                 model: SMPLModel, data: SeqData, aux: StageAux, coefs,
                 cfg: EngineConfig, optimize_scale: bool = True):
    """One cycle without the aux refreshes: the full-batch gradient and
    one RMSprop update. Returns (params, opt_state, loss, parts)."""
    return grad_step(params, opt_state, model, data, aux, coefs, cfg,
                     optimize_scale)


def stage1_cycle_eager(params: StageParams, opt_state: RMSpropState,
                       aux: StageAux, cycle_idx: int, model: SMPLModel,
                       data: SeqData, coefs, cfg: EngineConfig,
                       optimize_scale: bool = True):
    """One production cycle as eager torch on any device: the
    conditional aux refreshes, then the full-batch gradient and one
    RMSprop update. Returns (params, opt_state, aux, loss, parts); loss
    and parts stay on the device."""
    aux = fused_aux_refresh(params, aux, cycle_idx, model, data, cfg)
    params, opt_state, loss, parts = grad_step(
        params, opt_state, model, data, aux, coefs, cfg, optimize_scale)
    return params, opt_state, aux, loss, parts


def stage1_cycle_fused(params: StageParams, opt_state: RMSpropState,
                       aux: StageAux, cycle_idx: int, model: SMPLModel,
                       data: SeqData, coefs, cfg: EngineConfig,
                       optimize_scale: bool = True):
    """One production cycle. On CUDA tensors it is one replay of a
    captured CUDA graph (`cycle_graph.replay_cycles`): params, RMSprop
    state and aux are donated, as in the JAX package, i.e. the returned
    ones are the graph's static buffers, which the next call updates in
    place. On CPU tensors it is `stage1_cycle_eager`. Returns (params,
    opt_state, aux, loss, parts)."""
    if params.poses_T.is_cuda:
        from .cycle_graph import replay_cycles
        params, opt_state, aux, losses, parts = replay_cycles(
            params, opt_state, aux, cycle_idx, model, data, coefs, cfg,
            optimize_scale, 1)
        return params, opt_state, aux, losses[0], parts[0]
    return stage1_cycle_eager(params, opt_state, aux, cycle_idx, model,
                              data, coefs, cfg, optimize_scale)


def stage1_cycles_fused(params: StageParams, opt_state: RMSpropState,
                        aux: StageAux, cycle_idx0: int, model: SMPLModel,
                        data: SeqData, coefs, cfg: EngineConfig,
                        optimize_scale: bool = True, n_cycles: int = 1):
    """`n_cycles` consecutive production cycles with cycle indices
    cycle_idx0 + [0, n_cycles): on CUDA tensors n_cycles graph replays
    with no host synchronization (donated as in `stage1_cycle_fused`),
    on CPU tensors a loop of `stage1_cycle_eager`. Returns (params,
    opt_state, aux, losses (n_cycles,), parts (n_cycles,
    len(LOG_KEYS))), on the device."""
    if params.poses_T.is_cuda:
        from .cycle_graph import replay_cycles
        return replay_cycles(params, opt_state, aux, cycle_idx0, model,
                             data, coefs, cfg, optimize_scale, n_cycles)
    losses, parts = [], []
    for k in range(n_cycles):
        params, opt_state, aux, loss, p = stage1_cycle_eager(
            params, opt_state, aux, cycle_idx0 + k, model, data, coefs, cfg,
            optimize_scale)
        losses.append(loss)
        parts.append(p)
    return params, opt_state, aux, torch.stack(losses), torch.stack(parts)


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

"""The production workload: a synthetic TS1-scale sequence.

Port of `bench.py`'s `ts1_poses_T` and `make_ts1_like_seq`: T=201
frames, N=3 people, 256x256 images, built with the port's SMPL and
camera functions from a fixed seed. With `raster_window=160` the
Predictor sizes it to per-person windows (160, 128, 112) on the full
synthetic body (6890 vertices, 12672 faces).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .data.ingestion import SequenceArrays
from .models.smpl import smpl_forward
from .models.synthetic import make_synthetic_smpl
from .ops.cameras import intrinsics_from_fov, project_points

T, N, SIDE, WINDOW = 201, 3, 256, 160


def bench_args(num_iter, bench_cycles=None, window=WINDOW, verbose=False):
    """Predictor arguments of bench.py's run: its loss coefficients and
    raster window; the fit times the windows between `bench_cycles`."""
    return types.SimpleNamespace(
        num_iter=num_iter, batch_size=10, verbose=verbose,
        proj2d_loss_coef=1.0, depth_loss_coef=0.05,
        silhouette_loss_coef=0.1, reg_poses_coef=0.002,
        reg_scales_coef=1e-4, reg_velocity_coef=0.05,
        reg_verts_filter_coef=0.002, reg_contact_coef=0.001,
        reg_foot_sliding_coef=0.01, joint_confidence_thr=0.5,
        raster_window=window, bench_cycles=bench_cycles)


def ts1_poses_T(T=T, N=N):
    """People spread in x at depths 3.4 .. 5.0 m (the nearest body's
    99th-percentile bbox need stays just under the 160 px window)."""
    poses_T = np.zeros((T, N, 1, 3), np.float32)
    poses_T[:, :, 0, 2] = np.linspace(3.4, 5.0, N)[None]
    poses_T[:, :, 0, 0] = np.linspace(-0.8, 0.8, N)[None]
    return poses_T


@torch.no_grad()
def make_ts1_like_seq(T=T, N=N, side=SIDE, model=None):
    """(SequenceArrays, model): the synthetic TS1-scale sequence and the
    body it was posed with (the full synthetic body unless `model` is
    given). The arrays are generated on the CPU."""
    if model is None:
        model = make_synthetic_smpl()
    K = intrinsics_from_fov((side, side), 60.0)
    rng = np.random.RandomState(0)

    poses_smpl = 0.1 * rng.randn(T, N, 72).astype(np.float32)
    betas = np.zeros((T, N, 10), np.float32)
    poses_T = ts1_poses_T(T, N)
    m = model.to("cpu")
    out = smpl_forward(m, torch.as_tensor(betas.reshape(-1, 10)),
                       torch.as_tensor(poses_smpl.reshape(-1, 72)))
    j3d = out["joints_alphapose"].numpy().reshape(T, N, 17, 3) + poses_T
    uv = project_points(torch.as_tensor(j3d), torch.as_tensor(K)).numpy()
    pose2d = np.concatenate(
        [uv, 0.9 * np.ones((T, N, 17, 1), np.float32)], -1)

    seg = np.zeros((T, N, side, side), np.float32)
    for n in range(N):
        x0 = 40 + 60 * n
        seg[:, n, 60:200, x0:x0 + 50] = 1
    seq = SequenceArrays(
        images=np.zeros((T, side, side, 3), np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, side, side), 0,
                       1).astype(np.float32),
        instances=np.zeros((T, side, side), np.uint8),
        seg_mask=seg,
        backmasks=1.0 - seg.max(axis=1),
        pose2d=pose2d,
        cam_smpl=np.zeros((T, N, 3), np.float32),
        poses_smpl=poses_smpl,
        betas_smpl=betas,
        valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": K, "fov": 60.0, "Kd": None, "image_size": (side, side)},
    )
    return seq, model

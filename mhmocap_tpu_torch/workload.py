"""The production workload: a synthetic TS1-scale sequence.

Port of `bench.py`'s `ts1_poses_T` and `make_ts1_like_seq`: T=201
frames, N=3 people, 256x256 images, built with the port's SMPL and
camera functions from a fixed seed. With `raster_window=160` the
Predictor sizes it to per-person windows (160, 128, 112) on the full
synthetic body (6890 vertices, 12672 faces). `posed_raster_tables`
builds the raster kernels' inputs at the main paths' call shapes
(`KERNEL_SHAPES`), for measuring the kernels alone.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .data.ingestion import SequenceArrays
from .engine.fhsog import FRAMES_PER_CALL
from .models.smpl import smpl_forward
from .models.synthetic import make_synthetic_smpl
from .ops import raster_cuda as RC
from .ops import rasterizer as R
from .ops.cameras import intrinsics_from_fov, project_points

T, N, SIDE, WINDOW = 201, 3, 256, 160
# The raster calls of the main paths as (bodies per call, windows): a
# cycle makes one call per window per chunk, and every person has a
# window of its own in each. chip_smoke.py phase 4 (bench-ts1): chunk
# 29, windows 160/128/112; phase 6 (the entry trees): chunk 30, windows
# 160/112/80 (TS1) and 160/112 (TS2); phase 7 (the robust config's
# 32-frame degraded tree): chunk 32, windows 160/112/80; phase 9 (the
# FHSOG build on phase 7's 256x256 output): fhsog.FRAMES_PER_CALL frames
# of 3 bodies a call at the full-frame window 256; bench-ts1 sharded over
# 2 ranks (phase 10: chunk 34, 3 chunks a rank, padded 204) and over 4
# (chunk 17). The kernels are timed at the first two and the FHSOG's
# (TIMED_SHAPES) and checked at all.
KERNEL_SHAPES = ((29, (160, 128, 112)), (30, (160, 112, 80)),
                 (32, (160, 112, 80)), (3 * FRAMES_PER_CALL, (256,)),
                 (34, (160, 128, 112)), (17, (160, 128, 112)))
TIMED_SHAPES = {(b, w) for b, wins in KERNEL_SHAPES[:2] + KERNEL_SHAPES[3:4]
                for w in wins}
# body depth whose projection fills each window (bench placement); the
# full-frame window 256 holds a body at the nearest bench depth
WINDOW_DEPTH = {256: 3.4, 160: 3.4, 128: 4.2, 112: 5.0, 80: 6.8}


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


@torch.no_grad()
def posed_raster_tables(model, win, n_bodies, seed, device):
    """The raster kernels' inputs for n_bodies posed bodies at the depth
    that fills `win` in a 256x256 image: (tab, agg, lists, bounds,
    inv_blur, znear), with the JAX package's schedule (lists, bounds),
    from which the work is counted."""
    rng = np.random.RandomState(seed)
    poses = torch.as_tensor(0.1 * rng.randn(n_bodies, 72), dtype=torch.float32,
                            device=device)
    transl = np.zeros((n_bodies, 3), np.float32)
    transl[:, 2] = WINDOW_DEPTH[win]
    transl[:, :2] = 0.05 * rng.randn(n_bodies, 2)
    v = smpl_forward(model, torch.zeros((n_bodies, 10), device=device),
                     poses, transl=torch.as_tensor(transl, device=device))
    st = R.RasterSettings(image_size=(256, 256), window=win)
    K = torch.as_tensor(intrinsics_from_fov((256, 256), 60.0), device=device)
    uvz = project_points(v["verts"], K, return_depth=True)
    origin = R.window_origin(uvz[..., :2], uvz[..., 2], st)
    fuvz = uvz[:, model.faces]
    fuv = fuvz[..., :2] - origin[:, None, None, :].float()
    planes, bbox, oks, okd = R.face_planes(fuv, fuvz[..., 2], st.znear)
    reach = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
    inv_blur = 1.0 / st.sil_blur_px2
    tab, agg = RC._tables(planes, bbox, bbox[..., 2] - reach,
                          bbox[..., 3] + reach, oks, okd, inv_blur)
    lists, bounds = RC._strip_chunk_lists(agg, win)
    return tab, agg, lists, bounds, inv_blur, st.znear


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn on the current CUDA stream over reps calls after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

"""The one generator: a multi-person video's fit inputs from a seed.

It reads a configuration (sizes of the video, its frames W x H, and of
the body; the loss coefficients) and a traffic mix (where the people
stand, how much they move, the depth maps' noise, the silhouettes), and
builds what a MuPoTs-style ingestion hands the fit: normalized disparity
maps, per-person silhouettes and the background mask, 2D keypoints with
confidences, per-frame SMPL poses and shapes from a regressor, and the
camera. The 2D keypoints are the body's own keypoints projected, so the
fit has a consistent target. The random parts (poses, disparity noise)
come from `seed` through a torch.Generator on the device, in blocks of
frames; the body is the configuration's, built from its own seed.
The result stays on the host as numpy arrays: the program and the
reference each take their copy from there.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .reference.body import body_arrays, body_tensors, intrinsics, project, \
    skin

FRAME_BLOCK = 128


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def people_placement(traffic: Dict, T: int, N: int) -> np.ndarray:
    """Root translations (T, N, 1, 3): person n stands still at
    (x_m[n], 0, depth_m[n])."""
    pT = np.zeros((T, N, 1, 3), np.float32)
    pT[:, :, 0, 2] = np.asarray(traffic["depth_m"][:N], np.float32)[None]
    pT[:, :, 0, 0] = np.asarray(traffic["x_m"][:N], np.float32)[None]
    return pT


def silhouettes(traffic: Dict, N: int, size) -> np.ndarray:
    """(N, H, W) float32 boxes, one per person, for a frame of `size`
    (W, H): rows at the traffic's fractions of H (`mask_rows`), columns
    at its fractions of W (`mask_x0`, `mask_dx`, `mask_w`)."""
    W, H = size
    seg = np.zeros((N, H, W), np.float32)
    r0, r1 = (int(round(f * H)) for f in traffic["mask_rows"])
    w = int(round(traffic["mask_w"] * W))
    for n in range(N):
        x0 = int(round((traffic["mask_x0"] + n * traffic["mask_dx"]) * W))
        seg[n, r0:r1, x0:x0 + w] = 1.0
    return seg


@torch.no_grad()
def generate(config: Dict, traffic: Dict, seed: int,
             device) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(inputs, body arrays) for frames of the configuration's
    `image_size` (W, H). inputs: depths (T, H, W), seg_mask
    (T, N, H, W), backmasks (T, H, W), pose2d (T, N, 17, 3), poses_smpl
    (T, N, 72), betas_smpl (T, N, 10), valid_smpl (T, N, 1), K (3, 3),
    all float32."""
    T, N = config["frames"], config["people"]
    W, H = size = tuple(config["image_size"])
    dev = torch.device(device)
    g = seed_generator(seed, dev)
    arrays = body_arrays(config["body"]["num_vertices"],
                         config["body"]["seed"])
    body = body_tensors(arrays, dev)
    K = intrinsics(W, H, config["fov_deg"])
    Kt = torch.as_tensor(K, device=dev)
    pT = people_placement(traffic, T, N)

    poses = np.empty((T, N, 72), np.float32)
    pose2d = np.empty((T, N, 17, 3), np.float32)
    depths = np.empty((T, H, W), np.float32)
    for t0 in range(0, T, FRAME_BLOCK):
        n = min(FRAME_BLOCK, T - t0)
        p = traffic["pose_std_rad"] * torch.randn(
            (n, N, 72), generator=g, device=dev)
        _, kp = skin(body, torch.zeros((n * N, 10), device=dev),
                     p.reshape(n * N, 72))
        kp = kp.reshape(n, N, 17, 3) + torch.as_tensor(pT[t0:t0 + n],
                                                       device=dev)
        uv = project(kp, Kt)[..., :2]
        conf = torch.full((n, N, 17, 1), traffic["keypoint_conf"],
                          device=dev)
        d = torch.clamp(traffic["disparity_mean"] + traffic["disparity_std"]
                        * torch.randn((n, H, W), generator=g, device=dev),
                        0.0, 1.0)
        poses[t0:t0 + n] = p.cpu().numpy()
        pose2d[t0:t0 + n] = torch.cat([uv, conf], -1).cpu().numpy()
        depths[t0:t0 + n] = d.cpu().numpy()

    seg = np.broadcast_to(silhouettes(traffic, N, size)[None], (T, N, H, W))
    backmask = 1.0 - silhouettes(traffic, N, size).max(axis=0)
    inputs = dict(
        depths=depths,
        seg_mask=seg,
        backmasks=np.broadcast_to(backmask[None], (T, H, W)),
        pose2d=pose2d,
        poses_smpl=poses,
        betas_smpl=np.zeros((T, N, 10), np.float32),
        valid_smpl=np.ones((T, N, 1), np.float32),
        K=K)
    return inputs, arrays


def to_device(inputs: Dict[str, np.ndarray], device) -> Dict:
    """The inputs as float32 tensors on `device`."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device) for k, v in inputs.items()}

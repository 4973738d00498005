"""Camera models and bounded reparameterizations on torch tensors.

Port of `mhmocap_tpu/ops/cameras.py`: perspective projection with the
reference's OpenCV-style distortion, UVD unprojection, intrinsics from
a field of view, and softplus. Shape-polymorphic like the JAX version:
(..., P, 3) points against a (3, 3) or broadcastable (..., 3, 3) K.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def project_points(pts3d: torch.Tensor, K: torch.Tensor,
                   dist_coef: Optional[Sequence[float]] = None,
                   return_depth: bool = False) -> torch.Tensor:
    """Pinhole projection -> (..., P, 2) pixels, or (..., P, 3) UVD with
    `return_depth`. `dist_coef` = (k1, k2, p1, p2, k3)."""
    z = pts3d[..., 2:3]
    xy = pts3d[..., :2] / z

    if dist_coef is not None:
        k1, k2, p1, p2, k3 = (dist_coef[i] for i in range(5))
        x, y = xy[..., 0], xy[..., 1]
        r = x * x + y * y
        radial = 1 + k1 * r + k2 * r * r + k3 * r * r * r
        xd = x * radial + 2 * p1 * x * y + p2 * (r + 2 * x * x)
        yd = y * radial + 2 * p2 * y * y + p1 * (r + 2 * y * y)
        xy = torch.stack([xd, yd], dim=-1)

    fxy = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    cxy = K[..., 0:2, 2]
    uv = xy * fxy[..., None, :] + cxy[..., None, :]
    if return_depth:
        return torch.cat([uv, z], dim=-1)
    return uv


def unproject_points(uvd: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """UVD (pixels + absolute depth) -> camera-space points."""
    fxy = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    cxy = K[..., 0:2, 2]
    z = uvd[..., 2:3]
    xy = z * (uvd[..., :2] - cxy[..., None, :]) / fxy[..., None, :]
    return torch.cat([xy, z], dim=-1)


def focal_from_fov(side: float, fov_deg: float) -> float:
    return float(0.5 * side / np.tan(np.radians(fov_deg) / 2.0))


def intrinsics_from_fov(image_size: Tuple[int, int],
                        fov_deg: float) -> np.ndarray:
    """K with the principal point at the image centre and the focal
    length from the FOV over the smaller image side."""
    w, h = image_size
    f = focal_from_fov(min(image_size), fov_deg)
    return np.array([[f, 0, w / 2.0],
                     [0, f, h / 2.0],
                     [0, 0, 1]], np.float32)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as jnp.logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))

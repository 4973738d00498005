"""Camera models and bounded reparameterizations on torch tensors.

Port of `mhmocap_tpu/ops/cameras.py`: perspective projection with the
reference's OpenCV-style distortion, UVD unprojection, ROMP's
weak-perspective projection, intrinsics from a field of view or from
3D <-> 2D pairs (numpy), the NDC calibration matrix (numpy), the
fov <-> focal conversions, the softplus and bounded-exp
reparameterizations, disparity from depth and an [R|t] transform.
Shape-polymorphic like the JAX version: (..., P, 3) points against a
(3, 3) or broadcastable (..., 3, 3) K.
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


def weak_perspective_projection(p3d: torch.Tensor, cam: torch.Tensor,
                                image_size: Tuple[int, int]) -> torch.Tensor:
    """ROMP-style orthographic projection of (..., P, 3) points with
    (..., 3) cams [scale, tx, ty] to pixels:
    max(W, H) * ((s * xy + t) / 2 + (W, H) / (2 max(W, H)))."""
    cam = cam[..., None, :]
    p2d = cam[..., 0:1] * p3d[..., :2] + cam[..., 1:]
    wh = torch.as_tensor(image_size, dtype=p2d.dtype, device=p2d.device)
    m = float(max(image_size))
    return m * (p2d / 2.0 + wh / (2.0 * m))


def fov_from_focal(side: float, focal: float) -> float:
    return float(np.degrees(2.0 * np.arctan(0.5 * side / focal)))


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


def recover_intrinsics(pts3d: np.ndarray, pts2d: np.ndarray) -> np.ndarray:
    """Least-squares (fx, cx, fy, cy) from 3D <-> 2D pairs (numpy)."""
    xn = pts3d[:, 0] / pts3d[:, 2]
    yn = pts3d[:, 1] / pts3d[:, 2]

    def solve(p, q):
        A = np.stack([p, np.ones_like(p)], axis=1)
        coef, *_ = np.linalg.lstsq(A, q, rcond=None)
        return coef[0], coef[1]

    fx, cx = solve(xn, pts2d[:, 0])
    fy, cy = solve(yn, pts2d[:, 1])
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def recover_intrinsics_simplified(pts3d: np.ndarray, pts2d: np.ndarray,
                                  image_size) -> np.ndarray:
    """One focal per axis with the principal point at the image centre
    (numpy)."""
    cx, cy = image_size[0] / 2.0, image_size[1] / 2.0
    p3 = pts3d[:, :2] / pts3d[:, 2:3]
    p2 = pts2d - np.array([[cx, cy]], np.float32)

    def solve(a, b):
        return float((a * b).sum() / np.clip((a * a).sum(), 1e-12, None))

    fx = solve(p3[:, 0], p2[:, 0])
    fy = solve(p3[:, 1], p2[:, 1])
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def ndc_calibration_matrix(znear: float, zfar: float, K: np.ndarray,
                           image_size: Tuple[int, int]) -> np.ndarray:
    """4x4 NDC projection matrix of a PyTorch3D-style calibration: the
    shorter image side maps to [-1, 1], the principal-point offsets go
    in the third column, depth maps through zfar / (zfar - znear) and
    -zfar znear / (zfar - znear) (numpy)."""
    w, h = image_size
    if w > h:
        s1 = 2 * K[1, 1] / h
        u = w / h
        w1 = u * (w - 2 * K[0, 2]) / w
        h1 = (h - 2 * K[1, 2]) / h
    elif h > w:
        s1 = 2 * K[0, 0] / w
        u = h / w
        w1 = (w - 2 * K[0, 2]) / w
        h1 = u * (h - 2 * K[1, 2]) / h
    else:
        s1 = 2 * (K[0, 0] + K[1, 1]) / (w + h)
        w1 = (w - 2 * K[0, 2]) / w
        h1 = (h - 2 * K[1, 2]) / h
    f1 = zfar / (zfar - znear)
    f2 = -(zfar * znear) / (zfar - znear)
    return np.array([[s1, 0, w1, 0],
                     [0, s1, h1, 0],
                     [0, 0, f1, f2],
                     [0, 0, 1, 0]], np.float32)


def inverse_softplus(s: torch.Tensor) -> torch.Tensor:
    """log(e^s - 1), in the stable form s + log(-expm1(-s))."""
    return s + torch.log(-torch.expm1(-s))


def _span(x: torch.Tensor, min_val, max_val) -> torch.Tensor:
    return torch.as_tensor(max_val - min_val, dtype=x.dtype, device=x.device)


def bounded_splus_exp(x: torch.Tensor, min_val, max_val) -> torch.Tensor:
    """Smooth map R -> (min_val, ~max_val)."""
    span = _span(x, min_val, max_val)
    y = x - torch.log(span) / 2.0
    s = torch.log(1.0 / span + torch.exp(y))
    return torch.exp(-s) + min_val


def inverted_bounded_splus_exp(z: torch.Tensor, min_val,
                               max_val) -> torch.Tensor:
    """Inverse of `bounded_splus_exp`."""
    span = _span(z, min_val, max_val)
    s = -torch.log(z - min_val)
    y = torch.log(torch.exp(s) - 1.0 / span)
    return y + torch.log(span) / 2.0


def disparity_from_depth(depth: torch.Tensor, eps: float = 1e-3):
    return 1.0 / torch.clamp(depth, min=eps)


def transform_points_rt(pts3d: torch.Tensor, RT: torch.Tensor):
    """Apply a (3, 4) [R|t] to (..., 3) points."""
    return pts3d @ RT[:, :3].T + RT[:, 3]

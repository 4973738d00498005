"""Static scene geometry: aggregation, point cloud, contact queries.

Port of `mhmocap_tpu/engine/scene.py`. The point cloud keeps the static
(H*W, 3) shape with a validity mask. The 32-NN query is exact
(`torch.topk(largest=False)`; the JAX package's `approx_min_k` is exact
on its CPU lowering, which the parity tests check) and runs in blocks of
queries so that the (Q, H*W) distance matrix stays small.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cameras import unproject_points
from ..ops.image import masked_temporal_median, postprocess_depthmap

# queries per block of the kNN distance matrix: 1024 x 65536 f32 is
# 256 MB at the 256x256 working resolution
KNN_QUERY_BLOCK = 1024


class ScenePointCloud(NamedTuple):
    points: torch.Tensor       # (M, 3) camera space
    valid: torch.Tensor        # (M,) bool
    depth: torch.Tensor        # (H, W) postprocessed scene depth
    depth_valid: torch.Tensor  # (H, W) bool (pre-fill-in validity)


def denormalize_disparity(disp, min_z, max_z):
    inv = disp * (1.0 / min_z - 1.0 / max_z) + 1.0 / max_z
    return 1.0 / inv


def aggregate_scene_depth(disp, backmask, min_z, max_z):
    """Masked median over time of de-normalized background depths:
    disp (T, H, W), backmask (T, H, W), min_z/max_z (T, 1, 1)."""
    depth = denormalize_disparity(disp, min_z, max_z)
    return masked_temporal_median(depth, backmask > 0.5)


def build_scene_pointcloud(scene_depth, scene_valid, cam_K,
                           use_bilateral: bool = True) -> ScenePointCloud:
    """Postprocess the aggregated depth and unproject every pixel
    centre; validity follows the aggregation mask."""
    H, W = scene_depth.shape
    post = postprocess_depthmap(scene_depth,
                                scene_valid.to(scene_depth.dtype),
                                use_bilateral_filter=use_bilateral)
    xs = torch.arange(W, dtype=post.dtype, device=post.device) + 0.5
    ys = torch.arange(H, dtype=post.dtype, device=post.device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    uvd = torch.stack([gx, gy, post], dim=-1).reshape(-1, 3)
    pts = unproject_points(uvd, cam_K)
    return ScenePointCloud(points=pts,
                           valid=scene_valid.reshape(-1) > 0.5,
                           depth=post,
                           depth_valid=scene_valid > 0.5)


def lowest_vertex(verts):
    """(..., V, 3) -> (..., 1, 3): the vertex with max y (y points
    down)."""
    idx = torch.argmax(verts[..., 1], dim=-1)
    return torch.gather(verts, -2,
                        idx[..., None, None].expand(idx.shape + (1, 3)))


def mean_knn_point(query, pcd: ScenePointCloud, k: int = 32):
    """Mean of the k nearest valid scene points of each query point:
    (..., 3) -> (..., 3). Exact kNN, blocked over queries. The result
    depends on the query only through the neighbour selection, so it
    carries no gradient (as in the JAX package)."""
    q = query.detach().reshape(-1, 3)
    inf = torch.full((), float("inf"), dtype=q.dtype, device=q.device)
    means = []
    for q0 in range(0, q.shape[0], KNN_QUERY_BLOCK):
        qb = q[q0:q0 + KNN_QUERY_BLOCK]
        d2 = torch.sum(torch.square(qb[:, None] - pcd.points[None]), dim=-1)
        d2 = torch.where(pcd.valid[None], d2, inf)
        idx = torch.topk(d2, k, dim=-1, largest=False).indices   # (Q, k)
        gathered = pcd.points[idx]
        ok = pcd.valid[idx][..., None]
        means.append(
            torch.sum(torch.where(ok, gathered, torch.zeros_like(gathered)),
                      dim=1)
            / torch.clamp(torch.sum(ok, dim=1), min=1))
    return torch.cat(means, dim=0).reshape(query.shape)


def contact_targets(verts_abs, poses_T, pcd: ScenePointCloud, k: int = 32,
                    offset: float = 0.02):
    """Per-body contact statistics: verts_abs (..., N, V, 3), poses_T
    (..., N, 1, 3) -> (low_verts (..., N, 1, 3), contact_dist_vertical
    (..., N, 1, 1), detached target_poses_T (..., N, 1, 3))."""
    low = lowest_vertex(verts_abs)
    closest = mean_knn_point(low, pcd, k=k)
    contact_dist = (closest - low)[..., 1:2]
    zeros = torch.zeros_like(contact_dist)
    shift = torch.cat([zeros, contact_dist + offset, zeros], dim=-1)
    target = (poses_T + shift).detach()
    return low, contact_dist, target

"""Misc array/geometry utilities (host-side numpy).

A copy of `mhmocap_tpu/data/utils.py`, which is numpy only: the pieces
of reference `mhmocap/utils.py` not covered by ops/image.py (fill-in,
postprocessing), ops/morphology.py and data/assignment.py (Hungarian):
image cropping, window depth sampling, bbox helpers, k-closest point
aggregation, camera intrinsic rescaling, vector angles.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def automatic_image_crop(image, anchor_point, reference_point,
                         reference_shape):
    """Crop `image` so `anchor_point` lands on `reference_point` inside
    a `reference_shape` canvas (reference utils.py:6-50). Returns
    (cropped, crop_bbox [x1,y1,x2,y2], original_bbox)."""
    img_rows, img_cols = image.shape[:2]
    ref_rows, ref_cols = reference_shape
    anchor_point = np.asarray(anchor_point)
    reference_point = np.asarray(reference_point)

    pts = (np.array([[0, 0], [img_rows, 0], [img_rows, img_cols],
                     [0, img_cols]]) - anchor_point + reference_point)
    row_min, col_min = pts.min(axis=0)
    row_max, col_max = pts.max(axis=0)
    org_crop = np.array([col_min, row_min, col_max, row_max])

    if row_min < 0:
        image = image[-row_min:]
        row_min = 0
    if col_min < 0:
        image = image[:, -col_min:]
        col_min = 0
    if row_max > ref_rows:
        image = image[:ref_rows - row_max]
        row_max = ref_rows
    if col_max > ref_cols:
        image = image[:, :ref_cols - col_max]
        col_max = ref_cols
    return image, np.array([col_min, row_min, col_max, row_max]), org_crop


def sample_window_depth(depth, mask, pos, win_size, metric="avg"):
    """Masked statistic of a window around pos=[row, col]
    (reference sample_average_depth, utils.py:53-88)."""
    assert metric in ("avg", "min", "max")
    max_row, max_col = depth.shape
    row, col = pos
    r1, r2 = max(row - win_size // 2, 0), min(row + win_size // 2, max_row)
    c1, c2 = max(col - win_size // 2, 0), min(col + win_size // 2, max_col)
    vals = depth[r1:r2, c1:c2][mask[r1:r2, c1:c2] > 0]
    if metric == "avg":
        return vals.mean(dtype=vals.dtype)
    return vals.min() if metric == "min" else vals.max()


def centered_boundingboxes(p2d, img_size, pix_size: int = 7):
    """Small square bboxes [r1,c1,r2,c2] centered on 2D points
    (reference utils.py:347-356)."""
    w, h = img_size
    d = pix_size // 2
    c1 = np.clip(p2d[:, 0] - d, 0, w)
    c2 = np.clip(c1 + pix_size, 0, w)
    r1 = np.clip(p2d[:, 1] - d, 0, h)
    r2 = np.clip(r1 + pix_size, 0, h)
    return np.stack([r1, c1, r2, c2], axis=1)


def sampling_boundingboxes(depth, bboxes, metric: str = "mean"):
    """Per-bbox depth statistic + validity (reference utils.py:359-371)."""
    fn = getattr(np, metric)
    values = np.zeros((len(bboxes),), np.float32)
    mask = np.zeros((len(bboxes),), np.float32)
    for i, (r1, c1, r2, c2) in enumerate(np.asarray(bboxes, int)):
        if r2 > r1 and c2 > c1:
            values[i] = fn(depth[r1:r2, c1:c2])
            mask[i] = 1.0
    return values, mask


def aggregate_kclosest_points(points, refidxs, k, num_iter: int = 1):
    """Iteratively grow a point set by k-nearest neighbors
    (reference utils.py:245-275)."""
    def grow(ref):
        d = np.sqrt(np.sum(
            np.square(points[None] - points[ref][:, None]), axis=-1))
        idxs = np.argsort(d, axis=1)[:, 1:k + 1].reshape(-1)
        return np.unique(idxs)

    new = np.asarray(refidxs)
    agg = new
    for _ in range(num_iter):
        new = grow(new)
        agg = np.append(agg, new)
    return agg


def angle_between_vectors(a, b) -> float:
    """Angle (degrees) between two 3D vectors (utils.py:336-344)."""
    cos = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.rad2deg(np.arccos(np.clip(cos, -1, 1))))


def effective_camera_intrinsics(actual_image_size,
                                caminfo: Dict) -> Dict:
    """Rescale K to a new image size (reference utils.py:212-242)."""
    actual = np.asarray(actual_image_size, np.float64)
    org = np.asarray(caminfo["image_size"], np.float64)
    K = np.asarray(caminfo["K"], np.float64)
    fx = K[0, 0] * actual[0] / org[0]
    fy = K[1, 1] * actual[1] / org[1]
    cx = K[0, 2] * actual[0] / org[0]
    cy = K[1, 2] * actual[1] / org[1]
    return {"K": np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]),
            "image_size": tuple(int(v) for v in actual)}

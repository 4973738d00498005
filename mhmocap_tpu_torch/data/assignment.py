"""Keypoint-set assignment utilities (host-side).

Port of `mhmocap_tpu/data/assignment.py` (numpy/scipy, unchanged).

Capability parity with reference `utils.linear_kpts_assignment`
(utils.py:278-311): Hungarian matching of two pose sets by average
distance over mutually-visible joints. Runs once per frame during
ingestion/eval (never in the device hot loop), so scipy's C++
`linear_sum_assignment` is the right tool; a vectorized cost build
replaces the reference's python loop over K*N pairs.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

# pose_distance_2d's no-mutually-visible-joints sentinel (reference
# alphapose.py:104 returns this exact literal); exported so callers
# can detect sentinel-poisoned comparisons.
SENTINEL_DISTANCE = 99999.0


def pose_set_cost_matrix(ref: np.ndarray, pred: np.ndarray,
                         thr: float = 0.5) -> np.ndarray:
    """(K, J, D+1) x (N, J, D+1) -> (K, N) mean joint distance over
    joints visible (> thr) in both; 1e6 where no joint is shared.

    NOTE (parity): distances use the full (x, y, score) triplet
    including the score channel, as the reference does
    (utils.py:300 subtracts the whole last axis), so tie-breaking
    matches.
    """
    vis = (ref[:, None, :, -1] > thr) & (pred[None, :, :, -1] > thr)
    diff = ref[:, None, :, :] - pred[None, :, :, :]
    dist = np.sqrt(np.sum(np.square(diff), axis=-1))  # (K, N, J)
    n = vis.sum(axis=-1)
    cost = np.where(n > 0,
                    np.sum(dist * vis, axis=-1) / np.maximum(n, 1),
                    1e6)
    return cost.astype(np.float32)


def match_pose_sets(ref: np.ndarray, pred: np.ndarray, thr: float = 0.5):
    """Hungarian match; returns (ref_idx, pred_idx) index arrays."""
    return linear_sum_assignment(pose_set_cost_matrix(ref, pred, thr))


def pose_distance_2d(pose1: np.ndarray, pose2: np.ndarray,
                     thr: float = 0.5) -> float:
    """Distance between two (J, 3) poses over mutually visible joints;
    99999 when none are shared.

    Parity note: the reference metric (alphapose.py:101-116) reduces
    over JOINTS first and coordinates second — it is the sum over x/y
    of the joint-axis L2 norm of masked differences, divided by the
    visible count. Reproduced exactly because the tracking gate
    compares it against velocity-based thresholds.
    """
    mask = ((pose1[:, 2] > thr) & (pose2[:, 2] > thr)).astype(np.float32)
    if mask.sum() < 1:
        return SENTINEL_DISTANCE
    diff = (pose1[:, :2] - pose2[:, :2]) * mask[:, None]
    per_coord = np.sqrt(np.sum(diff ** 2, axis=0))   # (2,)
    return float(np.sum(per_coord) / mask.sum())

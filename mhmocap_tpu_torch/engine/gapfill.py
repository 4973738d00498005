"""Post-fit gap interpolation for detection-dropout spans.

A copy of the numpy-only `mhmocap_tpu/engine/gapfill.py`, kept in the
port so that it imports nothing of the JAX package.

The reference has no analog: when a tracked person has no 2D evidence
for a span of frames, the reference's ingestion holds them at the last
seen pose with confidence 0.502 — just above the 0.5 loss threshold
(reference datautils.py:326-333) — so the optimizer anchors them to a
STALE position for the whole gap and snaps on re-acquisition. The
`lagged_conf_decay` ingestion knob (data/ingestion.py) releases the
stale anchor, which improves gap positions, but the temporal
regularizers then pull the unobserved span toward ZERO motion, so the
re-acquisition snap (and its jitter) survives — measured on the
round-4 degraded sweep: TS2 detection-dropout jitter 76.0 mm, TS4
leave/re-enter 56.4 mm vs the ~12 mm clean band (docs/PARITY.md).

This module closes the snap from the other side: a HOST-SIDE post-fit
pass over the exported optvars that replaces each unobserved span's
trajectory with an interpolation between its two observed endpoints —
linear for the root translation, per-joint quaternion slerp for the
SMPL axis-angle poses. Spans touching the sequence boundary (a person
not yet entered, or gone for good) hold the nearest observed frame.
Observed frames are never touched, so clean sequences (no stale
frames) are bit-identical. Opt-in via the `gap_interpolate` config
knob (engine/predictor.py); the stale-frame mask is
`SequenceArrays.lagged_tn` from ingestion.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# axis-angle <-> quaternion (host numpy; scalar-first quaternions)
# ---------------------------------------------------------------------------

def axis_angle_to_quat(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 4) unit quaternion (w, x, y, z)."""
    aa = np.asarray(aa, np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = 0.5 * theta
    # sin(theta/2)/theta -> 1/2 as theta -> 0 (series, exact limit)
    small = theta < 1e-8
    k = np.where(small, 0.5, np.sin(half) / np.where(small, 1.0, theta))
    return np.concatenate([np.cos(half), k * aa], axis=-1)


def quat_to_axis_angle(q: np.ndarray) -> np.ndarray:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3) axis-angle on the
    short branch (theta in [0, pi])."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    # force w >= 0: q and -q are the same rotation, w >= 0 picks the
    # short (theta <= pi) branch
    q = np.where(q[..., :1] < 0, -q, q)
    xyz = q[..., 1:]
    s = np.linalg.norm(xyz, axis=-1, keepdims=True)
    theta = 2.0 * np.arctan2(s, q[..., :1])
    small = s < 1e-8
    # theta/sin(theta/2) -> 2 as theta -> 0
    k = np.where(small, 2.0, theta / np.where(small, 1.0, s))
    return k * xyz


def slerp_axis_angle(aa0: np.ndarray, aa1: np.ndarray,
                     w: np.ndarray) -> np.ndarray:
    """Spherical interpolation between two axis-angle rotation stacks.

    aa0, aa1: (J, 3) endpoint rotations; w: (K,) weights in [0, 1].
    Returns (K, J, 3); w=0 gives aa0's rotation, w=1 gives aa1's
    (re-encoded on the short branch, same rotation matrix).
    """
    q0 = axis_angle_to_quat(aa0)                      # (J, 4)
    q1 = axis_angle_to_quat(aa1)
    dot = np.sum(q0 * q1, axis=-1, keepdims=True)     # (J, 1)
    q1 = np.where(dot < 0, -q1, q1)                   # short arc
    dot = np.abs(dot)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))        # (J, 1)
    sin_t = np.sin(theta)
    near = sin_t < 1e-6                               # ~parallel: lerp
    w = np.asarray(w, np.float64)[:, None, None]      # (K, 1, 1)
    c0 = np.where(near, 1.0 - w,
                  np.sin((1.0 - w) * theta) / np.where(near, 1.0, sin_t))
    c1 = np.where(near, w,
                  np.sin(w * theta) / np.where(near, 1.0, sin_t))
    q = c0 * q0 + c1 * q1                             # (K, J, 4)
    return quat_to_axis_angle(q)


# ---------------------------------------------------------------------------
# gap interpolation over the exported optvars
# ---------------------------------------------------------------------------

def _stale_runs(stale: np.ndarray):
    """Maximal [a, b] index runs of True in a 1-D bool array."""
    runs = []
    t, T = 0, len(stale)
    while t < T:
        if not stale[t]:
            t += 1
            continue
        a = t
        while t < T and stale[t]:
            t += 1
        runs.append((a, t - 1))
    return runs


def interpolate_gap_trajectories(
        poses_T: np.ndarray, poses_smpl: np.ndarray,
        lagged_tn: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Replace unobserved spans with endpoint interpolation.

    poses_T: (T, N, 1, 3) root translations; poses_smpl: (T, N, 72)
    SMPL axis-angle (24 joints); lagged_tn: (T, N) bool stale-frame
    mask from ingestion (True = no current-frame 2D evidence).

    Per person, each maximal stale run bounded by observed frames on
    both sides is replaced by a linear root interpolation + per-joint
    quaternion slerp between the bounding observed frames; a run
    touching the sequence boundary holds the nearest observed frame
    (no extrapolation); a person with NO observed frames is left
    untouched. Returns (poses_T, poses_smpl, frames_interpolated) as
    new arrays (inputs are not mutated), dtypes preserved.
    """
    lagged_tn = np.asarray(lagged_tn, bool)
    T, N = lagged_tn.shape
    assert poses_T.shape[:2] == (T, N), (poses_T.shape, (T, N))
    assert poses_smpl.shape[:2] == (T, N), (poses_smpl.shape, (T, N))
    poses_T = poses_T.copy()
    poses_smpl = poses_smpl.copy()
    n_fixed = 0
    for n in range(N):
        stale = lagged_tn[:, n]
        if stale.all():                       # never observed: leave
            continue
        for a, b in _stale_runs(stale):
            left = a - 1 if a > 0 else None
            right = b + 1 if b + 1 < T else None
            if left is None:                  # not yet entered: hold
                poses_T[a:b + 1, n] = poses_T[right, n]
                poses_smpl[a:b + 1, n] = poses_smpl[right, n]
            elif right is None:               # gone for good: hold
                poses_T[a:b + 1, n] = poses_T[left, n]
                poses_smpl[a:b + 1, n] = poses_smpl[left, n]
            else:
                w = ((np.arange(a, b + 1) - left)
                     / float(right - left))   # in (0, 1)
                poses_T[a:b + 1, n] = (
                    (1.0 - w)[:, None, None] * poses_T[left, n]
                    + w[:, None, None] * poses_T[right, n]
                ).astype(poses_T.dtype)
                aa = slerp_axis_angle(
                    poses_smpl[left, n].reshape(24, 3),
                    poses_smpl[right, n].reshape(24, 3), w)
                poses_smpl[a:b + 1, n] = aa.reshape(
                    len(w), 72).astype(poses_smpl.dtype)
            n_fixed += b - a + 1
    return poses_T, poses_smpl, n_fixed

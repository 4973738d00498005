"""ROMP per-frame SMPL prediction loading (host-side).

Port of `mhmocap_tpu/data/romp.py` (numpy).

Consumes the `ROMP_Predictions/img_%06d.npz` contract (survey §2.4):
an npz with a `results` object, in either the old per-person-dict
format (keys cam/poses/betas) or the new single-dict format (keys
cam/smpl_thetas/smpl_betas). Parity with reference
load_multiple_romp_predictions (datautils.py:129-157) and
load_multiple_bev_predictions (datautils.py:113-126).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def load_romp_prediction(path: str) -> Dict[str, np.ndarray]:
    """Load one frame's ROMP npz -> dict(cam (P,3), poses (P,72),
    betas (P,10))."""
    raw = np.load(path, allow_pickle=True)["results"]
    try:
        # old ROMP: array of per-person dicts
        cam = np.stack([raw[k]["cam"] for k in range(len(raw))], 0)
        poses = np.stack([raw[k]["poses"] for k in range(len(raw))], 0)
        betas = np.stack([raw[k]["betas"] for k in range(len(raw))], 0)
    except (IndexError, KeyError, TypeError):
        # new ROMP (>= 1.0.6): one dict of stacked arrays
        d = raw.item()
        cam, poses, betas = d["cam"], d["smpl_thetas"], d["smpl_betas"]
    return {
        "cam": np.asarray(cam, np.float32),
        "poses": np.asarray(poses, np.float32),
        "betas": np.asarray(betas, np.float32)[:, :10],
    }


def load_romp_sequence(paths: List[str]) -> List[Dict[str, np.ndarray]]:
    return [load_romp_prediction(p) for p in paths]


def load_bev_prediction(path: str) -> Dict[str, np.ndarray]:
    """BEV npz variant (always the new single-dict format)."""
    d = np.load(path, allow_pickle=True)["results"].item()
    return {
        "cam": np.asarray(d["cam"], np.float32),
        "poses": np.asarray(d["smpl_thetas"], np.float32),
        "betas": np.asarray(d["smpl_betas"], np.float32)[:, :10],
    }

"""Per-sequence arrays handed to the Predictor.

Port of the `SequenceArrays` container of
`mhmocap_tpu/data/ingestion.py`. Loading a sequence from disk
(`load_sequence`) is not ported yet; callers build the arrays in memory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class SequenceArrays:
    """All aligned per-sequence arrays (T frames, N tracked people)."""

    images: np.ndarray        # (T, H, W, 3) uint8
    depths: np.ndarray        # (T, H, W) f32 normalized disparity
    instances: np.ndarray     # (T, H, W) uint8 person labels
    seg_mask: np.ndarray      # (T, N, H, W) f32 per-person masks
    backmasks: np.ndarray     # (T, H, W) f32 background mask
    pose2d: np.ndarray        # (T, N, 17, 3)
    cam_smpl: np.ndarray      # (T, N, 3) ROMP weak-persp cams
    poses_smpl: np.ndarray    # (T, N, 72)
    betas_smpl: np.ndarray    # (T, N, 10)
    valid_smpl: np.ndarray    # (T, N, 1)
    frame_ids: np.ndarray     # (T,)
    cam: Dict = field(default_factory=dict)  # K, fov, Kd, image_size
    # (T, N) bool: person-frames with no current-frame 2D evidence
    lagged_tn: Optional[np.ndarray] = None

    @property
    def num_frames(self) -> int:
        return len(self.frame_ids)

    @property
    def num_people(self) -> int:
        return self.pose2d.shape[1]

    @property
    def image_size(self):
        return self.cam["image_size"]

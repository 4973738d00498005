"""MuPoTs-3D sequence metadata + GT slicing (host-side).

Port of `mhmocap_tpu/data/mupots.py` (numpy/scipy, unchanged).

Parity with reference load_mupots_sequence_metadata (datautils.py:27-40)
and the GT array construction in predict_mupots.py:64-73.
"""

from __future__ import annotations

import os
import numpy as np
import scipy.io as sio


def load_sequence_metadata(samples_path: str):
    """Read annot.mat / occlusion.mat / intrinsics.txt.

    Returns (annot (T, K) object array with 'annot3'/'univ_annot3'
    fields, occlusion (T, K) object array, cam_K (3, 3)).
    """
    annot = sio.loadmat(os.path.join(samples_path, "annot.mat"),
                        squeeze_me=False)["annotations"]
    occl = sio.loadmat(os.path.join(samples_path, "occlusion.mat"),
                       squeeze_me=False)["occlusion_labels"]
    assert occl.shape[0] == annot.shape[0], "sequence length mismatch"
    with open(os.path.join(samples_path, "intrinsics.txt")) as f:
        cam_K = np.array(
            [[float(v) for v in line.strip().split()] for line in f],
            np.float32)
    return annot, occl, cam_K


def slice_ground_truth(annot, occl, frame_ids):
    """Build (pose3d_gt, pose3d_univ_gt, visibility) arrays.

    Shapes (T, K, 17, 3) / (T, K, 17, 1); millimeters -> meters and
    occlusion -> visibility, as in predict_mupots.py:64-73.
    """
    frame_ids = list(frame_ids)
    T = len(frame_ids)
    K = annot.shape[1]
    pose3d = np.zeros((T, K, 17, 3), np.float32)
    pose3d_univ = np.zeros((T, K, 17, 3), np.float32)
    visibility = np.zeros((T, K, 17, 1), np.float32)
    for f in range(T):
        for i in range(K):
            entry = annot[frame_ids[f], i]
            pose3d[f, i] = entry["annot3"][0, 0].T / 1000.0
            pose3d_univ[f, i] = entry["univ_annot3"][0, 0].T / 1000.0
            visibility[f, i] = (occl[frame_ids[f], i].T == 0).astype(
                np.float32)
    return pose3d, pose3d_univ, visibility

"""SMPL body model as plain functions on torch tensors.

Port of `mhmocap_tpu/models/smpl.py`: the same `SMPLModel` fields,
`rodrigues`, `blend_shapes`, `joints_from_vertices`, the level-parallel
`rigid_transform` over the kinematic tree depth, `lbs` (with the
reference's hand-joint identity quirk) and `smpl_forward` with every
auxiliary regressor output. The pickle loader is numpy only.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], dtype=np.int32)

NUM_JOINTS = 24
NUM_BETAS = 10

VERTEX_ID_MAP = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
    "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
    "lpinky": 2673,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133,
}
EXTRA_VERTEX_IDS = np.array(
    [VERTEX_ID_MAP[k] for k in
     ("nose", "reye", "leye", "rear", "lear",
      "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
      "lthumb", "lindex", "lmiddle", "lring", "lpinky",
      "rthumb", "rindex", "rmiddle", "rring", "rpinky")],
    dtype=np.int32)

H36M_TO_J17 = np.array(
    [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9],
    dtype=np.int32)

_TENSOR_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor",
                  "lbs_weights", "faces", "extra_vertex_ids",
                  "j_reg_extra9", "j_reg_h36m17", "j_reg_alphapose",
                  "j_reg_mupots")


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL model data as tensors (V vertices, F faces, J = 24 joints,
    10 betas, 207 pose-blendshape features). `parents` is a tuple."""

    v_template: torch.Tensor          # (V, 3)
    shapedirs: torch.Tensor           # (V, 3, 10)
    posedirs: torch.Tensor            # (207, V*3)
    j_regressor: torch.Tensor         # (J, V)
    lbs_weights: torch.Tensor         # (V, J)
    faces: torch.Tensor               # (F, 3) int64
    extra_vertex_ids: torch.Tensor    # (21,) int64
    parents: Tuple[int, ...]
    j_reg_extra9: Optional[torch.Tensor] = None      # (9, V)
    j_reg_h36m17: Optional[torch.Tensor] = None      # (17, V), permuted
    j_reg_alphapose: Optional[torch.Tensor] = None   # (17, V)
    j_reg_mupots: Optional[torch.Tensor] = None      # (17, V)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SMPLModel":
        moved = {k: (None if getattr(self, k) is None
                     else getattr(self, k).to(device))
                 for k in _TENSOR_FIELDS}
        return dataclasses.replace(self, **moved)

    def replace(self, **kw) -> "SMPLModel":
        return dataclasses.replace(self, **kw)


def smpl_model_from_numpy(arrays: Dict, device="cpu") -> SMPLModel:
    """Build an SMPLModel from a dict of numpy arrays named like the
    fields (e.g. the JAX package's model, field by field). Float arrays
    become float32, index arrays int64."""
    kw = {}
    for k in _TENSOR_FIELDS:
        a = arrays.get(k)
        if a is None:
            kw[k] = None
            continue
        dtype = (torch.int64 if k in ("faces", "extra_vertex_ids")
                 else torch.float32)
        kw[k] = torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)
    return SMPLModel(parents=tuple(int(p) for p in arrays["parents"]),
                     **kw)


def _dense(x) -> np.ndarray:
    if isinstance(x, _ChumpyPlaceholder):
        x = x.x
    if hasattr(x, "todense"):
        x = x.todense()
    return np.asarray(x, dtype=np.float32)


class _ChumpyPlaceholder:
    """Stand-in for chumpy.Ch when unpickling the official
    SMPL_NEUTRAL.pkl without chumpy installed; the wrapped numpy data
    lives in `.x`."""

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], np.ndarray):
            self.x = args[0]

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _ChumpyTolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyPlaceholder
        return super().find_class(module, name)


def _tree_levels(parents):
    """Joints grouped by kinematic tree depth, root excluded: a list of
    (joint_idx, parent_idx) int64 arrays, one per level."""
    parents = np.asarray(parents, dtype=np.int64)
    depth = np.zeros(len(parents), dtype=np.int64)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = []
    for d in range(1, int(depth.max()) + 1):
        idx = np.nonzero(depth == d)[0]
        levels.append((idx, parents[idx]))
    return levels


def load_smpl_model(model_path: str,
                    parameters_path: Optional[str] = None,
                    device="cpu") -> SMPLModel:
    """Load SMPL_NEUTRAL.pkl plus the optional auxiliary regressors in
    `parameters_path` (h36m17 permuted by H36M_TO_J17, alphapose and
    mupots transposed on load), as the JAX loader does."""
    if os.path.isdir(model_path):
        model_path = os.path.join(model_path, "SMPL_NEUTRAL.pkl")
    with open(model_path, "rb") as f:
        data = _ChumpyTolerantUnpickler(f, encoding="latin1").load()

    posedirs = _dense(data["posedirs"])
    parents = np.asarray(data["kintree_table"][0], dtype=np.int64)
    parents[0] = -1

    def _maybe(name, transpose=False, perm=None):
        if parameters_path is None:
            return None
        path = os.path.join(parameters_path, name)
        if not os.path.exists(path):
            return None
        arr = np.load(path).astype(np.float32)
        if transpose:
            arr = arr.T
        if perm is not None:
            arr = arr[perm]
        return arr

    return smpl_model_from_numpy(dict(
        v_template=_dense(data["v_template"]),
        shapedirs=_dense(data["shapedirs"])[:, :, :NUM_BETAS],
        posedirs=posedirs.reshape(-1, posedirs.shape[-1]).T,
        j_regressor=_dense(data["J_regressor"]),
        lbs_weights=_dense(data["weights"]),
        faces=np.asarray(data["f"], dtype=np.int64),
        extra_vertex_ids=EXTRA_VERTEX_IDS,
        parents=parents,
        j_reg_extra9=_maybe("J_regressor_extra.npy"),
        j_reg_h36m17=_maybe("J_regressor_h36m.npy", perm=H36M_TO_J17),
        j_reg_alphapose=_maybe("SMPL_AlphaPose_Regressor_RMSprop_6.npy",
                               transpose=True),
        j_reg_mupots=_maybe("SMPL_MuPoTs_Regressor_v1.npy",
                            transpose=True),
    ), device=device)


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3); the angle
    is the norm of (v + eps), which regularizes the zero rotation."""
    shifted = rot_vecs + eps
    angle = torch.sqrt(torch.sum(shifted * shifted, dim=-1, keepdim=True)
                       + 1e-30)
    axis = shifted / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([
        torch.stack([zeros, -rz, ry], dim=-1),
        torch.stack([rz, zeros, -rx], dim=-1),
        torch.stack([-ry, rx, zeros], dim=-1),
    ], dim=-2)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def blend_shapes(betas: torch.Tensor, shapedirs: torch.Tensor):
    """(B, 10) x (V, 3, 10) -> (B, V, 3)."""
    V = shapedirs.shape[0]
    flat = shapedirs.reshape(V * 3, shapedirs.shape[-1])
    return (betas @ flat.T).reshape(betas.shape[0], V, 3)


def joints_from_vertices(regressor: torch.Tensor, verts: torch.Tensor):
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.matmul(regressor, verts)


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                    parents):
    """Forward kinematics composed level by level over the tree depth
    (8 steps for SMPL instead of 23). rot_mats (B, J, 3, 3), joints
    (B, J, 3) rest pose. Returns (posed_joints (B, J, 3),
    rel_transforms (B, J, 4, 4))."""
    B, J = joints.shape[:2]
    par = torch.as_tensor(np.asarray(parents[1:], np.int64),
                          device=joints.device)
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]],
                           dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)  # (B,J,3,4)
    bottom = torch.zeros((B, J, 1, 4), dtype=joints.dtype,
                         device=joints.device)
    bottom[..., 0, 3] = 1.0
    local = torch.cat([top, bottom], dim=-2)                    # (B,J,4,4)

    world = local
    for idx, pidx in _tree_levels(parents):
        idx_t = torch.as_tensor(idx, device=joints.device)
        pidx_t = torch.as_tensor(pidx, device=joints.device)
        composed = torch.matmul(world[:, pidx_t], local[:, idx_t])
        world = world.index_copy(1, idx_t, composed)

    posed_joints = world[:, :, :3, 3]
    t_correction = torch.sum(world[:, :, :3, :3] * joints[:, :, None, :],
                             dim=-1)
    rel_t = world[:, :, :3, 3] - t_correction
    rel_transforms = torch.cat(
        [torch.cat([world[:, :, :3, :3], rel_t[..., None]], dim=-1),
         world[:, :, 3:]], dim=-2)
    return posed_joints, rel_transforms


def lbs(betas: torch.Tensor, pose: torch.Tensor, model: SMPLModel):
    """Linear blend skinning -> (verts (B, V, 3), joints (B, J, 3)).
    Like the reference, the two hand joints (22, 23) get the identity
    rotation whatever the last 6 pose entries hold."""
    B = pose.shape[0]
    v_shaped = model.v_template[None] + blend_shapes(betas, model.shapedirs)
    j_rest = joints_from_vertices(model.j_regressor, v_shaped)

    rot_body = rodrigues(pose[:, :-6].reshape(B, NUM_JOINTS - 2, 3))
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    ident = eye.expand(B, 2, 3, 3)
    rot_mats = torch.cat([rot_body, ident], dim=1)

    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
    pose_offsets = (pose_feature @ model.posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_tf = rigid_transform(rot_mats, j_rest, model.parents)

    tf_flat = rel_tf[:, :, :3, :].reshape(B, NUM_JOINTS, 12)
    T = torch.matmul(model.lbs_weights, tf_flat).reshape(B, -1, 3, 4)
    verts = torch.sum(T[..., :3] * v_posed[:, :, None, :], dim=-1) \
        + T[..., 3]
    return verts, posed_joints


def smpl_forward(model: SMPLModel, betas: torch.Tensor,
                 poses: torch.Tensor,
                 transl: Optional[torch.Tensor] = None):
    """Full SMPL forward pass; returns a dict with the JAX package's
    keys: verts, joints_smpl24, j3d and, when the regressors are
    loaded, joints_h36m17 (pelvis-centred), joints_alphapose and
    joints_mupots."""
    verts, joints24 = lbs(betas, poses, model)
    extra = verts[:, model.extra_vertex_ids]
    j3d = torch.cat([joints24, extra], dim=1)

    out = {"verts": verts, "joints_smpl24": joints24}
    if model.j_reg_h36m17 is not None:
        j_h36m = joints_from_vertices(model.j_reg_h36m17, verts)
        out["joints_h36m17"] = j_h36m - j_h36m[:, 14:15]
    if model.j_reg_alphapose is not None:
        out["joints_alphapose"] = joints_from_vertices(
            model.j_reg_alphapose, verts)
    if model.j_reg_mupots is not None:
        out["joints_mupots"] = joints_from_vertices(model.j_reg_mupots,
                                                    verts)
    if model.j_reg_extra9 is not None:
        j3d = torch.cat(
            [j3d, joints_from_vertices(model.j_reg_extra9, verts)], dim=1)
    out["j3d"] = j3d

    if transl is not None:
        out = {k: v + transl[:, None, :] for k, v in out.items()}
    return out

"""Deterministic synthetic SMPL-like body, built in numpy.

Port of `mhmocap_tpu/models/synthetic.py`: the same random draws in the
same order, so a seed and a size give the JAX builder's arrays exactly.
Vertices sit on capsules around the SMPL bones, skinning weights fall
off with distance to the joints, and faces triangulate consecutive
vertex rings with outward winding.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .smpl import SMPLModel, SMPL_PARENTS, NUM_JOINTS, NUM_BETAS, \
    smpl_model_from_numpy

_JOINT_CENTERS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.07, -0.08, 0.00],   # 1 l_hip
    [-0.07, -0.08, 0.00],  # 2 r_hip
    [0.00, 0.12, 0.00],    # 3 spine1
    [0.10, -0.48, 0.00],   # 4 l_knee
    [-0.10, -0.48, 0.00],  # 5 r_knee
    [0.00, 0.24, 0.00],    # 6 spine2
    [0.09, -0.88, -0.02],  # 7 l_ankle
    [-0.09, -0.88, -0.02], # 8 r_ankle
    [0.00, 0.30, 0.02],    # 9 spine3
    [0.11, -0.95, 0.10],   # 10 l_foot
    [-0.11, -0.95, 0.10],  # 11 r_foot
    [0.00, 0.42, 0.00],    # 12 neck
    [0.08, 0.38, 0.00],    # 13 l_collar
    [-0.08, 0.38, 0.00],   # 14 r_collar
    [0.00, 0.55, 0.03],    # 15 head
    [0.17, 0.40, 0.00],    # 16 l_shoulder
    [-0.17, 0.40, 0.00],   # 17 r_shoulder
    [0.42, 0.38, 0.00],    # 18 l_elbow
    [-0.42, 0.38, 0.00],   # 19 r_elbow
    [0.67, 0.38, 0.00],    # 20 l_wrist
    [-0.67, 0.38, 0.00],   # 21 r_wrist
    [0.75, 0.38, 0.00],    # 22 l_hand
    [-0.75, 0.38, 0.00],   # 23 r_hand
], dtype=np.float32)


def synthetic_smpl_arrays(num_vertices: int = 6890,
                          num_faces: Optional[int] = None,
                          seed: int = 0,
                          with_aux_regressors: bool = True) -> Dict:
    """The synthetic body's arrays (numpy), keyed like SMPLModel."""
    rng = np.random.RandomState(seed)
    V = num_vertices
    J = NUM_JOINTS

    parents = SMPL_PARENTS.copy()
    bone_child = np.arange(1, J)
    n_bones = len(bone_child)
    verts = np.zeros((V, 3), np.float32)
    ring = 8
    idx = np.arange(V)
    bone_of_v = (idx // ring) % n_bones
    along = ((idx // ring) // n_bones) % 16 / 15.0
    theta = (idx % ring) / ring * 2 * np.pi
    for b in range(n_bones):
        sel = bone_of_v == b
        c = bone_child[b]
        p = parents[c]
        a = _JOINT_CENTERS[p]
        d = _JOINT_CENTERS[c]
        axis = d - a
        n1 = np.cross(axis, [0.0, 0.0, 1.0])
        if np.linalg.norm(n1) < 1e-6:
            n1 = np.cross(axis, [0.0, 1.0, 0.0])
        n1 /= np.linalg.norm(n1) + 1e-9
        n2 = np.cross(axis, n1)
        n2 /= np.linalg.norm(n2) + 1e-9
        r = 0.05 + 0.02 * np.cos(3 * theta[sel])
        pos = (a[None] + along[sel, None] * axis[None]
               + r[:, None] * (np.cos(theta[sel])[:, None] * n1[None]
                               + np.sin(theta[sel])[:, None] * n2[None]))
        verts[sel] = pos
    verts += 0.002 * rng.randn(V, 3).astype(np.float32)

    d2 = np.sum((verts[:, None] - _JOINT_CENTERS[None]) ** 2, axis=-1)
    w = np.exp(-d2 / 0.02)
    w = (w / np.clip(w.sum(axis=1, keepdims=True), 1e-8, None)).astype(
        np.float32)

    jr = np.zeros((J, V), np.float32)
    near = np.argsort(d2, axis=0)[:24]
    for j in range(J):
        jr[j, near[:, j]] = 1.0 / 24

    shapedirs = 0.01 * rng.randn(V, 3, NUM_BETAS).astype(np.float32)
    posedirs = 0.001 * rng.randn(207, V * 3).astype(np.float32)

    faces = []
    num_rings = V // ring
    for r in range(num_rings - n_bones):
        if (r // n_bones) % 16 == 15:
            continue
        v0 = r * ring
        v1 = (r + n_bones) * ring
        for k in range(ring):
            k2 = (k + 1) % ring
            faces.append([v0 + k, v0 + k2, v1 + k])
            faces.append([v0 + k2, v1 + k2, v1 + k])
    faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    if num_faces is not None:
        if len(faces) >= num_faces:
            faces = faces[:num_faces]
        else:
            reps = int(np.ceil(num_faces / len(faces)))
            faces = np.tile(faces, (reps, 1))[:num_faces]

    extra_ids = rng.choice(V, size=21, replace=False).astype(np.int32)

    def _aux(j_out):
        if not with_aux_regressors:
            return None
        sel = rng.choice(V, size=j_out, replace=False)
        reg = np.zeros((j_out, V), np.float32)
        reg[np.arange(j_out), sel] = 1.0
        return reg

    return dict(
        v_template=verts.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        j_regressor=jr,
        lbs_weights=w,
        parents=parents,
        faces=faces,
        extra_vertex_ids=extra_ids,
        j_reg_extra9=_aux(9),
        j_reg_h36m17=_aux(17),
        j_reg_alphapose=_aux(17),
        j_reg_mupots=_aux(17),
    )


def make_synthetic_smpl(num_vertices: int = 6890,
                        num_faces: Optional[int] = None,
                        seed: int = 0,
                        with_aux_regressors: bool = True,
                        device="cpu") -> SMPLModel:
    """Deterministic synthetic SMPLModel on `device`."""
    return smpl_model_from_numpy(
        synthetic_smpl_arrays(num_vertices, num_faces, seed,
                              with_aux_regressors), device=device)

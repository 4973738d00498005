"""The synthetic body and its skinning, in plain numpy and torch.

A frozen copy of the port's synthetic SMPL-like body
(`models/synthetic.py`: the same random draws in the same order, so a
seed and a size give the same arrays) and a plain linear blend skinning
with a sequential kinematic chain. Nothing here imports the port. The
benchmark's generator builds its body from these arrays and hands the
same arrays to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                    16, 17, 18, 19, 20, 21], dtype=np.int64)
NUM_JOINTS = 24
NUM_BETAS = 10

_JOINT_CENTERS = np.array([
    [0.00, 0.00, 0.00], [0.07, -0.08, 0.00], [-0.07, -0.08, 0.00],
    [0.00, 0.12, 0.00], [0.10, -0.48, 0.00], [-0.10, -0.48, 0.00],
    [0.00, 0.24, 0.00], [0.09, -0.88, -0.02], [-0.09, -0.88, -0.02],
    [0.00, 0.30, 0.02], [0.11, -0.95, 0.10], [-0.11, -0.95, 0.10],
    [0.00, 0.42, 0.00], [0.08, 0.38, 0.00], [-0.08, 0.38, 0.00],
    [0.00, 0.55, 0.03], [0.17, 0.40, 0.00], [-0.17, 0.40, 0.00],
    [0.42, 0.38, 0.00], [-0.42, 0.38, 0.00], [0.67, 0.38, 0.00],
    [-0.67, 0.38, 0.00], [0.75, 0.38, 0.00], [-0.75, 0.38, 0.00],
], dtype=np.float32)


def body_arrays(num_vertices: int = 6890, seed: int = 0) -> Dict:
    """The synthetic body's numpy arrays: vertices on capsules around
    the bones, skinning weights falling off with the distance to the
    joints, faces triangulating consecutive vertex rings, and one-vertex
    joint regressors (the 17 keypoints read from `j_reg_alphapose`)."""
    rng = np.random.RandomState(seed)
    V, J = num_vertices, NUM_JOINTS
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
        a = _JOINT_CENTERS[PARENTS[c]]
        axis = _JOINT_CENTERS[c] - a
        n1 = np.cross(axis, [0.0, 0.0, 1.0])
        if np.linalg.norm(n1) < 1e-6:
            n1 = np.cross(axis, [0.0, 1.0, 0.0])
        n1 /= np.linalg.norm(n1) + 1e-9
        n2 = np.cross(axis, n1)
        n2 /= np.linalg.norm(n2) + 1e-9
        r = 0.05 + 0.02 * np.cos(3 * theta[sel])
        verts[sel] = (a[None] + along[sel, None] * axis[None]
                      + r[:, None] * (np.cos(theta[sel])[:, None] * n1[None]
                                      + np.sin(theta[sel])[:, None]
                                      * n2[None]))
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
    for r in range(V // ring - n_bones):
        if (r // n_bones) % 16 == 15:
            continue
        v0, v1 = r * ring, (r + n_bones) * ring
        for k in range(ring):
            k2 = (k + 1) % ring
            faces.append([v0 + k, v0 + k2, v1 + k])
            faces.append([v0 + k2, v1 + k2, v1 + k])
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)

    extra_ids = rng.choice(V, size=21, replace=False).astype(np.int64)

    def one_vertex_regressor(j_out):
        sel = rng.choice(V, size=j_out, replace=False)
        reg = np.zeros((j_out, V), np.float32)
        reg[np.arange(j_out), sel] = 1.0
        return reg

    # the draws keep models/synthetic.py's order: extra9, h36m17, alphapose
    # and mupots regressors
    regs = {k: one_vertex_regressor(n) for k, n in (
        ("j_reg_extra9", 9), ("j_reg_h36m17", 17), ("j_reg_alphapose", 17),
        ("j_reg_mupots", 17))}
    return dict(v_template=verts, shapedirs=shapedirs, posedirs=posedirs,
                j_regressor=jr, lbs_weights=w, parents=PARENTS.copy(),
                faces=faces, extra_vertex_ids=extra_ids, **regs)


class Body(NamedTuple):
    """The body's tensors the reference reads."""

    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, 10)
    posedirs: torch.Tensor        # (207, V*3)
    j_regressor: torch.Tensor     # (24, V)
    lbs_weights: torch.Tensor     # (V, 24)
    j_keypoints: torch.Tensor     # (17, V): the alphapose regressor
    faces: torch.Tensor           # (F, 3) int64

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]


def body_tensors(arrays: Dict, device) -> Body:
    def f32(k):
        return torch.as_tensor(arrays[k], dtype=torch.float32, device=device)
    return Body(f32("v_template"), f32("shapedirs"), f32("posedirs"),
                f32("j_regressor"), f32("lbs_weights"),
                f32("j_reg_alphapose"),
                torch.as_tensor(arrays["faces"], dtype=torch.int64,
                                device=device))


def rodrigues(rvec):
    """Axis-angle (..., 3) -> (..., 3, 3); the angle is the norm of
    rvec + 1e-8, as in SMPL."""
    v = rvec + 1e-8
    angle = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-30)
    k = v / angle
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * kx + (1.0 - c) * (kx @ kx)


def skin(body: Body, betas, poses):
    """Linear blend skinning: betas (B, 10), poses (B, 72) -> (verts
    (B, V, 3), keypoints (B, 17, 3)). The two hand joints take the
    identity rotation, as in SMPL."""
    B = poses.shape[0]
    V = body.num_vertices
    v_shaped = body.v_template + (betas @ body.shapedirs.reshape(V * 3, -1).T
                                  ).reshape(B, V, 3)
    j_rest = torch.einsum("jv,bvc->bjc", body.j_regressor, v_shaped)
    rot = rodrigues(poses[:, :66].reshape(B, 22, 3))
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    rot = torch.cat([rot, eye.expand(B, 2, 3, 3)], dim=1)
    feat = (rot[:, 1:] - eye).reshape(B, 207)
    v_posed = v_shaped + (feat @ body.posedirs).reshape(B, V, 3)

    # the kinematic chain, joint by joint in parent order
    world_r, world_t = [None] * NUM_JOINTS, [None] * NUM_JOINTS
    for j in range(NUM_JOINTS):
        p = int(PARENTS[j])
        if p < 0:
            world_r[j], world_t[j] = rot[:, j], j_rest[:, j]
        else:
            rel = j_rest[:, j] - j_rest[:, p]
            world_r[j] = world_r[p] @ rot[:, j]
            world_t[j] = world_t[p] + (world_r[p] @ rel[..., None])[..., 0]
    R = torch.stack(world_r, dim=1)                        # (B, 24, 3, 3)
    t = torch.stack(world_t, dim=1)                        # (B, 24, 3)
    t_rel = t - (R @ j_rest[..., None])[..., 0]
    A = torch.cat([R, t_rel[..., None]], dim=-1).reshape(B, NUM_JOINTS, 12)
    Tv = (body.lbs_weights @ A).reshape(B, V, 3, 4)
    verts = (Tv[..., :3] @ v_posed[..., None])[..., 0] + Tv[..., 3]
    keypoints = torch.einsum("jv,bvc->bjc", body.j_keypoints, verts)
    return verts, keypoints


def project(pts, K):
    """Pinhole projection (..., 3) -> (..., 3): pixels u, v and depth z."""
    z = pts[..., 2:3]
    uv = pts[..., :2] / z * torch.stack([K[0, 0], K[1, 1]]) + K[:2, 2]
    return torch.cat([uv, z], dim=-1)


def intrinsics(W: int, H: int, fov_deg: float) -> np.ndarray:
    """A W x H image: principal point at the centre (W / 2, H / 2),
    square pixels, focal length f = 0.5 W / tan(fov / 2) from the
    horizontal field of view `fov_deg`. At W = H this is the square
    image's f = 0.5 side / tan(fov / 2), to the bit."""
    f = 0.5 * W / np.tan(np.radians(fov_deg) / 2.0)
    return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]],
                    np.float32)

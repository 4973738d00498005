"""Sequence ingestion: load and align the four input modalities.

Port of `mhmocap_tpu/data/ingestion.py`: for one video, loads the images
(bicubic resize), the DPT disparity maps (per-frame normalization,
optional Sobel outlier removal + fill-in), the Mask2Former instance
masks (anti-glue erosion), the AlphaPose tracks and the ROMP SMPL
predictions; Hungarian-assigns SMPL predictions and instance masks to
the tracked 2D poses; imputes missing SMPL predictions from the nearest
valid frame; optionally One-Euro-smooths the 2D poses forward and
backward.

The images and label maps are decoded by `mhmocap_tpu_torch.io` (no
PIL, no OpenCV). The batched array work (JPEG reconstruction, resizes,
disparity post-processing, label morphology, the SMPL joints of the
assignment, One-Euro) runs as torch on `device`; the per-frame
bookkeeping (JSON, Hungarian assignment, the assignment loops) stays in
numpy/scipy on the host, as in the JAX package.
"""

from __future__ import annotations

import copy
import glob
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import require_device
from ..io import read_jpegs, read_png
from ..ops.cameras import (focal_from_fov, fov_from_focal,
                           weak_perspective_projection)
from ..ops.image import postprocess_dispmap, resize_bicubic, resize_nearest
from ..ops.morphology import dilate_labels, erode_labels
from ..ops.one_euro import one_euro_bidirectional
from .alphapose import load_tracking_results, merge_pose_streams, \
    tracks_to_array
from .assignment import match_pose_sets, pose_distance_2d
from .romp import load_romp_sequence

# frames per device call of the disparity post-processing (the 7x7
# window temporaries of 128 frames at 256x256 are ~1.6 GB each)
DISP_BLOCK = 128
# frames per JPEG decode and resize: a 2048x2048 MuPoTs frame takes
# ~25 MB of coefficients on the host and ~0.5 GB of device memory at the
# peak of its float64 reconstruction and float32 resize (1.9 GiB for 4
# frames on an H100), so a block peaks near 4 GB
IMAGE_BLOCK = 8


# ---------------------------------------------------------------------------
# Modality loaders
# ---------------------------------------------------------------------------

def load_images(paths: List[str], resize_factor: float,
                device="cpu") -> np.ndarray:
    """Bicubic-resized RGB frames -> (T, H, W, 3) uint8; the sizes are
    int(round(resize_factor * side)) as the JAX loader's. Frames are
    decoded and resized IMAGE_BLOCK at a time, so only one block is
    held at full resolution."""
    blocks = []
    for i in range(0, len(paths), IMAGE_BLOCK):
        stack = np.stack(read_jpegs(paths[i:i + IMAGE_BLOCK], device), axis=0)
        if abs(resize_factor - 1.0) > 1e-3:
            h, w = stack.shape[1:3]
            size = (int(round(resize_factor * w)),
                    int(round(resize_factor * h)))
            stack = resize_bicubic(torch.as_tensor(stack, device=device),
                                   size).cpu().numpy()
        blocks.append(stack)
    return np.concatenate(blocks, axis=0)


def load_disparity_maps(paths: List[str], image_size: Tuple[int, int],
                        renormalize: bool = False, post_process: bool = True,
                        device="cpu") -> np.ndarray:
    """Normalized disparity maps -> (T, H, W) float32. Maps of another
    size are resized (bicubic, in float32) to `image_size` (W, H) before
    the per-frame min-max normalization; the post-processing runs in
    blocks of DISP_BLOCK frames on `device`."""
    raw = np.stack([read_png(p) for p in paths], axis=0)
    stack = raw.astype(np.float32)
    if stack.shape[1:3] != tuple(image_size)[::-1]:
        # PIL resizes the integer PNG modes to integers: round and clamp
        # the overshoot of the cubic to the PNG's range
        stack = resize_bicubic(torch.as_tensor(stack, device=device),
                               image_size).cpu().numpy()
        stack = np.clip(np.round(stack), 0, np.iinfo(raw.dtype).max)
    lo = stack.min(axis=(1, 2), keepdims=True)
    stack = (stack - lo) / np.maximum(
        stack.max(axis=(1, 2), keepdims=True) - lo, np.float32(1e-8))

    if post_process:
        stack = np.concatenate([
            postprocess_dispmap(
                torch.as_tensor(stack[i:i + DISP_BLOCK], device=device),
                minz=1, maxz=100, fillin_ksize=7).cpu().numpy()
            for i in range(0, len(stack), DISP_BLOCK)], axis=0)

    if renormalize:
        lo = stack.min(axis=(1, 2), keepdims=True)
        rng = np.maximum(stack.max(axis=(1, 2), keepdims=True) - lo,
                         1e-8)
        stack = (stack - lo) / rng
    return stack


def load_segmentation_maps(paths: List[str], image_size: Tuple[int, int],
                           fg_erode_iters: int = 3,
                           bg_erode_iters: int = 9, device="cpu"):
    """Instance + background masks -> ((T, H, W) uint8, (T, H, W) uint8):
    nearest-neighbour resize; the instance erosion starts with an
    erode/dilate-agreement pass so touching instances don't fuse; the
    background mask is eroded independently."""
    stack = np.stack([read_png(p) for p in paths], axis=0)
    inst = torch.as_tensor(stack, device=device)
    if stack.shape[1:3] != tuple(image_size)[::-1]:
        inst = resize_nearest(inst, image_size)
    back = (inst == 0).to(inst.dtype)
    if fg_erode_iters > 0:
        agree = erode_labels(inst) == dilate_labels(inst)
        inst = torch.where(agree, inst, torch.zeros_like(inst))
        if fg_erode_iters > 1:
            inst = erode_labels(inst, fg_erode_iters - 1)
    if bg_erode_iters > 0:
        back = erode_labels(back, bg_erode_iters)
    return inst.cpu().numpy(), back.cpu().numpy()


def split_instance_masks(instances: np.ndarray,
                         num_classes: Optional[int] = None) -> np.ndarray:
    """(T, H, W) labels -> (T, N, H, W) per-person binary float masks
    (reference decouple_instance_segmentation_masks, utils.py:314-333).
    """
    if num_classes is None:
        num_classes = int(instances.max())
    cls = np.arange(1, num_classes + 1)
    return (instances[:, None] == cls[None, :, None, None]).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Cross-modality assignment
# ---------------------------------------------------------------------------

def assign_instances_to_poses(instances: np.ndarray, pose2d: np.ndarray,
                              thr: float = 0.5) -> np.ndarray:
    """Relabel instance masks so mask value i+1 belongs to pose i.

    Per frame, each segment votes for the person whose confident
    joints land on it most often; zero-vote segments are erased
    (reference assign_instances_to_poses_v2, datautils.py:200-244).
    """
    H, W = instances.shape[1:]
    N = pose2d.shape[1]
    out = instances.copy()
    for f in range(len(instances)):
        inst = instances[f]
        labels = np.unique(inst)
        labels = labels[labels > 0]
        if len(labels) == 0:
            continue
        remap = {}
        for c in labels:
            mask = inst == c
            votes = np.zeros((N,))
            for k in range(N):
                vis = pose2d[f, k, :, 2] > thr
                xs = np.round(np.clip(pose2d[f, k, vis, 0], 0, W - 1)
                              ).astype(int)
                ys = np.round(np.clip(pose2d[f, k, vis, 1], 0, H - 1)
                              ).astype(int)
                votes[k] = mask[ys, xs].sum()
            win = int(np.argmax(votes)) + 1
            remap[c] = win if votes[win - 1] > 0 else 0
        new_inst = np.zeros_like(inst)
        for old, new in remap.items():
            new_inst[inst == old] = new
        out[f] = new_inst
    return out


def assign_smpl_to_poses(
    smpl_preds: List[Dict[str, np.ndarray]],
    pose2d: np.ndarray,
    image_size: Tuple[int, int],
    smpl_joints_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
):
    """Assign per-frame SMPL predictions to tracked 2D poses.

    Returns (smpl_preds, pose2d, lagged_tn): lagged_tn is a (T, N)
    bool mask of person-frames whose 2D pose is a STALE copy of the
    previous frame (lagged imputation below) that was NOT refreshed by
    a matching SMPL projection — i.e. frames with no current-frame 2D
    evidence at all. Callers can use it to decay the stale
    confidences (see load_sequence's `lagged_conf_decay`).

    Behavioral parity with reference assign_smpl_to_poses
    (datautils.py:247-361):
      * pad missing SMPL slots with zeros + valid=0;
      * project each SMPL body's sparse joints with its weak-persp cam
        and Hungarian-match against the tracked poses (SMPL joints get
        confidence 0.502, matched with thr=0.501 so only real 2D
        joints above ~0.5 participate);
      * frames with a lost 2D track inherit the previous frame's pose
        at confidence <= 0.502 ('lagged'); if the matched SMPL
        projection is close (< 5% of image size) it replaces the
        lagged pose;
      * afterwards, still-missing SMPL predictions are copied from the
        nearest valid frame (marked valid=0.51).

    `smpl_joints_fn(betas (P,10), poses (P,72)) -> (P, 17, 3)` supplies
    the sparse joint regressor (kept injectable so ingestion has no
    hard dependency on the device model).
    """
    smpl_preds = copy.deepcopy(smpl_preds)
    pose2d = pose2d.copy()
    T = len(pose2d)
    N = pose2d.shape[1]

    # Pass 1: pad every frame's predictions to one common body count M
    # (pure numpy, no sequential dependency). M can exceed N when a
    # frame carries more SMPL/ROMP detections than tracked people —
    # the Hungarian match in pass 2 then selects the best N (same as
    # the reference's per-frame `smpl[key][order]` trim).
    M = max([N] + [len(smpl_preds[f]["poses"]) for f in range(T)])
    for f in range(T):
        smpl = smpl_preds[f]
        smpl["valid"] = np.ones((len(smpl["poses"]), 1), np.float32)
        if len(smpl["poses"]) < M:
            miss = M - len(smpl["poses"])
            for key, fillval in (("cam", 1.0), ("valid", 0.0),
                                 ("poses", 0.0), ("betas", 0.0)):
                pad = np.full((miss,) + smpl[key].shape[1:], fillval,
                              smpl[key].dtype)
                smpl[key] = np.concatenate([smpl[key], pad], axis=0)

    # one batched sparse-joint regression + weak-perspective projection
    # of all T*M bodies (the joints function runs on the device)
    betas_all = np.concatenate([smpl_preds[f]["betas"]
                                for f in range(T)], axis=0)
    poses_all = np.concatenate([smpl_preds[f]["poses"]
                                for f in range(T)], axis=0)
    cams_all = np.concatenate([smpl_preds[f]["cam"]
                               for f in range(T)], axis=0)
    joints3d_all = np.asarray(smpl_joints_fn(betas_all, poses_all))
    joints2d_all = weak_perspective_projection(
        torch.from_numpy(np.ascontiguousarray(joints3d_all, np.float32)),
        torch.from_numpy(cams_all), image_size).numpy().reshape(
            T, M, -1, 2)

    # Pass 2: the sequential per-frame assignment (lagged-track
    # imputation reads the previous frame's already-updated pose).
    lagged_tn = np.zeros((T, N), bool)
    for f in range(T):
        smpl = smpl_preds[f]
        p2d = pose2d[f]
        n_people = N
        joints2d = joints2d_all[f]

        # lagged-track imputation for lost 2D poses. Frame 0 has no
        # previous pose to copy (the reference leaves it zero,
        # datautils.py:305 guards f > 0 — reproduced), but a person
        # with no frame-0 evidence is still STALE for lagged_tn
        # purposes: without the flag, a not-yet-entered person's stale
        # run starts at t=1 with frame 0 treated as observed, so
        # gapfill interpolates from frame 0's unconstrained fitted
        # pose instead of holding the true entry pose.
        lagged = np.zeros((n_people,), bool)
        missing = np.sum(p2d[..., 2] >= 0.2, axis=1) < 2
        lagged[missing] = True
        if f > 0 and missing.any():
            prev = pose2d[f - 1][missing].copy()
            prev[..., 2] = np.clip(prev[..., 2], 0, 0.502)
            p2d[missing] = prev

        conf = 0.502 * smpl["valid"][:, :, None] * np.ones(
            (joints2d.shape[0], joints2d.shape[1], 1), np.float32)
        smpl_as_pose = np.concatenate([joints2d, conf], axis=-1)
        ref_idx, pred_idx = match_pose_sets(p2d, smpl_as_pose, thr=0.501)
        order = pred_idx[ref_idx]
        for key in smpl:
            smpl[key] = smpl[key][order]

        stale = lagged.copy()
        if lagged.any():
            smpl_as_pose = smpl_as_pose[order]
            for n in range(n_people):
                if lagged[n] and pose_distance_2d(
                        p2d[n], smpl_as_pose[n], thr=0.501) \
                        < 0.05 * max(image_size):
                    p2d[n] = smpl_as_pose[n]
                    # refreshed from a current-frame SMPL detection —
                    # not stale for lagged_tn purposes
                    stale[n] = False
        lagged_tn[f] = stale

        pose2d[f] = p2d
        smpl_preds[f] = smpl

    # Impute still-missing SMPL predictions from the nearest valid frame
    N = len(smpl_preds[0]["poses"])
    valid_tn = np.array([[smpl_preds[f]["valid"][n].squeeze()
                          for n in range(N)] for f in range(T)])
    for f in range(T):
        for n in range(N):
            if valid_tn[f, n] >= 1e-4:
                continue
            # Scan outward for the nearest valid frame; past frames win
            # ties, and (reference parity) frame 0 is never used as a
            # source.
            src = None
            for k in range(1, T - 1):
                if f - k > 0 and valid_tn[f - k, n] > 0.7:
                    src = f - k
                    break
                if f + k < T and valid_tn[f + k, n] > 0.7:
                    src = f + k
                    break
            if src is None:
                continue
            smpl_preds[f]["valid"][n] = 0.51
            for key in ("cam", "poses", "betas"):
                smpl_preds[f][key][n] = smpl_preds[src][key][n].copy()

    return smpl_preds, pose2d, lagged_tn


# ---------------------------------------------------------------------------
# Full-sequence assembly
# ---------------------------------------------------------------------------

def decay_lagged_confidences(pose2d: np.ndarray, lagged_tn: np.ndarray,
                             decay: float) -> np.ndarray:
    """Scale the k-th consecutive STALE (lagged, unrefreshed) frame's
    2D confidences by decay**k, per person; runs reset on any frame
    with real evidence. See load_sequence's `lagged_conf_decay`."""
    pose2d = pose2d.copy()
    run = np.zeros(pose2d.shape[1], np.float32)
    for f in range(len(pose2d)):
        run = np.where(lagged_tn[f], run + 1.0, 0.0)
        pose2d[f, ..., 2] *= decay ** run[:, None]
    return pose2d


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


def load_sequence(
    data_root: str,
    smpl_joints_fn: Callable,
    cam_K: Optional[np.ndarray] = None,
    cam_dist_coef=None,
    fov: float = 60.0,
    frame_ids=None,
    max_num_people: Optional[int] = None,
    resize_factor: float = 0.25,
    images_path: str = "images",
    alphapose_path: str = "AlphaPose",
    hrnet_pose_path: str = "HRNet2DPose",
    use_hrnet_pose: bool = False,
    joint_confidence_thr: float = 0.5,
    depth_path: str = "DPT_large_monodepth",
    smpl_pred_path: str = "ROMP_Predictions",
    segmentation_path: str = "Mask2Former_Instances",
    erode_segmentation_iters: int = 0,
    erode_backmask_iters: int = 0,
    renormalize_depth: bool = True,
    post_process_depth: bool = True,
    filter_2dpose: bool = False,
    filter_min_cutoff: float = 0.004,
    filter_beta: float = 30.0,
    min_visibility_fraction: float = 1.0 / 8,
    lagged_conf_decay: float = 1.0,
    id_swap_fix: float = 0.0,
    verbose: bool = True,
    device="cuda",
    timings: Optional[Dict[str, float]] = None,
) -> SequenceArrays:
    """Load and align a full sequence; the arguments are the JAX
    `load_sequence`'s (see its docstring for `lagged_conf_decay` and
    `id_swap_fix`), plus the torch `device` of the batched array work.
    `smpl_joints_fn(betas (P, 10), poses (P, 72)) -> (P, 17, 3)` gives
    the AlphaPose-layout joints of the assignment. A `timings` dict, if
    given, receives the seconds spent decoding files ("decode"),
    post-processing disparity and label maps ("postprocess") and
    assigning tracks, SMPL predictions and masks ("assignment"). The
    device is the GPU unless the caller passes device="cpu"."""
    device = require_device(device)
    t_start = time.time()
    all_names = sorted(os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(
                           os.path.join(data_root, images_path,
                                        "*.jpg")))
    if frame_ids is not None and len(frame_ids) > 0:
        names = [all_names[i] for i in frame_ids]
    else:
        names = all_names
        frame_ids = range(len(names))

    images = load_images(
        [os.path.join(data_root, images_path, s + ".jpg") for s in names],
        resize_factor, device=device)
    image_size = images.shape[1:3][::-1]  # (W, H)
    t_images = time.time()

    depths = load_disparity_maps(
        [os.path.join(data_root, depth_path, s + ".png") for s in names],
        image_size, renormalize=renormalize_depth,
        post_process=post_process_depth, device=device)

    instances, backmasks = load_segmentation_maps(
        [os.path.join(data_root, segmentation_path, s + ".png")
         for s in names],
        image_size, erode_segmentation_iters, erode_backmask_iters,
        device=device)
    t_maps = time.time()

    annot = load_tracking_results(
        os.path.join(data_root, alphapose_path, "alphapose-results.json"),
        coef_thr=joint_confidence_thr,
        min_size=0.15 * min(image_size) / resize_factor)
    if use_hrnet_pose:
        hrnet = load_tracking_results(
            os.path.join(data_root, hrnet_pose_path, "hrnet-results.json"),
            coef_thr=0.2,
            min_size=0.15 * min(image_size) / resize_factor,
            ignore_tracking=True)
        annot = merge_pose_streams(annot, hrnet)

    romp = load_romp_sequence(
        [os.path.join(data_root, smpl_pred_path, s + ".npz")
         for s in names])

    # image_names anchors the track array to the full frame list, so a
    # frame with zero surviving detections becomes a zero row instead of
    # shifting the tail (see tracks_to_array)
    pose2d = tracks_to_array(annot, frame_ids=list(frame_ids),
                             max_num_people=max_num_people,
                             verbose=verbose,
                             image_names=[n + ".jpg"
                                          for n in all_names],
                             id_swap_fix=id_swap_fix)
    pose2d[..., 0:2] *= resize_factor

    # joints outside the frame are not visible
    pose2d[..., 2] *= ((pose2d[..., 0] >= 0)
                       * (pose2d[..., 0] < image_size[0] - 1)
                       * (pose2d[..., 1] >= 0)
                       * (pose2d[..., 1] < image_size[1] - 1))

    # drop people visible in too few frames
    pvis = (pose2d[..., 2] > joint_confidence_thr).max(axis=2).mean(axis=0)
    pose2d = pose2d[:, pvis >= min_visibility_fraction]

    romp, pose2d, lagged_tn = assign_smpl_to_poses(romp, pose2d,
                                                   image_size,
                                                   smpl_joints_fn)
    instances = assign_instances_to_poses(instances, pose2d)

    if filter_2dpose:
        pose2d = _filter_pose2d(pose2d, image_size, joint_confidence_thr,
                                filter_min_cutoff, filter_beta, device)

    if lagged_conf_decay < 1.0:
        # decay the stale-anchor confidences last, so that everything
        # upstream sees the reference values
        pose2d = decay_lagged_confidences(pose2d, lagged_tn,
                                          lagged_conf_decay)

    seg_mask = split_instance_masks(instances,
                                    num_classes=pose2d.shape[1])

    if cam_K is not None:
        cam_K = resize_factor * np.asarray(cam_K, np.float32)
        cam_K[2, 2] = 1.0
        fov = fov_from_focal(min(image_size), min(cam_K[0, 0],
                                                  cam_K[1, 1]))
    else:
        f = focal_from_fov(min(image_size), fov)
        cam_K = np.array([[f, 0, image_size[0] / 2],
                          [0, f, image_size[1] / 2],
                          [0, 0, 1]], np.float32)

    seq = SequenceArrays(
        images=images,
        depths=depths.astype(np.float32),
        instances=instances,
        seg_mask=seg_mask,
        backmasks=backmasks.astype(np.float32),
        pose2d=pose2d.astype(np.float32),
        cam_smpl=np.stack([d["cam"] for d in romp]).astype(np.float32),
        poses_smpl=np.stack([d["poses"] for d in romp]).astype(np.float32),
        betas_smpl=np.stack([d["betas"] for d in romp]).astype(np.float32),
        valid_smpl=np.stack([d["valid"] for d in romp]).astype(np.float32),
        frame_ids=np.asarray(list(frame_ids), int),
        cam={"K": cam_K, "fov": fov, "Kd": cam_dist_coef,
             "image_size": tuple(image_size)},
        lagged_tn=lagged_tn,
    )
    if timings is not None:
        t_end = time.time()
        timings.update(decode=t_images - t_start,
                       postprocess=t_maps - t_images,
                       assignment=t_end - t_maps, total=t_end - t_start)
    return seq


def _filter_pose2d(pose2d, image_size, joint_thr, min_cutoff, beta,
                   device="cpu"):
    """Forward + backward One-Euro smoothing of the normalized 2D poses
    on `device`."""
    W, H = image_size
    T, N = pose2d.shape[:2]
    norm = pose2d[..., 0:2] / np.array([W, H], np.float32)
    valid = np.repeat(pose2d[..., 2:] > joint_thr, 2, axis=-1)
    smoothed = one_euro_bidirectional(
        torch.as_tensor(norm.reshape(T, N * 17, 2), device=device),
        torch.as_tensor(valid.reshape(T, N * 17, 2).astype(np.float32),
                        device=device),
        min_cutoff=min_cutoff, beta=beta).cpu().numpy()
    out = pose2d.copy()
    out[..., 0:2] = smoothed.reshape(T, N, 17, 2) * np.array(
        [W, H], np.float32)
    return out

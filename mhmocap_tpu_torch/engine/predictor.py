"""Prediction driver: init solve + stage-1 fit + output pickles.

Port of `mhmocap_tpu/engine/predictor.py` on a single device: window
sizing, `run` (init solve, `optvar_init.pkl`, the stage-1 fit,
`optvar_stage1.pkl` with the JAX package's schema) and `fit`, the cycle
loop. Checkpoints, visualizations and profiler traces are not ported
yet and raise NotImplementedError.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.ingestion import SequenceArrays
from ..models.smpl import SMPLModel
from ..ops.image import fillin_masked
from ..ops.rasterizer import preorder_faces
from . import optimizer as E


def tune_time_layout(T: int, user_bucket: int = 0, batch_size: int = 10):
    """(chunk, frame_bucket) for a T-frame fit on one device: the
    user's bucket with chunk = batch_size, or else the chunk in [16, 48]
    (2..8 below 32 frames) that minimizes the padded length, preferring
    larger chunks on ties."""
    T = int(T)
    if user_bucket:
        return max(int(batch_size), 2), user_bucket
    cands = range(2, 9) if T < 32 else range(16, 49)
    chunk = min(cands, key=lambda c: (-(-T // c) * c, -c))
    return chunk, chunk


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to mhmocap_tpu_torch "
                              f"yet (see ROADMAP.md)")


class Predictor:
    """Run the init solve and the stage-1 fit for one sequence on
    `device`."""

    def __init__(self, seq: SequenceArrays, model: SMPLModel,
                 output_path: str, parsed_args, device="cpu", **_):
        if getattr(parsed_args, "save_visualizations", False):
            _not_ported("save_visualizations")
        if int(getattr(parsed_args, "checkpoint_every", 0) or 0) > 0:
            _not_ported("checkpoint_every")
        if getattr(parsed_args, "profile_dir", None):
            _not_ported("profile_dir")
        if getattr(parsed_args, "gap_interpolate", False):
            _not_ported("gap_interpolate")
        os.makedirs(output_path, exist_ok=True)
        self.device = torch.device(device)
        self.seq = seq
        self.model = preorder_faces(model).to(self.device)
        self.output_path = output_path
        self.args = parsed_args
        self.num_iter = parsed_args.num_iter

        W, H = seq.image_size
        chunk, bucket = tune_time_layout(
            int(seq.num_frames),
            int(getattr(parsed_args, "frame_bucket", 0) or 0),
            batch_size=int(getattr(parsed_args, "batch_size", 10)))
        self.cfg = E.EngineConfig(
            image_size=(W, H),
            num_people=seq.num_people,
            num_frames=seq.num_frames,
            chunk=chunk,
            frame_bucket=bucket,
            window=self._sized_window(seq, parsed_args),
            windows=self._person_windows(seq, parsed_args),
            joint_confidence_thr=getattr(parsed_args,
                                         "joint_confidence_thr", 0.5),
            cam_dist_coef=(tuple(seq.cam["Kd"])
                           if seq.cam.get("Kd") is not None else None),
            batch_size_ref=int(getattr(parsed_args, "batch_size", 10)),
            pose17j_weights=self._joint_weights(parsed_args,
                                                "pose17j_weights"),
            gap_aware_temporal=bool(
                getattr(parsed_args, "gap_aware_temporal", False))
            and seq.lagged_tn is not None,
        )
        self.coefs = {
            "proj2d": parsed_args.proj2d_loss_coef,
            "depth": parsed_args.depth_loss_coef,
            "silhouette": parsed_args.silhouette_loss_coef,
            "reg_poses": parsed_args.reg_poses_coef,
            "reg_scales": parsed_args.reg_scales_coef,
            "reg_velocity": parsed_args.reg_velocity_coef,
            "reg_verts_filter": parsed_args.reg_verts_filter_coef,
            "reg_contact": parsed_args.reg_contact_coef,
            "reg_foot_sliding": parsed_args.reg_foot_sliding_coef,
        }
        self.bench_window_seconds = None

    # ------------------------------------------------------------------
    @staticmethod
    def _joint_weights(parsed_args, name):
        w = getattr(parsed_args, name, None)
        if w is None:
            return None
        return tuple(float(x) for x in w)

    # ------------------------------------------------------------------
    def _sized_window(self, seq: SequenceArrays, parsed_args) -> int:
        """Shared raster window: the base size grown to the 99th
        percentile of 1.3x the visible-keypoint bbox extent, in
        multiples of 8, capped to the image; records the clip rate."""
        W, H = seq.image_size
        base = int(getattr(parsed_args, "raster_window", 128))
        cap = max(8, (min(W, H) // 8) * 8)

        extent, ok = self._bbox_need(seq, parsed_args)
        extent = extent[ok]
        need = 1.3 * extent if extent.size else np.zeros((1,))
        req = float(np.percentile(need, 99)) if need.size else 0.0

        win = max(8, (int(max(base, int(np.ceil(req)))) + 7) // 8 * 8)
        win = min(win, cap)
        self.window_clip_rate = (float(np.mean(need > win))
                                 if need.size else 0.0)
        if win > base:
            print(f"raster window grown {base} -> {win} px to cover "
                  f"observed person bboxes")
        if self.window_clip_rate > 0.0:
            print(f"WARNING: {100 * self.window_clip_rate:.2f}% of "
                  f"person-frame bboxes exceed the {win} px raster "
                  f"window; their depth/silhouette supervision is "
                  f"clipped to the window")
        return win

    # ------------------------------------------------------------------
    def _person_windows(self, seq: SequenceArrays, parsed_args):
        """Per-person raster windows from each person's own bbox need,
        snapped to multiples of 16 (the kernels' 16 px cells) between
        48 px and the image."""
        self.window_clip_rates = None
        if not getattr(parsed_args, "per_person_window", True):
            return None
        W, H = seq.image_size
        base = int(getattr(parsed_args, "raster_window", 128))
        cap = max(16, (min(W, H) // 16) * 16)
        floor = 48

        extent, ok = self._bbox_need(seq, parsed_args)
        wins, rates = [], []
        for n in range(seq.num_people):
            need = 1.3 * extent[ok[:, n], n]
            if need.size == 0:
                wins.append(min(max(floor, -(-base // 16) * 16), cap))
                rates.append(0.0)
                continue
            req = int(np.ceil(float(np.percentile(need, 99))))
            w = min(max(floor, -(-req // 16) * 16), cap)
            wins.append(w)
            rates.append(float(np.mean(need > w)))
        self.window_clip_rates = tuple(rates)
        wins = tuple(wins)
        for n, r in enumerate(rates):
            if r > 0.0:
                print(f"WARNING: {100 * r:.2f}% of person {n}'s frame "
                      f"bboxes exceed their {wins[n]} px raster "
                      f"window; their depth/silhouette supervision is "
                      f"clipped to the window")
        if len(set(wins)) > 1:
            print(f"per-person raster windows: {wins} px")
        return wins

    # ------------------------------------------------------------------
    @staticmethod
    def _bbox_need(seq: SequenceArrays, parsed_args):
        """(extent (T, N) px, ok (T, N)): max visible-keypoint bbox side
        and whether the person-frame has >= 2 confident joints."""
        W, H = seq.image_size
        thr = getattr(parsed_args, "joint_confidence_thr", 0.5)
        vis = seq.pose2d[..., 2] > thr
        uv = seq.pose2d[..., :2]
        big = np.asarray([W + H], np.float32)
        lo = np.min(np.where(vis[..., None], uv, big), axis=2)
        hi = np.max(np.where(vis[..., None], uv, -big), axis=2)
        extent = np.max(hi - lo, axis=-1)
        ok = np.sum(vis, axis=-1) >= 2
        return extent, ok

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, verbose: bool = True) -> Dict:
        seq, cfg = self.seq, self.cfg
        verbose = verbose and getattr(self.args, "verbose", True)
        t0 = time.time()
        params, init_hist, optimize_scale = E.init_params(
            self.model, seq.pose2d, seq.poses_smpl, seq.betas_smpl,
            seq.cam["K"], cfg,
            scale_factor=getattr(self.args, "scale_factor", None),
            num_iter=100)
        self.init_seconds = time.time() - t0
        if verbose:
            print(f"init solve: {self.init_seconds:.1f}s", flush=True)

        init_optvar = E.get_optimized_variables(params, cfg,
                                                seq.valid_smpl)
        init_optvar["pose2d"] = seq.pose2d
        with open(os.path.join(self.output_path, "optvar_init.pkl"),
                  "wb") as f:
            pickle.dump(init_optvar, f)
        init_log = [{"loss_2d": v} for v in init_hist]

        t1 = time.time()
        log, scene_host = self.fit(params, optimize_scale, verbose=verbose)
        params = self._params
        if verbose:
            print(f"stage-1 fit: {time.time() - t1:.1f}s", flush=True)

        stage1_optvar = E.get_optimized_variables(
            params, cfg, seq.valid_smpl, scene=scene_host)
        stage1_optvar["raster_window"] = cfg.window
        stage1_optvar["window_clip_rate"] = self.window_clip_rate
        stage1_optvar["raster_windows"] = cfg.person_windows
        stage1_optvar["window_clip_rates"] = self.window_clip_rates
        if seq.lagged_tn is not None:
            stage1_optvar["lagged_tn"] = np.asarray(seq.lagged_tn)
        with open(os.path.join(self.output_path, "optvar_stage1.pkl"),
                  "wb") as f:
            pickle.dump(stage1_optvar, f)

        return {
            "init_log_loss": init_log,
            "init_optvar": init_optvar,
            "stage1_log": log,
            "stage1_optvar": stage1_optvar,
        }

    # ------------------------------------------------------------------
    def fit(self, params: E.StageParams, optimize_scale: bool,
            verbose: bool = True):
        """The stage-1 cycle loop. With `bench_cycles` in the args, the
        loop synchronizes at those cycle boundaries (a boundary equal to
        `num_iter` marks the end of the loop) and records the wall time
        of each window between them in `bench_window_seconds`."""
        seq, cfg, model = self.seq, self.cfg, self.model
        data = E.prepare_seq_data(seq, cfg, self.device)
        betas_ref = torch.as_tensor(
            np.mean(seq.betas_smpl, axis=0, keepdims=True).astype(
                np.float32), device=self.device)
        aux = E.init_aux(cfg, model.num_vertices, betas_ref)
        opt_state = E.rmsprop_init(params)

        bench_set = set(getattr(self.args, "bench_cycles", None) or ())
        bench_marks = []

        def mark(cycle):
            if cycle in bench_set and cycle > 0:
                self._sync()
                bench_marks.append(time.time())
                self.bench_window_seconds = [
                    b - a for a, b in zip(bench_marks, bench_marks[1:])]

        parts_log, losses = [], []
        t_start = time.time()
        for cycle in range(self.num_iter):
            mark(cycle)
            params, opt_state, aux, loss, parts = E.stage1_cycle_fused(
                params, opt_state, aux, cycle, model, data, self.coefs,
                cfg, optimize_scale=optimize_scale)
            parts_log.append(parts)
            losses.append(loss)
            if verbose and (cycle % 25 == 0 or cycle == self.num_iter - 1):
                print(f"cycle {cycle:4d} loss={float(loss):.4f} "
                      f"({(time.time() - t_start):.1f}s)", flush=True)
        mark(self.num_iter)

        log = ([dict(zip(E.LOG_KEYS, row))
                for row in torch.stack(parts_log).cpu().numpy().tolist()]
               if parts_log else [])
        self.stage1_losses = (torch.stack(losses).cpu().numpy()
                              if losses else np.zeros((0,), np.float32))
        self._params = params
        self._aux = aux
        return log, self._final_scene(params, data, aux)

    # ------------------------------------------------------------------
    def _final_scene(self, params, data, aux) -> Optional[Dict]:
        """Median background image over time + fill-in, plus the last
        scene depth, for the output pickle."""
        seq = self.seq
        if not aux.have_scene:
            return None
        backmask = seq.backmasks > 0.5
        ma_img = np.ma.array(
            seq.images,
            mask=np.repeat((~backmask)[..., None], 3, axis=-1))
        scene_img = np.ma.median(ma_img, axis=0).data.astype(np.float32)
        scene_mask = (~np.all(backmask == 0, axis=0)).astype(np.float32)

        filled, mask_f = [], None
        mask_t = torch.as_tensor(scene_mask, device=self.device)
        for c in range(3):
            xf, mf = fillin_masked(
                torch.as_tensor(scene_img[..., c], device=self.device),
                mask_t, 11)
            filled.append(xf.cpu().numpy())
            mask_f = mf.cpu().numpy()
        return {
            "scene_depth": aux.scene.depth.cpu().numpy(),
            "scene_img": np.stack(filled, axis=-1).astype(np.uint8),
            "scene_mask": mask_f,
        }

"""Prediction driver: init solve + stage-1 fit + output pickles.

Port of `mhmocap_tpu/engine/predictor.py`: the time layout
(`tune_time_layout`), window sizing, `run` (init solve,
`optvar_init.pkl`, the stage-1 fit, `optvar_stage1.pkl` with the JAX
package's schema, the optional post-fit gap interpolation and
visualization exports) and `fit`, the cycle loop with its optional
checkpoints (`checkpoint_every`, `torch.save` in place of orbax) and a
`torch.profiler` trace of cycle 2 (`profile_dir`); and
`build_studio_sequence`, the studio-camera ingestion.

On the card the fit runs as the JAX package's does, one device program
per cycle: `fit` keeps params, RMSprop state and aux in the static
buffers of an `engine.cycle_graph.CycleGraph` and runs each cycle as one
replay of a captured CUDA graph, and the init solve replays one
captured Adam step (`cycle_graph.init_global_poses_fused`). A capture
that fails raises.
On the CPU the same static-state bodies run eagerly.

When a default process group of more than one rank is initialised (an
entry point under `torch.distributed.run`), the fit shards the time
axis over its ranks (`parallel/spmd.py`), as the JAX package does over
its devices; rank 0 alone writes the pickles, checkpoints, traces and
visualizations, from the gathered parameters. The sharded cycles run
eagerly: gloo's collectives cannot be captured (a multi-card NCCL
capture is not ported).
"""

from __future__ import annotations

import glob
import os
import pickle
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..config import require_device
from ..data.ingestion import SequenceArrays
from ..models.smpl import SMPLModel
from ..ops.image import fillin_masked
from ..ops.rasterizer import preorder_faces
from ..parallel import spmd as S
from ..viz.export import (save_visualization_init_data,
                          save_visualization_stage1)
from . import optimizer as E
from .cycle_graph import CycleGraph
from .gapfill import interpolate_gap_trajectories


def io_mkdir(path: str):
    os.makedirs(path, exist_ok=True)


def tune_time_layout(T: int, n_dev: int = 1, user_bucket: int = 0,
                     batch_size: int = 10):
    """(chunk, frame_bucket) for a T-frame fit whose time axis is sharded
    over n_dev ranks; every padded frame costs raster and SMPL work on
    its rank, so the padding is minimized.

    * n_dev == 1, user bucket: the bucket verbatim, chunk = batch_size.
    * n_dev == 1, no bucket: the chunk in [16, 48] (2..8 below 32
      frames) that minimizes the padded length, larger chunks on ties.
    * n_dev > 1, user bucket: padding lands on multiples of
      lcm(n_dev * chunk, bucket); the chunk (2..48, 2..8 below 32
      frames) minimizing the padded length, then the bucket, then the
      steps; a RuntimeWarning when the lcm inflates the bucket.
    * n_dev > 1, no bucket: the chunk in 2..48 minimizing the padding
      under padded % (n_dev * chunk) == 0 (small chunks stay candidates:
      a floor of 16 would pad T=64 on 8 ranks to 128), larger on ties.
    """
    T = int(T)
    if n_dev <= 1:
        if user_bucket:
            return max(int(batch_size), 2), user_bucket
        cands = range(2, 9) if T < 32 else range(16, 49)
        chunk = min(cands, key=lambda c: (-(-T // c) * c, -c))
        return chunk, chunk

    if user_bucket:
        cands = range(2, 9) if T < 32 else range(2, 49)

        def key(c):
            b = int(np.lcm(c * n_dev, user_bucket))
            return (-(-T // b) * b, b, -c)

        chunk = min(cands, key=key)
        bucket = int(np.lcm(chunk * n_dev, user_bucket))
        if bucket > user_bucket:
            warnings.warn(
                f"frame_bucket {user_bucket} inflated to its lcm "
                f"{bucket} with devices*chunk = {n_dev * chunk}: "
                f"sequences pad at multiples of {bucket} frames. Pick a "
                f"frame_bucket that is a multiple of {n_dev} to avoid "
                f"the padding.", RuntimeWarning)
        return chunk, bucket

    chunk = min(range(2, 49), key=lambda c: (
        -(-T // (n_dev * c)) * (n_dev * c), -c))
    return chunk, n_dev * chunk


KEEP_CHECKPOINTS = 2


def _checkpoints(ckpt_dir: str):
    """The checkpoint files of `ckpt_dir`, oldest first."""
    return sorted(glob.glob(os.path.join(ckpt_dir, "cycle_*.pt")))


def save_checkpoint(ckpt_dir: str, cycle: int, params: E.StageParams,
                    opt_state: E.RMSpropState):
    """Write (params, RMSprop state with its step count) after `cycle`
    to `ckpt_dir`/cycle_%06d.pt and keep the newest KEEP_CHECKPOINTS.
    The file is written under a temporary name and renamed, so that a
    kill mid-save leaves the previous checkpoint readable."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"cycle_{cycle:06d}.pt")
    state = {"cycle": cycle, "count": int(opt_state.count)}
    for name, tree in (("params", params), ("nu", opt_state.nu),
                       ("trace", opt_state.trace)):
        state[name] = [x.detach().cpu() for x in tree]
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _checkpoints(ckpt_dir)[:-KEEP_CHECKPOINTS]:
        os.remove(old)


def load_checkpoint(ckpt_dir: str, device):
    """(cycle, params, opt_state) of the newest checkpoint in
    `ckpt_dir`, or None when there is none."""
    found = _checkpoints(ckpt_dir)
    if not found:
        return None
    state = torch.load(found[-1], map_location=device, weights_only=True)
    params, nu, trace = (E.StageParams(*state[k])
                         for k in ("params", "nu", "trace"))
    return state["cycle"], params, E.RMSpropState(
        nu=nu, trace=trace, count=state["count"])


class Predictor:
    """Run the init solve and the stage-1 fit for one sequence on
    `device` (the GPU unless the caller passes device="cpu")."""

    def __init__(self, seq: SequenceArrays, model: SMPLModel,
                 output_path: str, parsed_args, device="cuda", **_):
        device = require_device(device)
        os.makedirs(output_path, exist_ok=True)
        self.device = device
        self.seq = seq
        self.model = preorder_faces(model).to(self.device)
        self.output_path = output_path
        self.args = parsed_args
        self.num_iter = parsed_args.num_iter
        self.save_visualizations = bool(
            getattr(parsed_args, "save_visualizations", False))

        W, H = seq.image_size
        # shard the time axis over the ranks of an initialised default
        # process group, unless the args set spmd to False
        n_dev = S.world_size()
        self.use_spmd = (bool(getattr(parsed_args, "spmd", n_dev > 1))
                         and n_dev > 1)
        self.mesh = S.default_mesh(self.device) if self.use_spmd else None
        self.writer = self.mesh is None or self.mesh.rank == 0
        chunk, bucket = tune_time_layout(
            int(seq.num_frames), n_dev if self.use_spmd else 1,
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
        # read by the loss only with gap_aware_temporal; the velocity
        # coefficient unless the config sets its own
        gap_coef = getattr(parsed_args, "reg_gap_accel_coef", None)
        self.coefs["reg_gap_accel"] = (
            parsed_args.reg_velocity_coef if gap_coef is None
            else float(gap_coef))
        self.bench_window_seconds = None
        self.export_seconds = {}

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
        verbose = (verbose and getattr(self.args, "verbose", True)
                   and self.writer)
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
        if self.writer:
            with open(os.path.join(self.output_path, "optvar_init.pkl"),
                      "wb") as f:
                pickle.dump(init_optvar, f)
        init_log = [{"loss_2d": v} for v in init_hist]
        if self.save_visualizations and self.writer:
            tv = time.time()
            save_visualization_init_data(
                self.output_path, seq, self.model, init_optvar, init_hist,
                joints_thr=cfg.joint_confidence_thr)
            self.export_seconds["init"] = time.time() - tv

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
        # post-fit gap interpolation of the unobserved spans; the frame
        # count is recorded whenever the knob is on (0: nothing stale)
        if getattr(self.args, "gap_interpolate", False):
            n_gap = 0
            if seq.lagged_tn is not None and seq.lagged_tn.any():
                (stage1_optvar["poses_T"], stage1_optvar["poses_smpl"],
                 n_gap) = interpolate_gap_trajectories(
                    stage1_optvar["poses_T"], stage1_optvar["poses_smpl"],
                    seq.lagged_tn)
            stage1_optvar["gap_interp_frames"] = n_gap
            if verbose and n_gap:
                print(f"gap_interpolate: {n_gap} unobserved person-frames "
                      f"interpolated", flush=True)
        if self.writer:
            with open(os.path.join(self.output_path, "optvar_stage1.pkl"),
                      "wb") as f:
                pickle.dump(stage1_optvar, f)

        if self.save_visualizations and self.writer:
            tv = time.time()
            save_visualization_stage1(self.output_path, seq, self.model,
                                      stage1_optvar, init_optvar["pose2d"],
                                      log)
            self.export_seconds["stage1"] = time.time() - tv

        return {
            "init_log_loss": init_log,
            "init_optvar": init_optvar,
            "stage1_log": log,
            "stage1_optvar": stage1_optvar,
        }

    # ------------------------------------------------------------------
    def fit(self, params: E.StageParams, optimize_scale: bool,
            verbose: bool = True):
        """The stage-1 cycle loop: one `CycleGraph.replay` a cycle (a
        CUDA graph replay on the card, the static-state body on the
        CPU). With `bench_cycles` in the args, the loop synchronizes at
        those cycle boundaries (a boundary equal to `num_iter` marks the
        end of the loop) and records the wall time of each window
        between them in `bench_window_seconds`.

        With `checkpoint_every` K > 0 it saves (params, RMSprop state)
        after every K-th cycle to `output_path`/ckpt, copied out of the
        static buffers, and first resumes from the newest checkpoint
        there, running only the cycles after it; the aux state (scene,
        filtered targets) is not saved and starts afresh, as in the JAX
        package. With `profile_dir` it writes a torch.profiler Chrome
        trace of cycle 2 (a replay on the card) there.

        Sharded (`use_spmd`), each rank keeps its frames of the data,
        params and RMSprop state; the bench marks synchronize and then
        wait for every rank; a checkpoint holds the gathered state, and
        every rank resumes its own frames from it; the params returned
        are the gathered ones."""
        seq, cfg, model, mesh = self.seq, self.cfg, self.model, self.mesh
        verbose = verbose and self.writer
        data = E.prepare_seq_data(seq, cfg, self.device)
        betas_ref = torch.as_tensor(
            np.mean(seq.betas_smpl, axis=0, keepdims=True).astype(
                np.float32), device=self.device)
        aux = E.init_aux(cfg, model.num_vertices, betas_ref)
        opt_state = E.rmsprop_init(params)

        ckpt_every = int(getattr(self.args, "checkpoint_every", 0) or 0)
        ckpt_dir = os.path.join(self.output_path, "ckpt")
        start_cycle = 0
        if ckpt_every > 0:
            restored = load_checkpoint(ckpt_dir, self.device)
            if restored is not None:
                last, params, opt_state = restored
                start_cycle = last + 1
                if self.writer:
                    print(f"resumed from checkpoint at cycle {last}",
                          flush=True)
        if mesh is not None:
            data, aux = S.shard_data(data, mesh), S.shard_aux(aux, mesh)
            params = S.shard_params(params, mesh)
            opt_state = S.shard_opt_state(opt_state, mesh)
            if self.writer:
                print(f"fit: sharding {cfg.padded_frames} frames over "
                      f"{mesh.size} devices", flush=True)
        else:
            graph = CycleGraph(params, opt_state, aux, model, data,
                               self.coefs, cfg, optimize_scale,
                               num_cycles=self.num_iter)
        profile_dir = getattr(self.args, "profile_dir", None)
        prof = None

        bench_set = set(getattr(self.args, "bench_cycles", None) or ())
        bench_marks = []

        def mark(cycle):
            if cycle in bench_set and cycle > 0:
                self._sync()
                if mesh is not None:
                    mesh.barrier()
                bench_marks.append(time.time())
                self.bench_window_seconds = [
                    b - a for a, b in zip(bench_marks, bench_marks[1:])]

        parts_log, losses = [], []
        t_start = time.time()
        for cycle in range(start_cycle, self.num_iter):
            mark(cycle)
            if profile_dir and cycle == 2 and self.writer:
                prof = self._start_profiler()
            if mesh is None:
                graph.replay(cycle)
                params, opt_state = graph.state.params, \
                    graph.state.opt_state()
                loss = graph.state.losses[cycle]
                parts = graph.state.parts[cycle]
            else:
                params, opt_state, aux, loss, parts = \
                    S.spmd_stage1_cycle_fused(
                        params, opt_state, aux, cycle, model, data,
                        self.coefs, cfg, mesh, optimize_scale=optimize_scale)
            if prof is not None:
                self._sync()
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                path = os.path.join(profile_dir, "trace_cycle2.json")
                prof.export_chrome_trace(path)
                print("profiler trace written to", path, flush=True)
                prof = None
            parts_log.append(parts)
            losses.append(loss)
            if ckpt_every > 0 and (cycle + 1) % ckpt_every == 0:
                self._checkpoint(ckpt_dir, cycle, params, opt_state)
            if verbose and (cycle % 25 == 0 or cycle == self.num_iter - 1):
                print(f"cycle {cycle:4d} loss={float(loss):.4f} "
                      f"({(time.time() - t_start):.1f}s)", flush=True)
        mark(self.num_iter)

        log = ([dict(zip(E.LOG_KEYS, row))
                for row in torch.stack(parts_log).cpu().numpy().tolist()]
               if parts_log else [])
        self.stage1_losses = (torch.stack(losses).cpu().numpy()
                              if losses else np.zeros((0,), np.float32))
        if mesh is not None:
            params = S.gather_params(params, mesh)
        else:
            aux = graph.aux()
        self._params = params
        self._aux = aux
        return log, (self._final_scene(aux) if self.writer else None)

    # ------------------------------------------------------------------
    def _checkpoint(self, ckpt_dir, cycle, params, opt_state):
        """save_checkpoint; sharded, of the gathered state, by rank 0,
        and every rank waits until the file is there."""
        if self.mesh is not None:
            params = S.gather_params(params, self.mesh)
            opt_state = S.gather_opt_state(opt_state, self.mesh)
        if self.writer:
            save_checkpoint(ckpt_dir, cycle, params, opt_state)
        if self.mesh is not None:
            self.mesh.barrier()

    # ------------------------------------------------------------------
    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    # ------------------------------------------------------------------
    def _final_scene(self, aux) -> Optional[Dict]:
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


def build_studio_sequence(data_path, ts_id, cam_id, smpl_joints_fn,
                          resize_factor=1.0, start_frame=0,
                          end_frame=-1, step_frame=1,
                          depth_path="DPT_midas21_monodepth",
                          erode_segmentation_iters=1,
                          erode_backmask_iters=2,
                          renormalize_depth=True,
                          post_process_depth=True,
                          device="cuda"):
    """Multi-camera studio sequence ingestion with the reference's
    hard-coded studio intrinsics (predict.py:360-397), on `device` (the
    GPU unless the caller passes device="cpu")."""
    from ..data.ingestion import load_sequence

    device = require_device(device)
    if cam_id is not None:
        data_path = os.path.join(data_path, f"seq{ts_id}", f"cam{cam_id}")
    else:
        data_path = os.path.join(data_path, f"seq{ts_id}")
    frame_ids = list(range(start_frame, end_frame, step_frame))

    W = 1028
    cam_K = np.array([
        [0.582952201 * W, 0, 0.501329839 * W],
        [0, 0.582485139 * W, 0.349481702 * W],
        [0, 0, 1]], np.float32)

    return load_sequence(
        data_path, smpl_joints_fn,
        cam_K=cam_K,
        frame_ids=frame_ids,
        depth_path=depth_path,
        resize_factor=resize_factor,
        erode_segmentation_iters=erode_segmentation_iters,
        erode_backmask_iters=erode_backmask_iters,
        renormalize_depth=renormalize_depth,
        post_process_depth=post_process_depth,
        device=device,
    )

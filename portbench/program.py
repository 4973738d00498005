"""The system under test: `mhmocap_tpu_torch`'s stage-1 fit.

The benchmark hands the port the generator's arrays as a
`SequenceArrays` and the body as an `SMPLModel`, and drives the fit as
`Predictor.fit` does: `Predictor` sizes the layout and the windows, the
init solve runs (`optimizer.init_params`), the data, aux and RMSprop
state are built, a `CycleGraph` captures every variant the run's cycles
use (`prepare`), and then each cycle is `CycleGraph.replay(cycle)`.
This module is the only one of the benchmark that imports the port.
"""

from __future__ import annotations

import tempfile
import time
import types
from typing import Dict, NamedTuple

import numpy as np
import torch


class Snapshot(NamedTuple):
    """Copies of the fit's state: params, RMSprop nu and trace, in the
    port's leaf order (poses_T, poses_smpl, betas, zmin_lin, zmax_lin,
    xscale)."""

    params: tuple
    nu: tuple
    trace: tuple


def predictor_args(config: Dict, num_iter: int):
    """The Predictor arguments of the configuration's run."""
    co = config["coefs"]
    return types.SimpleNamespace(
        num_iter=num_iter, batch_size=config["batch_size"], verbose=False,
        proj2d_loss_coef=co["proj2d"], depth_loss_coef=co["depth"],
        silhouette_loss_coef=co["silhouette"],
        reg_poses_coef=co["reg_poses"], reg_scales_coef=co["reg_scales"],
        reg_velocity_coef=co["reg_velocity"],
        reg_verts_filter_coef=co["reg_verts_filter"],
        reg_contact_coef=co["reg_contact"],
        reg_foot_sliding_coef=co["reg_foot_sliding"],
        joint_confidence_thr=config["joint_confidence_thr"],
        raster_window=config["raster_window"], spmd=False)


class Fit:
    """The port's fit of one generated video, set up to replay cycles.

    `log_len` bounds the cycles the run may replay (the device log of
    losses and parts has one row a cycle)."""

    def __init__(self, inputs: Dict[str, np.ndarray], body: Dict, config,
                 log_len: int, device):
        from mhmocap_tpu_torch.data.ingestion import SequenceArrays
        from mhmocap_tpu_torch.engine import optimizer as E
        from mhmocap_tpu_torch.engine.cycle_graph import CycleGraph
        from mhmocap_tpu_torch.engine.predictor import Predictor
        from mhmocap_tpu_torch.models.smpl import smpl_model_from_numpy

        self.device = torch.device(device)
        T, N = inputs["pose2d"].shape[:2]
        H, W = inputs["depths"].shape[1:]
        seq = SequenceArrays(
            images=np.zeros((T, H, W, 3), np.uint8),
            depths=inputs["depths"], instances=np.zeros((T, H, W), np.uint8),
            seg_mask=inputs["seg_mask"], backmasks=inputs["backmasks"],
            pose2d=inputs["pose2d"], cam_smpl=np.zeros((T, N, 3), np.float32),
            poses_smpl=inputs["poses_smpl"], betas_smpl=inputs["betas_smpl"],
            valid_smpl=inputs["valid_smpl"], frame_ids=np.arange(T),
            cam={"K": inputs["K"], "fov": config["fov_deg"], "Kd": None,
                 "image_size": (W, H)})
        model = smpl_model_from_numpy(body, device=self.device)
        with tempfile.TemporaryDirectory() as tmp:
            pred = Predictor(seq, model, tmp, predictor_args(config, log_len),
                             device=self.device)
        self.cfg, self.windows = pred.cfg, pred.cfg.person_windows
        self._sync()
        t0 = time.perf_counter()
        params, _, opt_scale = E.init_params(
            pred.model, seq.pose2d, seq.poses_smpl, seq.betas_smpl,
            seq.cam["K"], pred.cfg, num_iter=config["init_iterations"])
        self._sync()
        self.init_solve_s = time.perf_counter() - t0
        self.init_params = params
        data = E.prepare_seq_data(seq, pred.cfg, self.device)
        betas_ref = torch.as_tensor(
            np.mean(seq.betas_smpl, axis=0, keepdims=True).astype(np.float32),
            device=self.device)
        aux = E.init_aux(pred.cfg, pred.model.num_vertices, betas_ref)
        self.graph = CycleGraph(params, E.rmsprop_init(params), aux,
                                pred.model, data, pred.coefs, pred.cfg,
                                opt_scale, num_cycles=log_len)
        self.log_len = log_len

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare(self) -> float:
        """Capture every variant of the run's cycles; returns the
        captures' seconds (warm-up and capture, summed over variants)."""
        self.graph.prepare(0, self.log_len)
        return float(sum(w + c for w, c in
                         self.graph.capture_seconds.values()))

    def replay(self, cycle: int):
        self.graph.replay(cycle)

    def snapshot(self) -> Snapshot:
        st = self.graph.state
        with torch.no_grad():
            return Snapshot(*(tuple(t.clone() for t in leaves)
                              for leaves in (st.params, st.nu, st.trace)))

    def losses(self, first: int, last: int) -> torch.Tensor:
        return self.graph.state.losses[first:last].clone()

    def scene_depth(self) -> torch.Tensor:
        return self.graph.state.scene.depth.clone()

    def filtered_targets(self) -> torch.Tensor:
        return self.graph.state.verts_filt_diff.clone()

    def close(self):
        """Drop the graphs and the state."""
        self.graph = None
        self.init_params = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


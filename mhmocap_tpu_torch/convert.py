"""Carry weights and optimizer state across from the JAX package.

Numpy in, numpy (or port containers) out: nothing here imports JAX.
The parity tests use these to start both packages from identical
state.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .engine.optimizer import (PARAM_NAMES, RMSpropState, StageAux,
                               StageParams)
from .engine.scene import ScenePointCloud
from .models.smpl import smpl_model_from_numpy  # noqa: F401  (re-export)


def params_from_numpy(arrays, device="cpu") -> StageParams:
    """StageParams from numpy arrays: a sequence in field order (e.g. a
    JAX StageParams NamedTuple converted leaf by leaf) or a dict keyed
    by field name."""
    if isinstance(arrays, dict):
        vals = [arrays[k] for k in PARAM_NAMES]
    else:
        vals = list(arrays)
    return StageParams(*[torch.from_numpy(np.array(v, np.float32)).to(device)
                         for v in vals])


def params_to_numpy(params: StageParams) -> Dict[str, np.ndarray]:
    return {k: getattr(params, k).detach().cpu().numpy()
            for k in PARAM_NAMES}


def opt_state_from_optax(nu: Sequence, trace: Sequence, count: int,
                         device="cpu"):
    """The port's RMSprop state from optax's rmsprop chain state:
    `ScaleByRmsState.nu`, `TraceState.trace` (both StageParams-shaped,
    given as numpy leaves in field order) and the schedule's count."""
    return RMSpropState(
        nu=params_from_numpy(nu, device),
        trace=params_from_numpy(trace, device),
        count=int(count))


def aux_from_numpy(betas_ref, scene, have_scene, verts_filt_diff,
                   have_filters, device="cpu") -> StageAux:
    """The port's StageAux from the JAX package's, leaf by leaf as numpy:
    betas_ref (1, N, 10); scene, the ScenePointCloud's arrays in field
    order (points, valid, depth, depth_valid); verts_filt_diff
    (Tp, N, V, 3), bfloat16 or any float array holding bfloat16 values
    (cast exactly); and the have_scene / have_filters flags, which JAX
    keeps as 0/1 arrays and the port as host bools."""
    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    points, valid, depth, depth_valid = scene
    return StageAux(
        betas_ref=put(betas_ref, np.float32),
        scene=ScenePointCloud(points=put(points, np.float32),
                              valid=put(valid, bool),
                              depth=put(depth, np.float32),
                              depth_valid=put(depth_valid, bool)),
        have_scene=bool(np.asarray(have_scene)),
        verts_filt_diff=put(verts_filt_diff, np.float32).to(torch.bfloat16),
        have_filters=bool(np.asarray(have_filters)))


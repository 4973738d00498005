"""Carry weights and optimizer state across from the JAX package.

Numpy in, numpy (or port containers) out: nothing here imports JAX.
The parity tests use these to start both packages from identical
state.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .engine.optimizer import StageParams, PARAM_NAMES
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
    from .engine.optimizer import RMSpropState
    return RMSpropState(
        nu=params_from_numpy(nu, device),
        trace=params_from_numpy(trace, device),
        count=int(count))

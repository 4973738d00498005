"""Body-model resolution: real SMPL_NEUTRAL.pkl or synthetic fallback."""

from __future__ import annotations

import os

from .smpl import SMPLModel, load_smpl_model
from .synthetic import make_synthetic_smpl


def resolve_smpl_model(parameters_path: str, allow_synthetic: bool = True,
                       device="cpu") -> SMPLModel:
    """Load SMPL from `parameters_path` (SMPL_NEUTRAL.pkl plus the
    auxiliary regressor .npy files). Without the pickle, and with
    `allow_synthetic` (or MHMOCAP_SYNTHETIC_SMPL set), fall back to the
    synthetic body; MHMOCAP_SYNTHETIC_SMPL may carry a vertex count."""
    pkl = os.path.join(parameters_path, "SMPL_NEUTRAL.pkl")
    if os.path.exists(pkl):
        return load_smpl_model(pkl, parameters_path=parameters_path,
                               device=device)
    env = os.environ.get("MHMOCAP_SYNTHETIC_SMPL", "")
    if allow_synthetic or env:
        print("WARNING: SMPL_NEUTRAL.pkl not found in "
              f"{parameters_path}; using the synthetic body model. "
              "Download the real model for meaningful results.")
        num_v = int(env) if env.isdigit() and int(env) > 1 else 6890
        return make_synthetic_smpl(num_vertices=num_v, device=device)
    raise FileNotFoundError(
        f"SMPL_NEUTRAL.pkl not found under {parameters_path}")

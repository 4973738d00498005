"""Shared helpers of the parity tests between mhmocap_tpu (JAX, the
reference) and mhmocap_tpu_torch (the PyTorch port).

Both packages get the same numpy inputs; outputs come back as numpy.
Torch is capped at 2 threads because the test suite runs several
pytest-xdist workers side by side.
"""

import numpy as np
import torch

torch.set_num_threads(2)

# the fields of a JAX SMPLModel, carried across as numpy
SMPL_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor",
               "lbs_weights", "faces", "extra_vertex_ids", "j_reg_extra9",
               "j_reg_h36m17", "j_reg_alphapose", "j_reg_mupots")


def jax_model_arrays(model) -> dict:
    """A JAX SMPLModel as a dict of numpy arrays (convert.py's input)."""
    out = {k: (None if getattr(model, k) is None
               else np.asarray(getattr(model, k))) for k in SMPL_FIELDS}
    out["parents"] = np.asarray(model.parents)
    return out


def torch_model_of(jax_model):
    """The same body as a port SMPLModel on the CPU."""
    from mhmocap_tpu_torch.convert import smpl_model_from_numpy
    return smpl_model_from_numpy(jax_model_arrays(jax_model))


def t(x, dtype=torch.float32):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.array(x)).to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(a, b) -> float:
    """||a - b|| / max(||b||, tiny)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

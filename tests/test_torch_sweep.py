"""The port's sweep tiers (clean, hard, degraded, robust) against the
JAX sweep (`script/synthetic_e2e_sweep.py`), and every shipped config
through the port's Predictor with no knob refused."""

import glob
import json
import os
import pickle
import sys

import numpy as np
import pytest

from test_torch_engine import seq_arrays
from torch_parity import torch_model_of

from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch import sweep
from mhmocap_tpu_torch.config import PROJECT_DIR, parse_args
from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
from mhmocap_tpu_torch.engine.predictor import Predictor

sys.path.insert(0, os.path.join(PROJECT_DIR, "script"))
import synthetic_e2e_sweep as JS  # noqa: E402


def _final(pck, mm, jit=10.0):
    """FinalResults lists: per sequence, then a weighted average."""
    return {"pck_rel": pck + [0.0], "mm_rel_error": mm + [0.0],
            "abs_jitter": [jit] * len(pck) + [0.0]}


# the cases of JAX tests/test_sweep.py:119 and more
BOUND_CASES = {
    "clean_ok": (_final([99.0, 98.6], [40.0, 45.0]), 2, 0, False, False),
    "clean_pck_low": (_final([98.0, 98.0], [40.0, 40.0]), 2, 0, False,
                      False),
    "clean_mm_high": (_final([99.0, 99.0], [49.0, 49.0]), 2, 0, False,
                      False),
    "hard_pck_low": (_final([99.0, 99.0, 80.0], [40.0, 40.0, 60.0]), 2, 1,
                     False, False),
    "hard_alone": (_final([89.52, 99.52], [71.44, 24.29]), 0, 2, False,
                   False),
    "hard_alone_low": (_final([85.0, 90.0], [71.44, 60.0]), 0, 2, False,
                       False),
    "degraded_unpinned": (_final([90.0], [70.0], jit=50.0), 1, 0, True,
                          False),
    "robust_jitter_high": (_final([96.0], [55.0], jit=50.0), 1, 0, True,
                           True),
    "robust_ok": (_final([97.1, 97.2], [50.0, 45.0], jit=28.0), 2, 0,
                  True, True),
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_check_bounds_matches_jax(case):
    """Each tier pinned as the JAX sweep pins it: the same number of
    checks and the same violation strings."""
    final, n_std, n_hard, degraded, robust = BOUND_CASES[case]
    assert sweep.check_bounds(final, n_std, n_hard, degraded, robust) == \
        JS.check_bounds(final, n_std, n_hard, degraded, robust)


@pytest.mark.parametrize("tier,n_std,n_hard,degraded", [
    ("clean", 1, 0, False), ("hard", 0, 1, False), ("robust", 1, 0, True)])
def test_check_bounds_nan_average_violates(tier, n_std, n_hard, degraded):
    """The port's comparison is nan-safe in every tier: a nan average
    violates each bound of its tier (the JAX sweep's `v < b` passes it)."""
    nan = float("nan")
    n, v = sweep.check_bounds(_final([nan], [nan], jit=nan), n_std, n_hard,
                              degraded, robust=True)
    assert n == 2 and len(v) == 2 and all(s.startswith(tier) for s in v)


def test_bounds_and_plans_match_jax():
    assert sweep.BOUNDS == JS.BOUNDS
    for i in range(1, 11):
        assert sweep.degradation_plan(i, 60) == JS.degradation_plan(i, 60)
    for k in range(4):
        assert sweep.hard_clean_plan(k) == JS.hard_clean_plan(k)


SMOKE = ["--frames", "8", "--num_iter", "2", "--image_size", "96",
         "--num_vertices", "512", "--device", "cpu"]


def _json_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"metric"')][-1])


def test_sweep_hard_tier_alone(tmp_path, capsys, monkeypatch):
    """--num_seqs 0 --hard_clean 1 runs the hard tier alone (workdir
    suffix _hard) and checks BOUNDS["hard"] only (loosened here: a
    2-cycle CPU fit is not accurate)."""
    monkeypatch.setenv("MHMOCAP_SYNTHETIC_SMPL", "512")
    monkeypatch.setitem(sweep.BOUNDS, "hard", {
        "pck_rel": (">=", 0.0), "mm_rel_error": ("<=", 1e9)})
    final = sweep.main(["--num_seqs", "0", "--hard_clean", "1",
                        "--workdir", str(tmp_path / "w")] + SMOKE)
    out = capsys.readouterr().out
    assert "bounds OK (2 checks)" in out
    res = _json_line(out)
    assert res["sequences"] == 0 and len(res["hard_per_ts"]["pck_rel"]) == 1
    assert len(final["pck_rel"]) == 2
    assert os.path.isdir(tmp_path / "w_hard" / "out" / "TS1")


def test_sweep_degraded_tier_with_knobs(tmp_path, capsys, monkeypatch):
    """--degraded with --gap_temporal --gap_interp --lagged_decay: the
    degraded trees run with the knobs in their config, with finite
    metrics and no bound checked (no --swap_fix); the interpolation
    records its frame count in every stage-1 pickle."""
    monkeypatch.setenv("MHMOCAP_SYNTHETIC_SMPL", "512")
    sweep.main(["--num_seqs", "2", "--degraded", "--gap_temporal",
                "--gap_interp", "--lagged_decay", "0.8",
                "--workdir", str(tmp_path / "w")] + SMOKE)
    out = capsys.readouterr().out
    assert "bounds OK (0 checks)" in out
    res = _json_line(out)
    assert res["metric"] == "synthetic_e2e_sweep_degraded"
    assert res["gap_temporal"] and res["gap_interp"]
    assert np.isfinite(res["avg"]["pck_rel"])
    # the _degraded suffix goes only on the default work directory
    w = tmp_path / "w_decay_interp_gaptemporal"
    with open(w / "predict.yml") as f:
        cfg = f.read()
    for knob in ("gap_aware_temporal: true", "gap_interpolate: true",
                 "lagged_conf_decay: 0.8", "id_swap_fix: 0.0"):
        assert knob in cfg, knob
    for ts in ("TS1", "TS2"):
        with open(w / "out" / ts / "optvar_stage1.pkl", "rb") as f:
            st1 = pickle.load(f)
        assert st1["gap_interp_frames"] == st1["lagged_tn"].sum()


def test_sweep_refuses_hard_clean_with_degraded():
    with pytest.raises(SystemExit):
        sweep.main(["--num_seqs", "1", "--degraded", "--hard_clean", "1",
                    "--device", "cpu"])


CONFIGS = sorted(glob.glob(os.path.join(PROJECT_DIR, "configs", "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_config_runs_on_the_port(path, tmp_path):
    """Every shipped config, unedited but for 2 cycles, drives the
    port's Predictor on a tiny sequence with stale frames on the CPU:
    no knob is refused, and the visualizations and the robust branch
    run where the config asks for them."""
    parsed = parse_args(["--configs_yml", path, "--num_iter", "2",
                         "--device", "cpu"])
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    lag = np.zeros((8, 2), bool)
    lag[3:5, 1] = True
    pred = Predictor(TSeq(**seq_arrays(jm), lagged_tn=lag),
                     torch_model_of(jm), str(tmp_path), parsed,
                     device="cpu")
    out = pred.run(verbose=False)
    assert pred.cfg.gap_aware_temporal == bool(
        getattr(parsed, "gap_aware_temporal", False))
    names = set(os.listdir(tmp_path))
    assert {"optvar_init.pkl", "optvar_stage1.pkl"} <= names
    if parsed.save_visualizations:
        assert {"fig_optim_curves_init.png", "fig_optim_curves_stage1.png",
                "vis_init", "vis_stage1",
                "visualization_data_stage1.pkl"} <= names
    parts = np.asarray([list(r.values()) for r in out["stage1_log"]])
    assert parts.shape == (2, 10) and np.isfinite(parts).all()

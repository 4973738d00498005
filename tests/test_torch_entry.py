"""The port's entry points end to end against the JAX package's:
predict_mupots + eval_mupots on one JAX-written synthetic MuPoTs tree
(96x96, 6 frames, V=512, 4 stage-1 cycles) on the CPU, driven as
tests/test_e2e_pipeline.py drives the JAX side; and the port's sweep
bounds."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import yaml

from test_torch_predictor import _assert_pickle_close, make_args
from torch_parity import torch_model_of

import mhmocap_tpu.eval_mupots as JEM
import mhmocap_tpu.predict_internet as JPI
import mhmocap_tpu.predict_mupots as JPM
import mhmocap_tpu_torch.eval_mupots as TEM
import mhmocap_tpu_torch.predict_internet as TPI
import mhmocap_tpu_torch.predict_mupots as TPM
from mhmocap_tpu_torch.data import ingestion as TI
from mhmocap_tpu_torch.engine import predictor as TPr
from mhmocap_tpu.data.synthetic import generate_sequence
from mhmocap_tpu.eval.mupots_eval import compute_mm_pck_results as jax_mm
from mhmocap_tpu.models.smpl import smpl_forward
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch import sweep
from mhmocap_tpu_torch.eval.mupots_eval import compute_mm_pck_results
from mhmocap_tpu_torch.models.smpl import joints_function

METRICS = ("mm_abs_error", "mm_rel_error", "mm_mrpe", "pck_rel",
           "ap25_root", "abs_jitter")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mupots_data")
    jm = make_synthetic_smpl(num_vertices=512, seed=7)
    generate_sequence(str(root / "TS1"), num_frames=6, num_people=2,
                      image_size=(96, 96), model=jm, mupots_gt=True, seed=7)
    cfg = sweep.sweep_config(str(root), num_iter=4, raster_window=64,
                             batch_size=3, spmd=False)
    cfg_path = str(tmp_path_factory.mktemp("cfg") / "test.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = {k: str(tmp_path_factory.mktemp(k))
           for k in ("jax", "torch", "torch_eval_of_jax")}
    tm = torch_model_of(jm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPM, "resolve_smpl_model", lambda path: jm)
        mp.setattr(JEM, "resolve_smpl_model", lambda path: jm)
        mp.setattr(TPM, "resolve_smpl_model", lambda path: tm)
        mp.setattr(TEM, "resolve_smpl_model", lambda path: tm)
        argv = ["--configs_yml", cfg_path, "--ts_id", "1", "--output_path"]
        JPM.main(argv + [out["jax"]])
        summary = TPM.main(argv + [out["torch"], "--device", "cpu"])
        shutil.copytree(os.path.join(out["jax"], "TS1"),
                        os.path.join(out["torch_eval_of_jax"], "TS1"))
        JEM.main(["--configs_yml", cfg_path, "--input_path", out["jax"]])
        for k in ("torch", "torch_eval_of_jax"):
            TEM.main(["--configs_yml", cfg_path, "--input_path", out[k],
                      "--device", "cpu"])
    return out, jm, summary, str(root), cfg_path


def _pickle(d, name):
    with open(os.path.join(d, "TS1", name), "rb") as f:
        return pickle.load(f)


def _final(d):
    with open(os.path.join(d, "FinalResults.json")) as f:
        return json.load(f)["final_results"]


def test_predict_pickles_match(runs):
    """Same keys and shapes; optvar_init.pkl to 5e-3 and
    optvar_stage1.pkl to RMSprop's reach of 0.08 over 4 cycles (the
    tolerances of test_torch_predictor.py); mupots_annot.pkl exact."""
    out, _, summary = runs[:3]
    _assert_pickle_close(_pickle(out["torch"], "optvar_init.pkl"),
                         _pickle(out["jax"], "optvar_init.pkl"), 5e-3)
    _assert_pickle_close(_pickle(out["torch"], "optvar_stage1.pkl"),
                         _pickle(out["jax"], "optvar_stage1.pkl"), 0.08)
    got = _pickle(out["torch"], "mupots_annot.pkl")
    ref = _pickle(out["jax"], "mupots_annot.pkl")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert set(summary["ingest_seconds"]) == {"decode", "postprocess",
                                              "assignment", "total"}
    assert summary["init_seconds"] > 0


def test_final_results_match(runs):
    """Both FinalResults.json hold the same metrics, finite, for TS1 and
    the average; the port's fit lands on the JAX fit's accuracy: pck_rel
    within 1 point and the mm errors within 5 mm (the two 4-cycle fits
    differ by up to RMSprop's reach of 0.08 in their parameters). Both
    FinalResults.md tables have the same layout."""
    out = runs[0]
    got, ref = _final(out["torch"]), _final(out["jax"])
    assert set(got) == set(ref) == {m + s for m in METRICS
                                    for s in ("", "_univ")}
    for k, v in ref.items():
        assert len(got[k]) == len(v) == 2 and np.isfinite(got[k]).all()
        tol = 1.0 if k.startswith(("pck", "ap25")) else 5.0
        np.testing.assert_allclose(got[k], v, atol=tol, rtol=0, err_msg=k)
    with open(os.path.join(out["torch"], "FinalResults.md")) as a, \
            open(os.path.join(out["jax"], "FinalResults.md")) as b:
        assert [ln.split("|")[1] for ln in a] == \
            [ln.split("|")[1] for ln in b]


def test_eval_of_jax_pickles_matches(runs):
    """The port's evaluation of the JAX package's pickles: each metric,
    before the FinalResults rounding, to 1e-3 of the JAX evaluation's
    (the only difference is the SMPL joint regression of the two
    packages); the written FinalResults to one rounding step (0.01)."""
    out, jm = runs[:2]
    optvar = _pickle(out["jax"], "optvar_stage1.pkl")
    annot = _pickle(out["jax"], "mupots_annot.pkl")

    def jax_joints(b, p):
        return np.asarray(smpl_forward(jm, b, p)["joints_mupots"])

    args = (annot["pose3d_gt"], annot["visibility"])
    ref = jax_mm(optvar, *args, jax_joints, annot["cam_K"])
    got = compute_mm_pck_results(
        optvar, *args, joints_function(torch_model_of(jm), "joints_mupots"),
        annot["cam_K"])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-3), k
    fin_got, fin_ref = _final(out["torch_eval_of_jax"]), _final(out["jax"])
    assert set(fin_got) == set(fin_ref)
    for k in fin_ref:
        np.testing.assert_allclose(fin_got[k], fin_ref[k], atol=0.01 + 1e-9,
                                   rtol=0, err_msg=k)


def test_entry_points_need_a_gpu_unless_device_cpu(tmp_path):
    """No silent CPU fallback: the default --device cuda fails without a
    GPU, before anything is read or written."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "predict_mupots.yml")
    for main, extra in ((TPM.main, ["--output_path", str(tmp_path)]),
                        (TEM.main, ["--input_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--configs_yml", cfg] + extra)
    assert not os.listdir(tmp_path)


ENTRY_KW = dict(smpl_model_parameters_path="/nonexistent-synthetic",
                depth_path="DPT_large_monodepth", use_hrnet_pose=False,
                joint_confidence_thr=0.5, renormalize_depth=False,
                post_process_depth=False)


@pytest.mark.parametrize("entry", ["Predictor", "build_mupots_sequence",
                                   "build_internet_sequence",
                                   "load_sequence"])
def test_python_entry_points_default_to_the_gpu(runs, tmp_path, entry):
    """No silent CPU fallback in the Python entry points either: without
    a GPU, each one called without `device` raises, naming
    device="cpu", before it writes anything; the same call with
    device="cpu" runs. With a GPU, tests/test_torch_cuda.py checks that
    the default runs on it."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, jm, _, root, _ = runs
    tm = torch_model_of(jm)
    ts1, out = os.path.join(root, "TS1"), str(tmp_path / "out")

    def predictor(**dev):
        seq, _ = TPI.build_internet_sequence(ts1, device="cpu", **ENTRY_KW)
        return TPr.Predictor(seq, tm, out, make_args(), **dev)

    calls = {
        "Predictor": predictor,
        "build_mupots_sequence": lambda **dev: TPM.build_mupots_sequence(
            root, 1, **ENTRY_KW, **dev),
        "build_internet_sequence": lambda **dev: TPI.build_internet_sequence(
            ts1, **ENTRY_KW, **dev),
        "load_sequence": lambda **dev: TI.load_sequence(
            ts1, joints_function(tm, "joints_alphapose"), verbose=False,
            **dev),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TPM, "resolve_smpl_model", lambda path: tm)
        mp.setattr(TPI, "resolve_smpl_model", lambda path: tm)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            calls[entry]()
        assert not os.path.exists(out)
        got = calls[entry](device="cpu")
    if entry == "Predictor":
        assert got.device == torch.device("cpu") and os.path.isdir(out)
    else:
        seq = got[0] if isinstance(got, tuple) else got
        assert seq.num_frames == 6 and np.isfinite(seq.pose2d).all()


def test_predict_internet_matches(runs, tmp_path):
    """The internet-video entry point on the same tree (FOV-60 camera):
    its sequence equals the JAX one's (2D poses to 1e-4 px after the
    One-Euro smoothing), and its main writes both pickles."""
    _, jm, _, root, cfg_path = runs
    tm = torch_model_of(jm)
    kw = dict(data_path=os.path.join(root, "TS1"),
              smpl_model_parameters_path="/nonexistent-synthetic",
              depth_path="DPT_large_monodepth", use_hrnet_pose=False,
              joint_confidence_thr=0.5, renormalize_depth=False,
              post_process_depth=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPI, "resolve_smpl_model", lambda path: jm)
        mp.setattr(TPI, "resolve_smpl_model", lambda path: tm)
        ref, _ = JPI.build_internet_sequence(**kw)
        got, _ = TPI.build_internet_sequence(device="cpu", **kw)
        TPI.main(["--configs_yml", cfg_path, "--input_path",
                  os.path.join(root, "TS1"), "--output_path", str(tmp_path),
                  "--num_iter", "1", "--device", "cpu"])
    np.testing.assert_array_equal(got.cam["K"], ref.cam["K"])
    assert got.cam["fov"] == ref.cam["fov"] == 60
    np.testing.assert_allclose(got.pose2d, ref.pose2d, atol=1e-4, rtol=0)
    for f in ("instances", "poses_smpl", "valid_smpl", "depths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert sorted(os.listdir(tmp_path)) == ["optvar_init.pkl",
                                            "optvar_stage1.pkl"]


def _final_of(pck, mm):
    return {"pck_rel": list(pck) + [0.0], "mm_rel_error": list(mm) + [0.0]}


@pytest.mark.parametrize("final,n,checks,violated", [
    (_final_of([99.0, 98.6], [40.0, 47.0]), 2, 2, 0),
    (_final_of([99.0, 97.0], [40.0, 47.0]), 2, 2, 1),
    (_final_of([99.0], [60.0]), 1, 2, 1),
    (_final_of([float("nan")], [float("nan")]), 1, 2, 2),
    (_final_of([], []), 0, 0, 0),
])
def test_sweep_bounds_and_empty_tier_guard(final, n, checks, violated):
    """BOUNDS['clean'] on the unweighted average of the tier; an empty
    tier makes no check (its nan average would otherwise pass every
    `<`/`>` test), and a nan average violates its bounds."""
    got_checks, violations = sweep.check_bounds(final, n)
    assert got_checks == checks and len(violations) == violated, violations


def test_sweep_refuses_an_empty_tier():
    with pytest.raises(SystemExit):
        sweep.main(["--num_seqs", "0", "--device", "cpu"])

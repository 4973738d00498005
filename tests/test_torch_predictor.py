"""Parity of the port's Predictor and production workload with
mhmocap_tpu: time layout, window sizing, and a tiny end-to-end
Predictor.run whose output pickles are held to the JAX package's."""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from test_torch_engine import seq_arrays
from torch_parity import torch_model_of

from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
from mhmocap_tpu.engine import predictor as JPr
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
from mhmocap_tpu_torch.engine import predictor as TPr


def make_args(**kw):
    args = dict(
        num_iter=3, batch_size=10, verbose=False, spmd=False,
        save_visualizations=False, proj2d_loss_coef=1.0,
        depth_loss_coef=0.05, silhouette_loss_coef=0.1,
        reg_poses_coef=0.002, reg_scales_coef=1e-4,
        reg_velocity_coef=0.05, reg_verts_filter_coef=0.002,
        reg_contact_coef=0.001, reg_foot_sliding_coef=0.01,
        joint_confidence_thr=0.5, raster_window=32)
    args.update(kw)
    return types.SimpleNamespace(**args)


@pytest.mark.parametrize("user_bucket", [0, 64])
def test_tune_time_layout_matches(user_bucket):
    for T in (5, 8, 31, 32, 100, 201, 2300):
        assert TPr.tune_time_layout(T, 1, user_bucket, 10) == \
            JPr.tune_time_layout(T, 1, user_bucket, 10), T


def test_workload_and_config_match_bench():
    """The port's make_ts1_like_seq gives bench.py's arrays (2D poses to
    1e-3 px: the SMPL forward runs in another framework), and both
    Predictors size it the same: chunk 29 x 7 over 203 padded frames,
    per-person windows (160, 128, 112)."""
    import bench
    from mhmocap_tpu_torch import workload
    jseq, _ = bench.make_ts1_like_seq()
    tseq, tmodel = workload.make_ts1_like_seq()
    for f in ("depths", "seg_mask", "backmasks", "poses_smpl", "betas_smpl",
              "valid_smpl", "frame_ids"):
        np.testing.assert_array_equal(getattr(tseq, f), getattr(jseq, f),
                                      err_msg=f)
    np.testing.assert_allclose(tseq.pose2d, jseq.pose2d, atol=1e-3)
    np.testing.assert_array_equal(tseq.cam["K"], jseq.cam["K"])
    args = make_args(raster_window=workload.WINDOW)
    jp = JPr.Predictor.__new__(JPr.Predictor)
    tp = TPr.Predictor.__new__(TPr.Predictor)
    for p, seq in ((jp, jseq), (tp, tseq)):
        p.window_clip_rates = None
    assert tp._person_windows(tseq, args) == jp._person_windows(jseq, args) \
        == (160, 128, 112)
    assert tp._sized_window(tseq, args) == jp._sized_window(jseq, args)
    assert tmodel.num_faces == 12672


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX Predictor and the port's on one tiny sequence (3 cycles).
    The port runs twice: end to end, and with its init solve replaced by
    the JAX package's result, so that stage 1 starts from the same
    params (see test_predictor_stage1_matches)."""
    from mhmocap_tpu.engine import optimizer as JE
    from mhmocap_tpu_torch import convert
    from mhmocap_tpu_torch.engine import optimizer as TE
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    kw = seq_arrays(jm, T=10)
    dirs = {k: str(tmp_path_factory.mktemp(k))
            for k in ("jax", "torch", "torch_jax_init")}
    jpred = JPr.Predictor(JSeq(**kw), jm, dirs["jax"], make_args())
    jpred.run(verbose=False)
    tpred = TPr.Predictor(TSeq(**kw), torch_model_of(jm), dirs["torch"],
                          make_args(), device="cpu")
    tpred.run(verbose=False)

    def jax_init(model, *a, **k):
        jp, jh, opt_scale = JE.init_params(jm, *a[:4], jpred.cfg, **k)
        return (convert.params_from_numpy([np.asarray(x) for x in jp]),
                np.asarray(jh), opt_scale)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TE, "init_params", jax_init)
        TPr.Predictor(TSeq(**kw), torch_model_of(jm),
                      dirs["torch_jax_init"], make_args(),
                      device="cpu").run(verbose=False)
    out = {"cfg": (jpred.cfg, tpred.cfg)}
    for name, d in dirs.items():
        out[name] = {}
        for f in ("optvar_init.pkl", "optvar_stage1.pkl"):
            with open(os.path.join(d, f), "rb") as fh:
                out[name][f] = pickle.load(fh)
    return out


def test_predictor_config_matches(runs):
    jc, tc = runs["cfg"]
    for f in ("chunk", "frame_bucket", "window", "windows", "padded_frames",
              "num_chunks", "batch_size_ref"):
        assert getattr(tc, f) == getattr(jc, f), f


def _assert_pickle_close(got, ref, atol):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v is None or isinstance(v, (int, float, tuple)):
            assert got[k] == v, k
        else:
            assert np.shape(got[k]) == np.shape(v), k
            np.testing.assert_allclose(got[k], v, atol=atol, rtol=0,
                                       err_msg=k)


def test_predictor_init_pickle_matches(runs):
    """optvar_init.pkl end to end: same keys, arrays to 5e-3 (the init
    solve's translation tolerance, test_torch_engine)."""
    _assert_pickle_close(runs["torch"]["optvar_init.pkl"],
                         runs["jax"]["optvar_init.pkl"], 5e-3)


def test_predictor_stage1_matches(runs):
    """optvar_stage1.pkl after 3 cycles. RMSprop's first steps are
    normalized (about lr * sign(g), lr 0.01, momentum 0.9: at most ~0.08
    over 3 cycles), so a gradient component near 0 whose sign the
    float32 rounding decides moves by a full step the other way. From
    the same init params, 99% of the entries agree to 5e-3 and all to
    that reach; end to end (the init solves differ by up to 2e-3 m),
    all entries stay within the reach."""
    ref = runs["jax"]["optvar_stage1.pkl"]
    _assert_pickle_close(runs["torch"]["optvar_stage1.pkl"], ref, 0.08)
    got = runs["torch_jax_init"]["optvar_stage1.pkl"]
    _assert_pickle_close(got, ref, 0.08)
    for k, v in ref.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            close = np.abs(got[k] - v) <= 5e-3
            assert close.mean() >= 0.99, (k, close.mean())


def _tiny_predictor(out, **args):
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    return TPr.Predictor(TSeq(**seq_arrays(jm)), torch_model_of(jm),
                         str(out), make_args(**args), device="cpu")


def _stage1(out):
    with open(os.path.join(str(out), "optvar_stage1.pkl"), "rb") as fh:
        return pickle.load(fh)


def test_checkpoint_resume_equals_unbroken_run(tmp_path, capsys):
    """checkpoint_every=1: a 2-cycle run, then a 4-cycle Predictor on
    the same output_path resumes after cycle 1 and runs cycles 2 and 3
    only; its stage-1 pickle and losses equal a 4-cycle unbroken run's
    bit for bit (the RMSprop state, step count included, is restored),
    and the 2 newest checkpoints are kept."""
    whole = _tiny_predictor(tmp_path / "whole", num_iter=4)
    whole.run(verbose=False)
    _tiny_predictor(tmp_path / "split", num_iter=2,
                    checkpoint_every=1).run(verbose=False)
    capsys.readouterr()
    resumed = _tiny_predictor(tmp_path / "split", num_iter=4,
                              checkpoint_every=1)
    out = resumed.run(verbose=False)
    assert "resumed from checkpoint at cycle 1" in capsys.readouterr().out
    assert len(out["stage1_log"]) == 2
    np.testing.assert_array_equal(resumed.stage1_losses,
                                  whole.stage1_losses[2:])
    ref, got = _stage1(tmp_path / "whole"), _stage1(tmp_path / "split")
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    assert sorted(os.listdir(tmp_path / "split" / "ckpt")) == [
        "cycle_000002.pt", "cycle_000003.pt"]


def test_checkpoint_ignores_a_partial_write(tmp_path):
    """A save cut short leaves only its temporary file, which the
    resume does not read: the newest complete checkpoint is loaded."""
    from mhmocap_tpu_torch.engine import optimizer as TE
    params = TE.StageParams(*[torch.full((2, 3), float(i))
                              for i in range(6)])
    state = TE.rmsprop_init(params)._replace(count=7)
    ckpt = str(tmp_path / "ckpt")
    TPr.save_checkpoint(ckpt, 4, params, state)
    with open(os.path.join(ckpt, "cycle_000005.pt.tmp"), "wb") as f:
        f.write(b"partial")
    cycle, got, got_state = TPr.load_checkpoint(ckpt, "cpu")
    assert cycle == 4 and got_state.count == 7
    for a, b in zip(got, params):
        assert torch.equal(a, b)
    assert TPr.load_checkpoint(str(tmp_path / "none"), "cpu") is None


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    """profile_dir: a torch.profiler Chrome trace of cycle 2 is written
    there and its path printed."""
    _tiny_predictor(tmp_path / "out", num_iter=3,
                    profile_dir=str(tmp_path / "trace")).run(verbose=False)
    path = os.path.join(str(tmp_path / "trace"), "trace_cycle2.json")
    assert f"profiler trace written to {path}" in capsys.readouterr().out
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]

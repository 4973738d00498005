"""Parity of the port's robust profile with mhmocap_tpu: the
gap-aware temporal terms of the stage-1 loss (`gap_aware_temporal`), the
post-fit gap interpolation (`engine/gapfill.py`) and `Predictor.run`
with both knobs, on a tiny sequence with stale (unobserved) frames.

The JAX side runs as its own tests run it (the CPU brute raster).
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from test_torch_engine import CFG, params_np, seq_arrays
from test_torch_predictor import _assert_pickle_close, make_args
from torch_parity import n, rel_err, t, torch_model_of

from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
from mhmocap_tpu.engine import gapfill as JG
from mhmocap_tpu.engine import optimizer as JE
from mhmocap_tpu.engine import predictor as JPr
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch import convert
from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
from mhmocap_tpu_torch.engine import gapfill as TG
from mhmocap_tpu_torch.engine import optimizer as TE
from mhmocap_tpu_torch.engine import predictor as TPr

T = 12


def _stale(*spans):
    """(T, 2) stale mask with (person, a, b) spans [a, b) set."""
    st = np.zeros((T, 2), np.float32)
    for p, a, b in spans:
        st[a:b, p] = 1.0
    return st


# a gap inside one chunk, gaps straddling the chunk boundaries of
# C = 4 and 8, and a gap from frame 0 (the clamped halo)
STALE = {
    "interior": _stale((1, 5, 7)),
    "straddle": _stale((0, 3, 6), (1, 7, 9)),
    "from_start": _stale((0, 0, 3), (1, 10, 12)),
}


@pytest.fixture(scope="module")
def body():
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    return jm, torch_model_of(jm), seq_arrays(jm, T=T)


def _problem(body, stale, chunk=4, gap=True, pose2d=None):
    """Both packages' (cfg, params, data, aux) for the same numpy state:
    the init-solve translations of the sequence, pose angles moved off
    their reference so that the acceleration terms are not 0; `pose2d`
    replaces the data's 2D keypoints (not the init's)."""
    jm, tm, kw = body
    cfg = dict(CFG, num_frames=T, chunk=chunk, frame_bucket=chunk,
               gap_aware_temporal=gap)
    jcfg, tcfg = JE.EngineConfig(**cfg), TE.EngineConfig(**cfg)
    jp, _, _ = JE.init_params(jm, kw["pose2d"], kw["poses_smpl"],
                              kw["betas_smpl"], kw["cam"]["K"], jcfg)
    rng = np.random.RandomState(0)
    p = params_np(jp)
    p[1] = p[1] + (0.05 * rng.randn(*p[1].shape)).astype(np.float32)
    p[0] = p[0] + (0.03 * rng.randn(*p[0].shape)).astype(np.float32)
    seq = dict(kw, lagged_tn=np.asarray(stale, bool))
    if pose2d is not None:
        seq["pose2d"] = pose2d
    br = np.mean(kw["betas_smpl"], 0, keepdims=True)
    return dict(
        p=p, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm,
        jdata=JE.prepare_seq_data(JSeq(**seq), jcfg),
        tdata=TE.prepare_seq_data(TSeq(**seq), tcfg),
        jaux=JE.init_aux(jcfg, 384, jnp.asarray(br)),
        taux=TE.init_aux(tcfg, 384, t(br)),
        coefs=JE.default_coefs())


def _port_cycle(pr):
    tl, tparts, tg = TE.cycle_loss_and_grads(
        convert.params_from_numpy(pr["p"]), pr["tm"], pr["tdata"],
        pr["taux"], pr["coefs"], pr["tcfg"])
    return float(tl), n(tparts), [n(g) for g in tg]


@pytest.mark.parametrize("case", sorted(STALE))
def test_gap_cycle_loss_and_gradients_match(body, case):
    """One cycle with gap_aware_temporal on a sequence with stale
    frames: loss and each LOG_KEYS part to 1e-3 relative, the gradient
    of every parameter to 1e-2 relative norm, as the parity path's
    engine test (test_torch_engine); reg_gap_accel is live."""
    pr = _problem(body, STALE[case])
    f = jax.jit(jax.value_and_grad(JE._cycle_loss, has_aux=True),
                static_argnums=(5,))
    (jl, jparts), jg = f(JE.StageParams(*map(jnp.asarray, pr["p"])),
                         pr["jm"], pr["jdata"], pr["jaux"], pr["coefs"],
                         pr["jcfg"])
    tl, tparts, tg = _port_cycle(pr)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-3)
    np.testing.assert_allclose(tparts, np.asarray(jparts), rtol=1e-3,
                               atol=1e-7)
    assert tparts[list(TE.LOG_KEYS).index("reg_gap_accel")] > 0
    for name, a, b in zip(TE.PARAM_NAMES, tg, jg):
        assert rel_err(a, np.asarray(b)) < 1e-2, name


@pytest.mark.parametrize("case", sorted(STALE))
def test_gap_terms_tile_chunks_exactly_once(body, case):
    """Chunks of 4 and one chunk of 12 frames give the same parts and
    gradients: the 2-frame halo makes the acceleration triples, and the
    1-frame view the pairs, tile the sequence once (JAX
    tests/test_gap_temporal.py:131)."""
    _, pa, ga = _port_cycle(_problem(body, STALE[case], chunk=4))
    _, pb, gb = _port_cycle(_problem(body, STALE[case], chunk=12))
    np.testing.assert_allclose(pa, pb, rtol=2e-4, atol=1e-6)
    for name, a, b in zip(TE.PARAM_NAMES, ga, gb):
        assert rel_err(a, b) < 1e-4, name


def test_gap_terms_match_numpy_golden(body):
    """reg_vel and reg_gap_accel against their definition in numpy:
    pairs with a stale end dropped, triples (centre >= 1) touching a
    stale frame summed."""
    st = STALE["straddle"]
    pr = _problem(body, st)
    _, parts, _ = _port_cycle(pr)
    pT, pS = pr["p"][0].astype(np.float64), pr["p"][1].astype(np.float64)
    vel = sum(np.sum((pT[k, q] - pT[k - 1, q]) ** 2)
              for k in range(1, T) for q in range(2)
              if not (st[k - 1, q] or st[k, q]))
    acc = sum(np.sum((pT[k + 1, q] - 2 * pT[k, q] + pT[k - 1, q]) ** 2)
              + np.sum((pS[k + 1, q] - 2 * pS[k, q] + pS[k - 1, q]) ** 2)
              for k in range(1, T - 1) for q in range(2)
              if st[k - 1, q] or st[k, q] or st[k + 1, q])
    keys = list(TE.LOG_KEYS)
    np.testing.assert_allclose(parts[keys.index("reg_vel")], vel, rtol=1e-5)
    np.testing.assert_allclose(parts[keys.index("reg_gap_accel")], acc,
                               rtol=1e-5)


def test_clean_input_identical_with_knob_on(body):
    """With no stale frame the knob is inert: loss, parts and gradients
    are bit-identical to the knob off (the wider halo does not change
    the parity path's slicing; JAX test_clean_input_identical_with_knob_on)."""
    clean = np.zeros((T, 2), np.float32)
    on = _port_cycle(_problem(body, clean, gap=True))
    off = _port_cycle(_problem(body, clean, gap=False))
    assert on[0] == off[0]
    np.testing.assert_array_equal(on[1], off[1])
    assert on[1][-1] == 0.0
    for a, b in zip(on[2], off[2]):
        np.testing.assert_array_equal(a, b)


def test_stale_frames_release_2d_term(body):
    """With the knob on, moving the 2D keypoints of stale frames leaves
    the 2D loss unchanged; with it off the same move raises it."""
    st = STALE["interior"]
    keys = list(TE.LOG_KEYS)

    def pose_loss(gap, wreck):
        pose2d = body[2]["pose2d"].copy()
        if wreck:
            pose2d[5:7, 1, :, :2] += 40.0
        pr = _problem(body, st, gap=gap, pose2d=pose2d)
        return _port_cycle(pr)[1][keys.index("loss_pose24j")]

    assert pose_loss(True, True) == pose_loss(True, False)
    assert pose_loss(False, True) > 2.0 * pose_loss(False, False)


def _toy(T=8, N=2):
    rng = np.random.RandomState(3)
    return (rng.randn(T, N, 1, 3).astype(np.float32),
            (0.3 * rng.randn(T, N, 72)).astype(np.float32),
            np.zeros((T, N), bool))


def _mask(T, spans):
    m = np.zeros((T, 2), bool)
    for p, a, b in spans:
        m[a:b, p] = True
    return m


@pytest.mark.parametrize("T,spans", [
    (8, [(0, 3, 6)]),                      # interior
    (8, [(0, 0, 3), (1, 6, 8)]),           # boundary: not yet in, gone
    (8, [(1, 0, 8)]),                      # never observed
    (10, [(0, 2, 3), (0, 5, 7)]),          # multiple runs, one person
    (8, []),                               # clean
], ids=["interior", "boundary", "never_observed", "multiple_runs",
        "clean"])
def test_gapfill_matches_jax(T, spans):
    """The port's copy of engine/gapfill.py gives the JAX module's
    arrays bit for bit, and the same frame count."""
    pT, pS, _ = _toy(T)
    lag = _mask(T, spans)
    got = TG.interpolate_gap_trajectories(pT, pS, lag)
    ref = JG.interpolate_gap_trajectories(pT, pS, lag)
    assert got[2] == ref[2]
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def robust_runs(tmp_path_factory):
    """The JAX Predictor and the port's, 3 cycles with
    gap_aware_temporal and gap_interpolate on a sequence with stale
    frames. The port also runs from the JAX package's init params, so
    that stage 1 starts from the same state."""
    from mhmocap_tpu_torch.engine import optimizer as TEm
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    kw = dict(seq_arrays(jm, T=10),
              lagged_tn=_mask(10, [(0, 3, 6), (1, 8, 10)]))
    args = make_args(gap_aware_temporal=True, gap_interpolate=True)
    dirs = {k: str(tmp_path_factory.mktemp(k))
            for k in ("jax", "torch", "torch_jax_init")}
    jpred = JPr.Predictor(JSeq(**kw), jm, dirs["jax"], args)
    jpred.run(verbose=False)
    tpred = TPr.Predictor(TSeq(**kw), torch_model_of(jm), dirs["torch"],
                          args, device="cpu")
    tpred.run(verbose=False)

    def jax_init(model, *a, **k):
        jp, jh, opt_scale = JE.init_params(jm, *a[:4], jpred.cfg, **k)
        return (convert.params_from_numpy([np.asarray(x) for x in jp]),
                np.asarray(jh), opt_scale)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TEm, "init_params", jax_init)
        TPr.Predictor(TSeq(**kw), torch_model_of(jm),
                      dirs["torch_jax_init"], args,
                      device="cpu").run(verbose=False)
    out = {"cfg": (jpred.cfg, tpred.cfg), "coefs": (jpred.coefs,
                                                    tpred.coefs)}
    for name, d in dirs.items():
        with open(os.path.join(d, "optvar_stage1.pkl"), "rb") as fh:
            out[name] = pickle.load(fh)
    return out


def test_robust_predictor_config_matches(robust_runs):
    jc, tc = robust_runs["cfg"]
    assert jc.gap_aware_temporal and tc.gap_aware_temporal
    assert tc.halo == jc.halo == 2
    jcoef, tcoef = robust_runs["coefs"]
    assert tcoef == {k: float(v) for k, v in jcoef.items()}


def test_robust_predictor_stage1_matches(robust_runs):
    """optvar_stage1.pkl after 3 robust cycles and the gap
    interpolation: the JAX keys, gap_interp_frames equal (5 stale
    person-frames), every array within RMSprop's 3-step reach (0.08,
    test_torch_predictor), and from the same init params 99% of the
    entries, all arrays pooled, within 5e-3 (as chip_smoke.py phase 5:
    one of the two scale factors, whose gradient terms cancel, may take
    a step the other way)."""
    ref = robust_runs["jax"]
    assert ref["gap_interp_frames"] == 5
    _assert_pickle_close(robust_runs["torch"], ref, 0.08)
    got = robust_runs["torch_jax_init"]
    _assert_pickle_close(got, ref, 0.08)
    diff = np.concatenate([np.abs(got[k] - v).ravel()
                           for k, v in ref.items()
                           if isinstance(v, np.ndarray)
                           and v.dtype.kind == "f"])
    assert np.mean(diff <= 5e-3) >= 0.99, np.mean(diff <= 5e-3)


def test_gap_interp_frames_written_when_nothing_is_stale(tmp_path):
    """The knob on without stale frames records 0 and changes nothing."""
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    kw = seq_arrays(jm, T=6)
    res = {}
    for interp in (False, True):
        d = str(tmp_path / str(interp))
        TPr.Predictor(TSeq(**kw), torch_model_of(jm), d,
                      make_args(num_iter=1, gap_interpolate=interp),
                      device="cpu").run(verbose=False)
        with open(os.path.join(d, "optvar_stage1.pkl"), "rb") as fh:
            res[interp] = pickle.load(fh)
    assert res[True].pop("gap_interp_frames") == 0
    assert "gap_interp_frames" not in res[False]
    for k in ("poses_T", "poses_smpl"):
        np.testing.assert_array_equal(res[True][k], res[False][k])

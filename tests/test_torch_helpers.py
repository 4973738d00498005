"""Parity of the port's small helpers with mhmocap_tpu: the camera
helpers, the orthographic-matching metrics, the BEV loader, data/utils,
the SMPL factory / landmarks / Euler angle, the loss terms and their
gradients at 0, the stage-1 cycle variants and the studio ingestion."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import CFG, params_np, seq_arrays
from torch_parity import n, t, torch_model_of

from mhmocap_tpu.data import romp as JR, utils as JU
from mhmocap_tpu.engine import losses as JLo, optimizer as JE
from mhmocap_tpu.eval import metrics as JM
from mhmocap_tpu.models import smpl as JS
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops import cameras as JC
from mhmocap_tpu_torch import convert
from mhmocap_tpu_torch.data import romp as TR, utils as TU
from mhmocap_tpu_torch.engine import losses as TLo, optimizer as TE
from mhmocap_tpu_torch.eval import metrics as TM
from mhmocap_tpu_torch.models import smpl as TS
from mhmocap_tpu_torch.models.synthetic import synthetic_smpl_arrays
from mhmocap_tpu_torch.ops import cameras as TC


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def test_recover_intrinsics_and_ndc_match():
    """The numpy helpers are the JAX package's: recovered K to 1e-5
    relative (least squares in float64), NDC matrices equal for wide,
    tall and square images."""
    rng = np.random.RandomState(0)
    K = np.array([[500.0, 0, 310], [0, 480.0, 250], [0, 0, 1]], np.float32)
    p3 = np.concatenate([rng.uniform(-1, 1, (40, 2)),
                         rng.uniform(2, 6, (40, 1))], -1).astype(np.float32)
    p2 = (p3[:, :2] / p3[:, 2:]) * K[[0, 1], [0, 1]] + K[:2, 2]
    for fn in ("recover_intrinsics",):
        np.testing.assert_allclose(getattr(TC, fn)(p3, p2),
                                   getattr(JC, fn)(p3, p2), rtol=1e-5)
    np.testing.assert_allclose(TC.recover_intrinsics(p3, p2), K, rtol=1e-3)
    np.testing.assert_array_equal(
        TC.recover_intrinsics_simplified(p3, p2, (620, 500)),
        JC.recover_intrinsics_simplified(p3, p2, (620, 500)))
    for size in ((640, 480), (480, 640), (512, 512)):
        np.testing.assert_array_equal(
            TC.ndc_calibration_matrix(1.0, 100.0, K, size),
            JC.ndc_calibration_matrix(1.0, 100.0, K, size))


def test_reparameterizations_match():
    """inverse_softplus, the bounded softplus-exp pair (scalar and array
    bounds), disparity_from_depth and transform_points_rt: to 1e-6
    relative; the bounded pair inverts itself."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-3, 3, 50).astype(np.float32)
    s = rng.uniform(0.05, 5, 50).astype(np.float32)
    np.testing.assert_allclose(n(TC.inverse_softplus(t(s))),
                               np.asarray(JC.inverse_softplus(s)), rtol=1e-5)
    np.testing.assert_allclose(n(TC.softplus(TC.inverse_softplus(t(s)))), s,
                               rtol=1e-5)
    for lo, hi in ((0.5, 10.0), (t(np.float32([1.0])),
                                 t(np.float32([20.0])))):
        jlo, jhi = (np.asarray(n(v)) if torch.is_tensor(v) else v
                    for v in (lo, hi))
        y = TC.bounded_splus_exp(t(x), lo, hi)
        np.testing.assert_allclose(
            n(y), np.asarray(JC.bounded_splus_exp(x, jlo, jhi)), rtol=1e-6)
        z = t(np.linspace(1.5, 9.0, 7).astype(np.float32))
        np.testing.assert_allclose(
            n(TC.inverted_bounded_splus_exp(z, lo, hi)),
            np.asarray(JC.inverted_bounded_splus_exp(n(z), jlo, jhi)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            n(TC.bounded_splus_exp(TC.inverted_bounded_splus_exp(z, lo, hi),
                                   lo, hi)), n(z), rtol=1e-5)
    np.testing.assert_array_equal(
        n(TC.disparity_from_depth(t(s - 1))),
        np.asarray(JC.disparity_from_depth(s - 1)))
    RT = rng.randn(3, 4).astype(np.float32)
    p = rng.randn(5, 7, 3).astype(np.float32)
    np.testing.assert_allclose(n(TC.transform_points_rt(t(p), t(RT))),
                               np.asarray(JC.transform_points_rt(p, RT)),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_inputs(T=5, N=3, Kp=2):
    rng = np.random.RandomState(2)
    K = np.array([[80.0, 0, 48], [0, 80.0, 40], [0, 0, 1]], np.float32)
    gt = np.concatenate([rng.uniform(-0.8, 0.8, (T, Kp, 17, 2)),
                         rng.uniform(3, 5, (T, Kp, 17, 1))], -1).astype(
        np.float32)
    vis = rng.choice([0.0, 1.0], (T, Kp, 17, 1), p=[0.2, 0.8]).astype(
        np.float32)
    j17 = (0.3 * rng.randn(T, N, 17, 3)).astype(np.float32)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (T, N, 1)),
                          rng.uniform(-0.5, 0.5, (T, N, 2))], -1).astype(
        np.float32)
    optvar = {"poses_T": rng.randn(T, N, 1, 3).astype(np.float32),
              "scale_factor": rng.uniform(0.9, 1.1, (1, N, 1, 1)).astype(
                  np.float32)}
    return K, gt, vis, j17, cam, optvar


def test_ortho_metrics_match():
    """pose_error_ortho, match_predictions_to_gt and
    pose_error_3dproj_matched: the same Hungarian matches, distances to
    1e-5, the scale to 1e-6 relative."""
    K, gt, vis, j17, cam, optvar = _metric_inputs()
    size = (96, 80)
    for a, b in zip(TM.pose_error_ortho(j17, gt, vis, cam, K, size),
                    JM.pose_error_ortho(j17, gt, vis, cam, K, size)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    mt = TM.match_predictions_to_gt(gt, vis, j17, cam, K, size)
    mj = JM.match_predictions_to_gt(gt, vis, j17, cam, K, size)
    assert len(mt) == len(mj) == 5
    for (ra, pa), (rb, pb) in zip(mt, mj):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(pa, pb)
    got = TM.pose_error_3dproj_matched(optvar, gt, vis, j17, mj)
    ref = JM.pose_error_3dproj_matched(optvar, gt, vis, j17, mj)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert got[4] == pytest.approx(ref[4], rel=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_load_bev_prediction_matches(tmp_path):
    rng = np.random.RandomState(3)
    d = {"cam": rng.randn(2, 3), "smpl_thetas": rng.randn(2, 72),
         "smpl_betas": rng.randn(2, 11)}
    path = str(tmp_path / "bev.npz")
    np.savez(path, results=np.array(d, dtype=object))
    got, ref = TR.load_bev_prediction(path), JR.load_bev_prediction(path)
    assert set(got) == set(ref) == {"cam", "poses", "betas"}
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])


def test_data_utils_match():
    """data/utils.py is a copy: every function gives the JAX package's
    answer."""
    rng = np.random.RandomState(4)
    img = rng.rand(30, 40, 3)
    for anchor, ref_pt in (((5, 7), (12, 30)), ((25, 35), (3, 4))):
        for a, b in zip(TU.automatic_image_crop(img, anchor, ref_pt, (24, 36)),
                        JU.automatic_image_crop(img, anchor, ref_pt, (24, 36))):
            np.testing.assert_array_equal(a, b)
    depth = rng.rand(20, 24).astype(np.float32)
    mask = (rng.rand(20, 24) > 0.3).astype(np.float32)
    for metric in ("avg", "min", "max"):
        assert TU.sample_window_depth(depth, mask, (10, 12), 6, metric) == \
            JU.sample_window_depth(depth, mask, (10, 12), 6, metric)
    p2d = rng.uniform(0, 24, (6, 2)).astype(int)
    bb_t = TU.centered_boundingboxes(p2d, (24, 20))
    np.testing.assert_array_equal(bb_t, JU.centered_boundingboxes(p2d,
                                                                 (24, 20)))
    for a, b in zip(TU.sampling_boundingboxes(depth, bb_t),
                    JU.sampling_boundingboxes(depth, bb_t)):
        np.testing.assert_array_equal(a, b)
    pts = rng.rand(30, 3)
    np.testing.assert_array_equal(
        TU.aggregate_kclosest_points(pts, [0, 3], 4, 2),
        JU.aggregate_kclosest_points(pts, [0, 3], 4, 2))
    assert TU.angle_between_vectors(pts[0], pts[1]) == \
        JU.angle_between_vectors(pts[0], pts[1])
    cam = {"K": np.array([[100.0, 0, 50], [0, 90, 40], [0, 0, 1]]),
           "image_size": (100, 80)}
    a, b = (mod.effective_camera_intrinsics((50, 40), cam) for mod in (TU, JU))
    np.testing.assert_array_equal(a["K"], b["K"])
    assert a["image_size"] == b["image_size"] == (50, 40)


# ---------------------------------------------------------------------------
# SMPL helpers
# ---------------------------------------------------------------------------

def test_smpl_create_landmarks_euler_match(tmp_path):
    """create() loads what the JAX factory loads (and refuses other model
    types); barycentric landmarks and the y Euler angle to 1e-6."""
    a = synthetic_smpl_arrays(256, seed=3)
    V = a["v_template"].shape[0]
    kintree = np.stack([np.asarray(a["parents"], np.int64),
                        np.arange(24)]).astype(np.int64)
    kintree[0, 0] = 4294967295
    with open(tmp_path / "SMPL_NEUTRAL.pkl", "wb") as f:
        pickle.dump({"v_template": a["v_template"],
                     "shapedirs": a["shapedirs"],
                     "posedirs": a["posedirs"].T.reshape(V, 3, 207),
                     "J_regressor": a["j_regressor"],
                     "weights": a["lbs_weights"],
                     "f": a["faces"].astype(np.uint32),
                     "kintree_table": kintree}, f)
    got = TS.create(str(tmp_path))
    ref = JS.create(str(tmp_path))
    np.testing.assert_array_equal(n(got.v_template), np.asarray(ref.v_template))
    np.testing.assert_array_equal(n(got.faces), np.asarray(ref.faces))
    with pytest.raises(ValueError, match="Unknown model type"):
        TS.create(str(tmp_path), model_type="smplx")

    rng = np.random.RandomState(5)
    verts = rng.randn(2, V, 3).astype(np.float32)
    idx = rng.randint(0, len(a["faces"]), 9)
    bary = rng.dirichlet(np.ones(3), 9).astype(np.float32)
    np.testing.assert_allclose(
        n(TS.vertices_to_landmarks(t(verts), torch.as_tensor(a["faces"]),
                                   torch.as_tensor(idx), t(bary))),
        np.asarray(JS.vertices_to_landmarks(verts, a["faces"], idx, bary)),
        atol=1e-6)
    rot = n(TS.rodrigues(t(rng.randn(7, 3))))
    np.testing.assert_allclose(n(TS.rot_mat_to_euler(t(rot))),
                               np.asarray(JS.rot_mat_to_euler(rot)),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(shape=(2, 12, 10)):
    rng = np.random.RandomState(6)
    a = rng.uniform(0.5, 5, shape).astype(np.float32)
    b = rng.uniform(0.5, 5, shape).astype(np.float32)
    m = (rng.rand(*shape) > 0.3).astype(np.float32)
    return a, b, m


@pytest.mark.parametrize("name", ["eigen_log_depth_loss", "avg_log_depth_loss",
                                  "masked_mse_loss", "multiscale_gradient_loss"])
def test_losses_and_gradients_match(name):
    """Each loss and its gradient in its first argument, at random inputs
    and at a zero difference (where the L1 terms sit at |0|): values to
    1e-5 relative, gradients to 1e-5 relative or 1e-7."""
    a, b, m = _loss_inputs((12, 10) if name == "multiscale_gradient_loss"
                           else (2, 12, 10))
    jf, tf = getattr(JLo, name), getattr(TLo, name)
    for x in (a, b):          # x = b: y_pred equals y_true
        if name == "multiscale_gradient_loss":
            jv, jg = jax.value_and_grad(lambda y: jf(b, y, m, num_levels=3))(x)
            xt = t(x).requires_grad_(True)
            tv = tf(t(b), xt, t(m), num_levels=3)
        else:
            jv, jg = jax.value_and_grad(lambda y: jf(y, b, m))(x)
            xt = t(x).requires_grad_(True)
            tv = tf(xt, t(b), t(m))
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(n(xt.grad), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)


def test_l1_and_small_losses_match():
    """sum_abs has derivative +1 at 0, as jnp.abs does (torch.abs has 0);
    sum_sq and inv_depth_loss match."""
    x = np.array([0.0, -1.5, 2.0, 0.0], np.float32)
    jg = jax.grad(JLo.sum_abs)(x)
    xt = t(x).requires_grad_(True)
    TLo.sum_abs(xt).backward()
    np.testing.assert_array_equal(n(xt.grad), np.asarray(jg))
    assert n(xt.grad).tolist() == [1.0, -1.0, 1.0, 1.0]
    assert float(TLo.sum_sq(t(x))) == float(JLo.sum_sq(x))
    np.testing.assert_allclose(n(TLo.inv_depth_loss(t(x))),
                               np.asarray(JLo.inv_depth_loss(x)), rtol=1e-6)


# ---------------------------------------------------------------------------
# stage-1 cycle variants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cycles():
    """The body, sequence and config of tests/test_torch_engine.py's
    fused-cycle runs (warmup_cycles 1, update_filters_every 2: cycle 1
    rebuilds the scene, cycle 2 also refreshes the filtered targets),
    the JAX package's stage1_cycles_fused(n_cycles=3) from its init
    params, and the port's inputs from the same params."""
    from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
    from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    kw = seq_arrays(jm)
    jcfg, tcfg = JE.EngineConfig(**CFG), TE.EngineConfig(**CFG)
    jp, _, _ = JE.init_params(jm, kw["pose2d"], kw["poses_smpl"],
                              kw["betas_smpl"], kw["cam"]["K"], jcfg)
    br = np.mean(kw["betas_smpl"], 0, keepdims=True)
    tp = convert.params_from_numpy(params_np(jp))
    jp = jax.tree.map(jnp.array, jp)
    jq, _, _, jl, jparts = JE.stage1_cycles_fused(
        jp, JE.make_stage1_optimizer().init(jp),
        JE.init_aux(jcfg, 384, jnp.asarray(br)), jnp.uint32(0), jm,
        JE.prepare_seq_data(JSeq(**kw), jcfg), JE.default_coefs(), jcfg,
        n_cycles=3)
    return dict(jax=(np.asarray(jl), np.asarray(jparts), params_np(jq)),
                tp=tp, taux=TE.init_aux(tcfg, 384, t(br)),
                args=(torch_model_of(jm),
                      TE.prepare_seq_data(TSeq(**kw), tcfg),
                      JE.default_coefs(), tcfg))


def test_stage1_cycles_fused_matches(cycles):
    """The port's stage1_cycles_fused(n_cycles=3) from cycle 0 equals
    three stage1_cycle_fused calls bit for bit (losses, parts, params,
    RMSprop state, refreshed aux), and lands where the JAX package's
    does: losses and parts to 1e-3 relative, params to 5e-3 (the
    tolerances of tests/test_torch_engine.py's fused cycles)."""
    tp, args = cycles["tp"], cycles["args"]
    q, st, aux, losses, parts = TE.stage1_cycles_fused(
        tp, TE.rmsprop_init(tp), cycles["taux"], 0, *args, n_cycles=3)
    assert losses.shape == (3,) and parts.shape == (3, len(TE.LOG_KEYS))
    q2, st2, aux2 = tp, TE.rmsprop_init(tp), cycles["taux"]
    for c in range(3):
        q2, st2, aux2, loss, part = TE.stage1_cycle_fused(q2, st2, aux2, c,
                                                          *args)
        assert torch.equal(losses[c], loss) and torch.equal(parts[c], part)
    for a, b in zip(q, q2):
        assert torch.equal(a, b)
    assert st.count == st2.count == 3
    for a, b in zip(st.nu + st.trace, st2.nu + st2.trace):
        assert torch.equal(a, b)
    assert aux.have_scene and aux.have_filters
    assert torch.equal(aux.verts_filt_diff, aux2.verts_filt_diff)
    jl, jparts, jq = cycles["jax"]
    np.testing.assert_allclose(n(losses), jl, rtol=1e-3)
    np.testing.assert_allclose(n(parts), jparts, rtol=1e-3, atol=1e-6)
    for name, a, b in zip(TE.PARAM_NAMES, q, jq):
        np.testing.assert_allclose(n(a), b, atol=5e-3, rtol=0, err_msg=name)


def test_stage1_cycle_matches(cycles):
    """stage1_cycle (no refreshes) is cycle 0 of the fused loop, whose
    refreshes start at warmup_cycles 1: bit for bit the port's fused
    cycle 0, and its loss is the JAX package's cycle-0 loss to 1e-3
    relative."""
    tp, (model, data, coefs, cfg) = cycles["tp"], cycles["args"]
    q, st, loss, parts = TE.stage1_cycle(tp, TE.rmsprop_init(tp), model,
                                         data, cycles["taux"], coefs, cfg)
    q2, st2, _, loss2, parts2 = TE.stage1_cycle_fused(
        tp, TE.rmsprop_init(tp), cycles["taux"], 0, model, data, coefs, cfg)
    assert st.count == st2.count == 1
    assert torch.equal(loss, loss2) and torch.equal(parts, parts2)
    for a, b in zip(q, q2):
        assert torch.equal(a, b)
    assert float(loss) == pytest.approx(float(cycles["jax"][0][0]), rel=1e-3)


# ---------------------------------------------------------------------------
# studio ingestion
# ---------------------------------------------------------------------------

def test_build_studio_sequence_matches(tmp_path):
    """A studio layout (seq<id>/cam<id>) written by the JAX package's
    synthetic writer, ingested by both packages with the studio
    intrinsics: the same K and exactly equal label and SMPL arrays; the
    port runs on the device it is given."""
    from mhmocap_tpu.data.synthetic import generate_sequence
    from mhmocap_tpu.engine.predictor import build_studio_sequence as jbuild
    from mhmocap_tpu_torch.engine.predictor import (
        build_studio_sequence as tbuild)
    from mhmocap_tpu_torch.models.smpl import joints_function
    jm = make_synthetic_smpl(num_vertices=256, seed=3)
    generate_sequence(str(tmp_path / "seq2" / "cam1"), num_frames=4,
                      num_people=2, image_size=(64, 64), model=jm, seed=1)
    jfn = jax.jit(lambda b, q: JS.smpl_forward(jm, b, q)["joints_alphapose"])
    kw = dict(end_frame=4, depth_path="DPT_large_monodepth",
              post_process_depth=False)
    ref = jbuild(str(tmp_path), 2, 1,
                 lambda b, q: np.asarray(jfn(jnp.asarray(b), jnp.asarray(q))),
                 **kw)
    got = tbuild(str(tmp_path), 2, 1,
                 joints_function(torch_model_of(jm), "joints_alphapose"),
                 device="cpu", **kw)
    np.testing.assert_array_equal(got.cam["K"], ref.cam["K"])
    assert got.cam["K"][0, 0] == pytest.approx(0.582952201 * 1028)
    for f in ("instances", "seg_mask", "backmasks", "poses_smpl",
              "betas_smpl", "valid_smpl", "frame_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbuild(str(tmp_path), 2, 1, None, **kw)

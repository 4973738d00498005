"""Parity of the port's stage-init solve and stage-1 cycle with
mhmocap_tpu on a tiny sequence (T=8, N=2, 48x48, 384-vertex body).

The JAX side runs its CPU "auto" raster path (brute edge_lines); the
port runs its main path (the raster kernels' plain version on the CPU).
Both start every comparison from the same numpy state.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from torch_parity import n, rel_err, t, torch_model_of

from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
from mhmocap_tpu.engine import optimizer as JE
from mhmocap_tpu.models.smpl import smpl_forward as jax_smpl
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops.cameras import intrinsics_from_fov, project_points
from mhmocap_tpu_torch import convert
from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
from mhmocap_tpu_torch.engine import optimizer as TE

T, N, W = 8, 2, 48
CFG = dict(image_size=(W, W), num_people=N, num_frames=T, chunk=4,
           window=32, windows=(48, 32), frame_bucket=8, warmup_cycles=1,
           update_filters_every=2)


def seq_arrays(jm, T=T, N=N, W=W, seed=0):
    """SequenceArrays fields of a small scene whose 2D poses come from
    the body itself."""
    K = intrinsics_from_fov((W, W), 60.0)
    rng = np.random.RandomState(seed)
    pT = np.zeros((T, N, 1, 3), np.float32)
    pT[:, 0, 0] = [-0.4, 0.3, 3.0]
    pT[:, 1 % N, 0] = [0.4, 0.3, 3.6]
    pT[..., 0] += 0.05 * rng.randn(T, N, 1)
    poses = (0.1 * rng.randn(T, N, 72)).astype(np.float32)
    betas = np.zeros((T, N, 10), np.float32)
    out = jax_smpl(jm, jnp.asarray(betas.reshape(-1, 10)),
                   jnp.asarray(poses.reshape(-1, 72)))
    j3d = np.asarray(out["joints_alphapose"]).reshape(T, N, 17, 3) + pT
    uv = np.asarray(project_points(jnp.asarray(j3d), jnp.asarray(K)))
    pose2d = np.concatenate([uv, 0.9 * np.ones((T, N, 17, 1), np.float32)],
                            -1)
    seg = np.zeros((T, N, W, W), np.float32)
    seg[:, 0, 8:40, 4:22] = 1
    seg[:, 1 % N, 8:40, 26:44] = 1
    return dict(
        images=rng.randint(0, 255, (T, W, W, 3)).astype(np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, W, W), 0, 1).astype(
            np.float32),
        instances=np.zeros((T, W, W), np.uint8), seg_mask=seg,
        backmasks=1.0 - seg.max(1), pose2d=pose2d,
        cam_smpl=np.zeros((T, N, 3), np.float32), poses_smpl=poses,
        betas_smpl=betas, valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": K, "fov": 60.0, "Kd": None, "image_size": (W, W)})


def params_np(p):
    return [np.asarray(x) for x in p]


@pytest.fixture(scope="module")
def prob():
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    kw = seq_arrays(jm)
    jcfg, tcfg = JE.EngineConfig(**CFG), TE.EngineConfig(**CFG)
    jp, jh, _ = JE.init_params(jm, kw["pose2d"], kw["poses_smpl"],
                               kw["betas_smpl"], kw["cam"]["K"], jcfg)
    jdata = JE.prepare_seq_data(JSeq(**kw), jcfg)
    br = np.mean(kw["betas_smpl"], 0, keepdims=True)
    return dict(jm=jm, tm=torch_model_of(jm), kw=kw, jcfg=jcfg, tcfg=tcfg,
                jp=jp, jh=np.asarray(jh), jdata=jdata,
                tdata=TE.prepare_seq_data(TSeq(**kw), tcfg),
                jaux=JE.init_aux(jcfg, 384, jnp.asarray(br)),
                taux=TE.init_aux(tcfg, 384, t(br)),
                coefs=JE.default_coefs())


def test_init_solve_matches(prob):
    """100 Adam steps on the 2D reprojection: loss history to 1e-4
    relative or 1e-5 of the first loss (the late losses are 1e5x
    smaller and carry the rounding of every step before); translations
    to 5e-3 m (Adam's normalized steps carry float32 gradient rounding
    into lr-sized moves on near-zero components); the derived depth
    bounds follow."""
    p, kw = prob, prob["kw"]
    tp, th, opt_scale = TE.init_params(p["tm"], kw["pose2d"],
                                       kw["poses_smpl"], kw["betas_smpl"],
                                       kw["cam"]["K"], p["tcfg"])
    assert opt_scale and th.shape == (100,)
    np.testing.assert_allclose(th, p["jh"], rtol=1e-4,
                               atol=1e-5 * p["jh"][0])
    for name, a, b in zip(TE.PARAM_NAMES, tp, p["jp"]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=5e-3, rtol=0,
                                   err_msg=name)


def test_adam_matches_optax():
    """The hand-written Adam against optax.adam(exponential_decay(0.5, 1,
    0.95), b1=b2=0.5, eps=1e-6), 12 steps: 1e-6 relative."""
    rng = np.random.RandomState(0)
    opt = optax.adam(optax.exponential_decay(0.5, 1, 0.95), b1=0.5, b2=0.5,
                     eps=1e-6)
    x = rng.randn(5, 3).astype(np.float32)
    jx, st = jnp.asarray(x), opt.init(jnp.asarray(x))
    tx, mu, nu = t(x), torch.zeros(5, 3), torch.zeros(5, 3)
    for i in range(12):
        g = rng.randn(5, 3).astype(np.float32) * 10.0 ** rng.randint(-3, 3)
        u, st = opt.update(jnp.asarray(g), st, jx)
        jx = optax.apply_updates(jx, u)
        tu, mu, nu = TE.adam_update(t(g), mu, nu, i,
                                    TE._exp_decay(0.5, 0.95, i), 0.5, 0.5,
                                    1e-6)
        tx = tx + tu
    np.testing.assert_allclose(n(tx), np.asarray(jx), rtol=1e-6, atol=1e-6)


def test_rmsprop_matches_optax(prob):
    """The hand-written RMSprop against the JAX package's
    make_stage1_optimizer over 6 steps, continued from a state carried
    across with opt_state_from_optax after 3: 1e-6 relative."""
    rng = np.random.RandomState(1)
    opt = JE.make_stage1_optimizer()
    jp = prob["jp"]
    st = opt.init(jp)
    grads = [[rng.randn(*np.shape(x)).astype(np.float32) for x in jp]
             for _ in range(6)]
    for g in grads[:3]:
        u, st = opt.update(JE.StageParams(*map(jnp.asarray, g)), st, jp)
        jp = optax.apply_updates(jp, u)
    rms, sched, trace = st
    tst = convert.opt_state_from_optax(params_np(rms.nu),
                                       params_np(trace.trace),
                                       int(sched.count))
    tp = convert.params_from_numpy(params_np(jp))
    for g in grads[3:]:
        u, st = opt.update(JE.StageParams(*map(jnp.asarray, g)), st, jp)
        jp = optax.apply_updates(jp, u)
        tp, tst = TE.rmsprop_update(TE.StageParams(*map(t, g)), tst, tp)
    assert tst.count == 6
    for name, a, b in zip(TE.PARAM_NAMES, tp, jp):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_params_numpy_round_trip(prob):
    """JAX StageParams -> port (as a field-order sequence and as a dict)
    -> numpy gives the JAX arrays back bit for bit."""
    ref = dict(zip(TE.PARAM_NAMES, params_np(prob["jp"])))
    for src in (list(ref.values()), ref):
        got = convert.params_to_numpy(convert.params_from_numpy(src))
        assert list(got) == list(TE.PARAM_NAMES)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_prepare_seq_data_matches(prob):
    """Padded device data, incl. the k3 x2 erosion: exact."""
    for f in JE.SeqData._fields:
        a, b = getattr(prob["jdata"], f), getattr(prob["tdata"], f)
        np.testing.assert_array_equal(n(b), np.asarray(a), err_msg=f)


def test_cycle_loss_and_gradients_match(prob):
    """One cycle's loss, each LOG_KEYS part and the gradient of every
    parameter, from the same params (no scene yet). Hard z-buffer
    coverage can flip at an ulp-level vertex difference, which moves
    the depth term: loss and parts to 1e-3 relative, gradients to 1e-2
    relative norm."""
    p = prob
    f = jax.jit(jax.value_and_grad(JE._cycle_loss, has_aux=True),
                static_argnums=(5,))
    (jl, jparts), jg = f(p["jp"], p["jm"], p["jdata"], p["jaux"], p["coefs"],
                         p["jcfg"])
    tp = convert.params_from_numpy(params_np(p["jp"]))
    tl, tparts, tg = TE.cycle_loss_and_grads(tp, p["tm"], p["tdata"],
                                             p["taux"], p["coefs"], p["tcfg"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    np.testing.assert_allclose(n(tparts), np.asarray(jparts), rtol=1e-3,
                               atol=1e-7)
    for name, a, b in zip(TE.PARAM_NAMES, tg, jg):
        assert rel_err(n(a), np.asarray(b)) < 1e-2, name


@pytest.fixture(scope="module")
def fused_runs(prob):
    """3 fused cycles in both packages with warmup_cycles=1 and
    update_filters_every=2: cycle 1 rebuilds the scene (contact and
    foot sliding engage), cycle 2 also refreshes the filtered targets."""
    p = prob
    # stage1_cycle_fused donates its params/state/aux: run on copies
    jp, jaux = jax.tree.map(jnp.array, (p["jp"], p["jaux"]))
    jst = JE.make_stage1_optimizer().init(jp)
    tp = convert.params_from_numpy(params_np(jp))
    taux, tst = p["taux"], TE.rmsprop_init(tp)
    out = {"j": [], "t": []}
    for c in range(3):
        jp, jst, jaux, jl, jparts = JE.stage1_cycle_fused(
            jp, jst, jaux, jnp.uint32(c), p["jm"], p["jdata"], p["coefs"],
            p["jcfg"])
        tp, tst, taux, tl, tparts = TE.stage1_cycle_fused(
            tp, tst, taux, c, p["tm"], p["tdata"], p["coefs"], p["tcfg"])
        out["j"].append((float(jl), np.asarray(jparts), params_np(jp)))
        out["t"].append((float(tl), n(tparts), [n(x) for x in tp]))
    out["jaux"], out["taux"] = jaux, taux
    return out


def test_fused_cycles_losses_match(fused_runs):
    """Per-cycle loss and parts to 1e-3 relative (see the single-cycle
    test); the contact and filter terms are live by cycle 2."""
    for (jl, jparts, _), (tl, tparts, _) in zip(fused_runs["j"],
                                                fused_runs["t"]):
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        np.testing.assert_allclose(tparts, jparts, rtol=1e-3, atol=1e-6)
    parts = fused_runs["t"][-1][1]
    assert parts[list(TE.LOG_KEYS).index("reg_contact")] > 0
    assert parts[list(TE.LOG_KEYS).index("reg_filter_verts")] > 0


def test_fused_cycles_params_match(fused_runs):
    """Params after each cycle to 5e-3 abs: RMSprop's normalized steps
    (lr 0.01) turn the 1e-2 gradient tolerance into at most a fraction
    of a step per cycle."""
    for (_, _, jp), (_, _, tp) in zip(fused_runs["j"], fused_runs["t"]):
        for name, a, b in zip(TE.PARAM_NAMES, tp, jp):
            np.testing.assert_allclose(a, b, atol=5e-3, rtol=0, err_msg=name)


def test_fused_cycles_aux_match(fused_runs):
    """The refreshed aux state: scene depth/points to 1e-3 relative,
    the bf16 filtered targets to 2e-3 m."""
    ja, ta = fused_runs["jaux"], fused_runs["taux"]
    assert ta.have_scene and ta.have_filters
    assert float(ja.have_scene) == 1.0 and float(ja.have_filters) == 1.0
    np.testing.assert_array_equal(n(ta.scene.valid),
                                  np.asarray(ja.scene.valid))
    np.testing.assert_allclose(n(ta.scene.depth), np.asarray(ja.scene.depth),
                               rtol=1e-3)
    np.testing.assert_allclose(
        n(ta.verts_filt_diff.float()),
        np.asarray(ja.verts_filt_diff.astype(jnp.float32)), atol=2e-3)


def test_refreshes_match_from_same_params(prob):
    """update_filtered_targets, update_scene and get_filtered_vertices
    from identical params: 1e-4 m (bf16 targets: half an ulp of their
    magnitude), 1e-5 relative for the scene, 1e-5 m for the vertices."""
    p = prob
    tp = convert.params_from_numpy(params_np(p["jp"]))
    jd = np.asarray(JE.update_filtered_targets(p["jp"], p["jm"], p["jcfg"])
                    .astype(jnp.float32))
    td = n(TE.update_filtered_targets(tp, p["tm"], p["tcfg"]).float())
    np.testing.assert_allclose(td, jd, atol=np.abs(jd).max() * 2 ** -8)
    js = JE.update_scene(p["jp"], p["jdata"], p["jcfg"])
    ts = TE.update_scene(tp, p["tdata"], p["tcfg"])
    np.testing.assert_allclose(n(ts.depth), np.asarray(js.depth), rtol=1e-5)
    np.testing.assert_allclose(n(ts.points), np.asarray(js.points),
                               rtol=1e-5, atol=1e-6)
    jv = JE.get_filtered_vertices(p["jp"], p["jm"], p["jcfg"])
    tv = TE.get_filtered_vertices(tp, p["tm"], p["tcfg"])
    np.testing.assert_allclose(n(tv), np.asarray(jv), atol=1e-5)
    jo = JE.get_optimized_variables(p["jp"], p["jcfg"],
                                    p["kw"]["valid_smpl"])
    to = TE.get_optimized_variables(tp, p["tcfg"], p["kw"]["valid_smpl"])
    assert set(to) == set(jo)
    for k, v in jo.items():
        if v is None:
            assert to[k] is None
        else:
            np.testing.assert_allclose(to[k], v, rtol=1e-6, err_msg=k)


def test_gap_aware_temporal_not_ported():
    with pytest.raises(NotImplementedError):
        TE.EngineConfig(**CFG, gap_aware_temporal=True)

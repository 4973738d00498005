"""Whole-trajectory parity of the port's stage-1 fit with mhmocap_tpu,
on the CPU: the trees, the runs and the tests that
tests/test_torch_trajectory.py (ts3) and
tests/test_torch_trajectory_entry.py (entry1) collect, one tree a file
so that pytest-xdist runs the two on two workers; each file's
module-scoped `traj` fixture is `run_tree` of its tree.

Two trees written by the JAX package's synthetic writer (FRAMES frames,
3 people, 96x96, a 512-vertex body), each ingested by each package's
own `build_mupots_sequence` (`load_sequence`):

  * ts3: the degraded sweep's TS3 plan (`sweep.degradation_plan(3)`:
    ROMP person dropout 0.20, missing ROMP frames 0.10; the sweep's
    seed 10) under the knobs of the sweep's robust tier (id_swap_fix
    0.5, gap_aware_temporal; as on the sweep's TS3, no frame is stale,
    so reg_gap_accel stays 0);
  * entry1: a clean tree (`chip_smoke.py` phase 6's seed 8) with
    post_process_depth on.

Each package runs its own init solve and CYCLES fused stage-1 cycles
(`stage1_cycle_fused`) with the refreshes pulled in (`warmup_cycles` 4,
`update_filters_every` 4): the scene rebuilds in every cycle from 4 and
the filtered targets refresh at 4, 8 and 12. The tests bound every
cycle's drift, step both packages once from JAX's state before each of
TEACHER_CYCLES, hold the raster's z-buffer to the JAX package's
uncompiled ops, and compare the final accuracy.

The z-buffer term is ill-conditioned: a face seen almost edge-on has
z-plane coefficients of order z / area, so the z it gives a pixel
carries a rounding error of order |zc| * eps, which can move the
z-buffer by centimetres. The JAX package's compiled program and its
uncompiled ops disagree on such pixels, and the depth term's gradient
with respect to the body parameters with them, by tens of percent on
some bodies (`test_raster_matches_uncompiled_jax` prints both). The
port's raster equals the uncompiled ops; the teacher-forced gradients
are therefore compared term by term: every term but the depth term at
test_torch_engine's tolerance, and the depth term where it is well
conditioned (the z bounds); `test_whole_loss_matches_uncompiled_jax`
(slow tier: `--full`) holds every gradient of the whole loss to the
JAX package's uncompiled ops.

The JAX side runs in a thread beside the port's, and torch uses
TORCH_THREADS threads inside the fixture.
"""

import concurrent.futures
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_predictor import make_args
from torch_parity import n, rel_err, torch_model_of

import mhmocap_tpu.predict_mupots as JPM
import mhmocap_tpu_torch.predict_mupots as TPM
from mhmocap_tpu.data.synthetic import generate_sequence
from mhmocap_tpu.engine import optimizer as JE, predictor as JPr
from mhmocap_tpu.eval.mupots_eval import compute_mm_pck_results as jax_eval
from mhmocap_tpu.models.smpl import smpl_forward
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops import rasterizer as JR
from mhmocap_tpu_torch import convert, sweep
from mhmocap_tpu_torch.engine import optimizer as TE, predictor as TPr
from mhmocap_tpu_torch.eval.mupots_eval import compute_mm_pck_results
from mhmocap_tpu_torch.models.smpl import joints_function
from mhmocap_tpu_torch.ops import rasterizer as TR

FRAMES, SIDE, VERTICES, WINDOW = 8, 96, 512, 64
CYCLES = 16
REFRESH = dict(warmup_cycles=4, update_filters_every=4)
# the cycle after the first scene rebuild and filter refresh (whose
# state holds both), a filter refresh, a later cycle
TEACHER_CYCLES = (5, 8, 13)
TORCH_THREADS = 4

TREES = {
    "ts3": dict(seed=10, degradations=sweep.degradation_plan(3, FRAMES),
                data=dict(id_swap_fix=0.5, post_process_depth=False),
                args=dict(gap_aware_temporal=True)),
    "entry1": dict(seed=8, degradations=None,
                   data=dict(post_process_depth=True), args={}),
}

DATA_KW = dict(smpl_model_parameters_path="/nonexistent-synthetic",
               depth_path="DPT_large_monodepth", use_hrnet_pose=False,
               joint_confidence_thr=0.5, renormalize_depth=False)

# Per-cycle drift bounds: twice the largest drift measured on these two
# trees over their 16 cycles on the CPU. Pooled over every parameter
# entry, after cycle c: max |port - JAX| <= max_abs_bound(c) and its
# 99th percentile <= p99_bound(c) (measured at most 0.028 + 0.0075 c and
# 0.0013 + 0.0043 c: RMSprop's first steps are lr * sign(g), so
# rounding that flips the sign of a near-zero gradient moves an entry a
# full step the other way, and momentum carries it). The loss to
# LOSS_RTOL (measured 0.038); each logged part to rtol * |JAX| + atol
# (measured: loss_depth 0.39, the z-buffer term above; reg_scale, of
# order 1e-5, 3e-4 absolute; the others 0.013-0.14 relative).


def max_abs_bound(c):
    return 2 * (0.028 + 0.0075 * c)


def p99_bound(c):
    return 2 * (0.0013 + 0.0043 * c)


LOSS_RTOL = 0.08
PART_BOUNDS = {
    "loss_pose24j": (0.15, 0.0), "loss_depth": (0.8, 0.0),
    "loss_silhouette": (0.03, 0.0), "reg_ref_poses": (0.05, 0.0),
    "reg_scale": (0.0, 6e-4), "reg_contact": (0.3, 0.0),
    "reg_foot_sliding": (0.17, 0.0), "reg_vel": (0.11, 0.0),
    "reg_filter_verts": (0.05, 0.0), "reg_gap_accel": (0.0, 0.0),
}

# the z bounds reach the loss only through the depth term, and there
# through the target disparity, which is well conditioned
Z_BOUNDS = ("zmin_lin", "zmax_lin")


@contextlib.contextmanager
def _torch_threads(k):
    old = torch.get_num_threads()
    torch.set_num_threads(k)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _np(tree):
    """A pytree's leaves as numpy copies."""
    return [np.array(x) for x in jax.tree.leaves(tree)]


def _jax_aux(jaux):
    return dict(betas_ref=np.array(jaux.betas_ref), scene=_np(jaux.scene),
                have_scene=np.array(jaux.have_scene),
                verts_filt_diff=np.array(jaux.verts_filt_diff),
                have_filters=np.array(jaux.have_filters))


def aux_to_numpy(aux):
    """`convert.aux_from_numpy`'s arguments back from the port's
    StageAux: the scene's arrays in field order, verts_filt_diff as
    float32 (the bfloat16 values exactly), the flags as bools."""
    return dict(betas_ref=n(aux.betas_ref), scene=[n(x) for x in aux.scene],
                have_scene=bool(aux.have_scene),
                verts_filt_diff=n(aux.verts_filt_diff.float()),
                have_filters=bool(aux.have_filters))


def _jax_aux_of(a):
    return JE.StageAux(jnp.asarray(a["betas_ref"]),
                       JE.ScenePointCloud(*map(jnp.asarray, a["scene"])),
                       jnp.asarray(a["have_scene"]),
                       jnp.asarray(a["verts_filt_diff"]),
                       jnp.asarray(a["have_filters"]))


def _port_state(st):
    """The port's params, RMSprop state and aux from a JAX state."""
    a = st["aux"]
    return (convert.params_from_numpy(st["params"]),
            convert.opt_state_from_optax(st["nu"], st["trace"], st["count"]),
            convert.aux_from_numpy(a["betas_ref"], a["scene"],
                                   a["have_scene"], a["verts_filt_diff"],
                                   a["have_filters"]))


_JAX_LOSS_AND_GRADS = jax.jit(jax.value_and_grad(JE._cycle_loss,
                                                 has_aux=True),
                              static_argnums=(5,))


def _coef_sets(coefs):
    """The whole loss and the loss without its depth term."""
    return {"whole": coefs, "no_depth": dict(coefs, depth=0.0)}


def _jax_uncompiled(params, model, data, aux, coefs, cfg):
    """The whole loss, its parts and gradients at `params` (numpy
    leaves) and `aux` (`_jax_aux`'s dict) through the JAX package's
    uncompiled ops."""
    with jax.disable_jit():
        (loss, parts), g = jax.value_and_grad(JE._cycle_loss, has_aux=True)(
            JE.StageParams(*map(jnp.asarray, params)), model, data,
            _jax_aux_of(aux), coefs, cfg)
    return float(loss), np.asarray(parts), _np(g)


def _jax_trajectory(jp, jscale, model, data, aux, coefs, cfg):
    """CYCLES fused cycles; the state before each of TEACHER_CYCLES and
    the aux after it; then, from each of those states, the loss, parts
    and gradients of `_coef_sets` (the aux the cycle refreshed)."""
    st = JE.make_stage1_optimizer().init(jp)
    cycles, teacher = [], {}
    for c in range(CYCLES):
        if c in TEACHER_CYCLES:
            rms, sched, trace = st
            teacher[c] = {"params": _np(jp), "nu": _np(rms.nu),
                          "trace": _np(trace.trace),
                          "count": int(sched.count), "aux": _jax_aux(aux)}
        jp, st, aux, loss, parts = JE.stage1_cycle_fused(
            jp, st, aux, jnp.uint32(c), model, data, coefs, cfg, jscale)
        cycles.append((float(loss), np.array(parts), _np(jp),
                       (float(aux.have_scene), float(aux.have_filters))))
        if c in TEACHER_CYCLES:
            teacher[c]["after"] = _jax_aux(aux)
    for t in teacher.values():
        params = JE.StageParams(*map(jnp.asarray, t["params"]))
        for key, k in _coef_sets(coefs).items():
            (loss, parts), g = _JAX_LOSS_AND_GRADS(
                params, model, data, _jax_aux_of(t["after"]), k, cfg)
            t[key] = (float(loss), np.asarray(parts), _np(g))
    return jp, cycles, teacher


def _port_teacher(st, c, model, data, coefs, cfg):
    """The port's cycle c from JAX's state before it: the refreshed aux,
    and the loss, parts and gradients of `_coef_sets`."""
    tp, _, taux = _port_state(st)
    taux = TE.fused_aux_refresh(tp, taux, c, model, data, cfg)
    out = {"aux": aux_to_numpy(taux)}
    for key, k in _coef_sets(coefs).items():
        loss, parts, g = TE.cycle_loss_and_grads(tp, model, data, taux, k,
                                                 cfg)
        out[key] = (float(loss), n(parts), [n(x) for x in g])
    return out


def _raster_check(jm, tm, st, jcfg, tcfg, K):
    """Person 0's last two frames at a teacher state, JAX's verts, at
    its window: the z-buffer and the gradient with respect to the verts
    of a weighted log-disparity sum, through the port, the JAX package
    uncompiled, and the JAX package compiled."""
    params = JE.StageParams(*map(jnp.asarray, st["params"]))
    verts, _ = jax.jit(JE._smpl_bodies)(
        jm, params.poses_smpl[FRAMES - 2:FRAMES], params.betas,
        JE.scale_factor_of(params), params.poses_T[FRAMES - 2:FRAMES])
    verts = np.asarray(verts[:, 0])
    win = jcfg.person_windows[0]
    weights = np.random.RandomState(0).rand(len(verts), win, win).astype(
        np.float32)

    def jloss(v):
        r = JR.rasterize_bodies(v, jm.faces, jnp.asarray(K),
                                jcfg.raster_settings_for_window(win))
        z = r["zbuf"]
        ok = jnp.isfinite(z)
        disp = 1.0 / (jnp.where(ok, z, 1.0) + 0.2)
        return jnp.sum(jnp.where(ok, weights * jnp.log(disp), 0.0)), z

    out = {}
    (_, z), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(verts))
    out["compiled"] = (np.asarray(z), np.asarray(g))
    with jax.disable_jit():
        (_, z), g = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(verts))
    out["uncompiled"] = (np.asarray(z), np.asarray(g))
    v = torch.from_numpy(verts.copy()).requires_grad_(True)
    z = TR.rasterize_bodies(v, tm.faces, torch.from_numpy(K),
                            tcfg.raster_settings_for_window(win))["zbuf"]
    ok = torch.isfinite(z)
    disp = 1.0 / (torch.where(ok, z, torch.ones_like(z)) + 0.2)
    torch.sum(torch.where(ok, torch.from_numpy(weights) * torch.log(disp),
                          torch.zeros_like(z))).backward()
    out["port"] = (n(z.detach()), n(v.grad))
    return out


def run_tree(name, root):
    """Write the tree under `root`; run both packages' fits (JAX in a
    thread beside the port), the teacher-forced steps, the raster check
    and both evaluations."""
    spec = TREES[name]
    jm = make_synthetic_smpl(num_vertices=VERTICES, seed=7)
    tm = torch_model_of(jm)
    generate_sequence(str(root / "TS1"), num_frames=FRAMES, num_people=3,
                      image_size=(SIDE, SIDE), model=jm, mupots_gt=True,
                      seed=spec["seed"], degradations=spec["degradations"])
    kw = dict(DATA_KW, **spec["data"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPM, "resolve_smpl_model", lambda path: jm)
        mp.setattr(TPM, "resolve_smpl_model", lambda path: tm)
        jseq, _, p3d, _, vis = JPM.build_mupots_sequence(str(root), 1, **kw)
        tseq = TPM.build_mupots_sequence(str(root), 1, device="cpu",
                                         **kw)[0]
    args = make_args(raster_window=WINDOW, num_iter=CYCLES, **spec["args"])
    jpred = JPr.Predictor(jseq, jm, str(root / "jax"), args)
    tpred = TPr.Predictor(tseq, tm, str(root / "torch"), args, device="cpu")
    jcfg = dataclasses.replace(jpred.cfg, **REFRESH)
    tcfg = dataclasses.replace(tpred.cfg, **REFRESH)
    br = np.mean(jseq.betas_smpl, 0, keepdims=True).astype(np.float32)

    def init(E, pred, seq, cfg):
        return E.init_params(pred.model, seq.pose2d, seq.poses_smpl,
                             seq.betas_smpl, seq.cam["K"], cfg)

    jdata = JE.prepare_seq_data(jseq, jcfg)

    def jax_side():
        jp, _, jscale = init(JE, jpred, jseq, jcfg)
        return jscale, _jax_trajectory(
            jp, jscale, jpred.model, jdata,
            JE.init_aux(jcfg, VERTICES, jnp.asarray(br)), jpred.coefs, jcfg)

    with concurrent.futures.ThreadPoolExecutor(1) as pool, \
            _torch_threads(TORCH_THREADS):
        jax_run = pool.submit(jax_side)
        tp, _, tscale = init(TE, tpred, tseq, tcfg)
        tdata = TE.prepare_seq_data(tseq, tcfg)
        taux = TE.init_aux(tcfg, VERTICES, torch.from_numpy(br))
        tst = TE.rmsprop_init(tp)
        cycles = []
        for c in range(CYCLES):
            tp, tst, taux, loss, parts = TE.stage1_cycle_fused(
                tp, tst, taux, c, tpred.model, tdata, tpred.coefs, tcfg,
                tscale)
            cycles.append((float(loss), n(parts), [n(x) for x in tp],
                           (taux.have_scene, taux.have_filters)))
        jscale, (jp, jcycles, teacher) = jax_run.result()
        raster = pool.submit(_raster_check, jm, tm,
                             teacher[TEACHER_CYCLES[0]], jcfg, tcfg,
                             np.asarray(jseq.cam["K"], np.float32))
        port_teacher = {c: _port_teacher(st, c, tpred.model, tdata,
                                         tpred.coefs, tcfg)
                        for c, st in teacher.items()}
        raster = raster.result()

    def jax_joints(b, p):
        return np.asarray(smpl_forward(jm, b, p)["joints_mupots"])

    gt = (p3d, vis)
    metrics = (
        jax_eval(JE.get_optimized_variables(jp, jcfg, jseq.valid_smpl), *gt,
                 jax_joints, jseq.cam["K"]),
        compute_mm_pck_results(
            TE.get_optimized_variables(tp, tcfg, tseq.valid_smpl), *gt,
            joints_function(tm, "joints_mupots"), tseq.cam["K"]))
    return dict(name=name, jax=jcycles, torch=cycles, teacher=teacher,
                port_teacher=port_teacher, raster=raster, metrics=metrics,
                scale=(jscale, tscale), cfg=(jcfg, tcfg),
                jax_inputs=(jpred.model, jdata, jpred.coefs, jcfg))


def test_drift_per_cycle(traj):
    """Every cycle of the two independent trajectories (each package's
    own init solve and cycles) within the bounds above: the params
    pooled (max and 99th percentile of |port - JAX|), the loss and each
    logged part. Both packages pick the same optimize_scale. Printed a
    cycle: the two parameter distances, the loss's relative difference
    and the largest share of its bound any part uses."""
    assert traj["scale"][0] == traj["scale"][1]
    keys = list(TE.LOG_KEYS)
    for c, (j, t) in enumerate(zip(traj["jax"], traj["torch"])):
        d = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(t[2], j[2])])
        p99 = np.percentile(d, 99)
        loss_rel = abs(t[0] - j[0]) / abs(j[0])
        shares = []
        for k, (rtol, atol) in PART_BOUNDS.items():
            i = keys.index(k)
            diff, bound = abs(t[1][i] - j[1][i]), rtol * abs(j[1][i]) + atol
            assert diff <= bound, (c, k, t[1][i], j[1][i])
            shares.append(diff / bound if bound else 0.0)
        print(f"{traj['name']} cycle {c:2d}: max {d.max():.4f} p99 "
              f"{p99:.4f} loss {loss_rel:.4f} parts {max(shares):.2f} of "
              f"their bounds")
        assert d.max() <= max_abs_bound(c), (c, d.max())
        assert p99 <= p99_bound(c), (c, p99)
        assert loss_rel <= LOSS_RTOL, (c, t[0], j[0])


def test_refreshes_are_live(traj):
    """The scene rebuild and the filter refresh each run at least twice,
    on the same cycles in both packages, and from cycle 4 on the contact
    and filter terms are live in both."""
    jcfg, tcfg = traj["cfg"]
    flags = [TE.refresh_flags(c, tcfg) for c in range(CYCLES)]
    assert sum(s for s, _ in flags) >= 2 and sum(f for _, f in flags) >= 2
    assert (jcfg.warmup_cycles, jcfg.update_filters_every,
            jcfg.scene_update_every) == (tcfg.warmup_cycles,
                                         tcfg.update_filters_every,
                                         tcfg.scene_update_every)
    keys = list(TE.LOG_KEYS)
    for c, (j, t) in enumerate(zip(traj["jax"], traj["torch"])):
        assert j[3] == (float(c >= 4),) * 2 and t[3] == (c >= 4,) * 2, c
        for parts in (j[1], t[1]):
            for k in ("reg_contact", "reg_filter_verts"):
                assert (parts[keys.index(k)] > 0) == (c >= 4), (k, c)


@pytest.mark.parametrize("cycle", TEACHER_CYCLES)
def test_teacher_forced_cycle_matches(traj, cycle):
    """One cycle in each package from JAX's whole state before `cycle`
    (params, RMSprop nu / trace / count, scene, filtered targets and
    flags, carried across by `convert`), free of RMSprop's amplification
    of earlier rounding. The refreshed scene: valid exact, depth and
    points to 1e-5 relative (test_torch_engine's refreshes from the same
    params); the filtered targets to 1e-4 m or one bfloat16 ulp of the
    value (2^-7 relative), by which the cast may round a float32 value
    that differs in its last bits. The loss and each part to 1e-3
    relative and the gradients to 1e-2 relative norm (test_torch_engine's
    single cycle): every parameter's for the loss without the depth term,
    the z bounds' for the whole loss. The depth term's gradient with
    respect to the body goes through the ill-conditioned z planes of the
    module docstring; `test_raster_matches_uncompiled_jax` holds its
    raster, and `test_whole_loss_matches_uncompiled_jax` every gradient
    of the whole loss."""
    st, got = traj["teacher"][cycle], traj["port_teacher"][cycle]
    ref, aux = st["after"], got["aux"]
    for k, a, b in zip(TE.ScenePointCloud._fields, aux["scene"],
                       ref["scene"]):
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(aux["verts_filt_diff"],
                               ref["verts_filt_diff"].astype(np.float32),
                               rtol=2.0 ** -7, atol=1e-4)
    assert aux["have_scene"] and aux["have_filters"]
    for key in ("whole", "no_depth"):
        (tl, tparts, tg), (jl, jparts, jg) = got[key], st[key]
        np.testing.assert_allclose(tl, jl, rtol=1e-3, err_msg=key)
        np.testing.assert_allclose(tparts, jparts, rtol=1e-3, atol=1e-7,
                                   err_msg=key)
        errs = {name: rel_err(a, b)
                for name, a, b in zip(TE.PARAM_NAMES, tg, jg)}
        print(f"{traj['name']} cycle {cycle} {key} loss: gradients' "
              "relative norm " + ", ".join(f"{k} {v:.2g}"
                                           for k, v in errs.items()))
        for name, e in errs.items():
            if key == "no_depth" or name in Z_BOUNDS:
                assert e < 1e-2, (key, name, e)


def test_raster_matches_uncompiled_jax(traj):
    """Person 0's last two frames at the first teacher state, from JAX's
    verts: the port's z-buffer equals the JAX package's uncompiled ops
    bit for bit, and the gradient of a weighted log-disparity sum to
    1e-2 relative norm a body. Printed: how far the JAX package's
    compiled program lies from its own uncompiled ops (pixels whose z
    differs by more than 1e-5, the largest difference, the gradients'
    relative norm a body)."""
    r = traj["raster"]
    (zp, gp), (zu, gu), (zc, gc) = r["port"], r["uncompiled"], r["compiled"]
    np.testing.assert_array_equal(zp, zu)
    for b in range(len(gu)):
        assert rel_err(gp[b], gu[b]) < 1e-2, (b, rel_err(gp[b], gu[b]))
    fin = np.isfinite(zc) & np.isfinite(zu)
    dz = np.abs(zc[fin] - zu[fin])
    print(f"{traj['name']} compiled vs uncompiled JAX: "
          f"{int((dz > 1e-5).sum())} of "
          f"{zu.size} pixels differ by more than 1e-5 (max {dz.max():.3g});"
          " gradient relative norm a body "
          + ", ".join(f"{rel_err(gc[b], gu[b]):.3g}" for b in range(len(gu))))


@pytest.mark.slow
def test_whole_loss_matches_uncompiled_jax(traj):
    """From JAX's whole state before each of TEACHER_CYCLES, the port's
    whole loss against the JAX package's uncompiled ops: the loss and
    each part to 1e-3 relative, every parameter's gradient to 1e-2
    relative norm (test_torch_engine's single cycle). Printed a state:
    the port's gradients against the uncompiled ops, and the compiled
    program's against them. Slow tier (`--full`): the uncompiled ops
    take about 80 s a tree, most of it compiling each primitive."""
    model, data, coefs, cfg = traj["jax_inputs"]
    for c in TEACHER_CYCLES:
        st = traj["teacher"][c]
        tl, tparts, tg = traj["port_teacher"][c]["whole"]
        ul, uparts, ug = _jax_uncompiled(st["params"], model, data,
                                         st["after"], coefs, cfg)
        np.testing.assert_allclose(tl, ul, rtol=1e-3, err_msg=str(c))
        np.testing.assert_allclose(tparts, uparts, rtol=1e-3, atol=1e-7,
                                   err_msg=str(c))
        errs = {k: rel_err(a, b) for k, a, b in zip(TE.PARAM_NAMES, tg, ug)}
        print(f"{traj['name']} cycle {c} whole loss against the uncompiled "
              "JAX: gradients' relative norm, port " + ", ".join(
                  f"{k} {e:.2g}" for k, e in errs.items())
              + "; compiled " + ", ".join(
                  f"{k} {rel_err(a, b):.2g}" for k, a, b in zip(
                      TE.PARAM_NAMES, st["whole"][2], ug)))
        for k, e in errs.items():
            assert e < 1e-2, (c, k, e)


def test_final_metrics_match(traj):
    """The final params of both fits evaluated by each package's
    `compute_mm_pck_results` on the tree's GT: pck_rel within 1 point,
    mm_rel_error and abs_jitter within 5 mm (test_torch_entry's
    tolerances; the three metrics of the accuracy sweep)."""
    ref, got = traj["metrics"]
    print(f"{traj['name']} final (JAX, port): " + ", ".join(
        f"{k} {ref[k]:.2f} {got[k]:.2f}"
        for k in ("pck_rel", "mm_rel_error", "abs_jitter")))
    for k, tol in (("pck_rel", 1.0), ("mm_rel_error", 5.0),
                   ("abs_jitter", 5.0)):
        assert np.isfinite(got[k]) and abs(got[k] - ref[k]) <= tol, \
            (k, got[k], ref[k])


def test_aux_round_trip(traj):
    """`convert.aux_from_numpy` then `aux_to_numpy` give JAX's aux back
    bit for bit (the bfloat16 targets as their float32 values), flags
    as bools, for every state the teacher-forced steps start from."""
    for c, st in traj["teacher"].items():
        a = st["aux"]
        got = aux_to_numpy(_port_state(st)[2])
        np.testing.assert_array_equal(got["betas_ref"], a["betas_ref"])
        for k, x, ref in zip(TE.ScenePointCloud._fields, got["scene"],
                             a["scene"]):
            assert x.dtype == ref.dtype, k
            np.testing.assert_array_equal(x, ref, err_msg=k)
        np.testing.assert_array_equal(got["verts_filt_diff"],
                                      a["verts_filt_diff"].astype(np.float32))
        assert got["have_scene"] == bool(a["have_scene"]) == (c > 4)
        assert got["have_filters"] == bool(a["have_filters"]) == (c > 4)


def test_opt_state_round_trip(traj):
    """`convert.opt_state_from_optax` carries JAX's RMSprop nu, trace and
    schedule count across bit for bit."""
    for c, st in traj["teacher"].items():
        got = _port_state(st)[1]
        assert got.count == st["count"] == c
        for tree, ref in ((got.nu, st["nu"]), (got.trace, st["trace"])):
            for name, a, b in zip(TE.PARAM_NAMES, tree, ref):
                np.testing.assert_array_equal(n(a), b, err_msg=name)

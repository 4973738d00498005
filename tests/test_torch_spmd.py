"""The port's frame-axis sharding (mhmocap_tpu_torch/parallel/spmd.py)
against the JAX package's (mhmocap_tpu/parallel/spmd.py) and against the
port's own single-process cycle, on the CPU.

The port's ranks are processes over gloo (`parallel.ranks.run_ranks`,
file rendezvous, a join deadline), started once per module for each D
in (2, 4); the JAX side runs in the test process on a D-device mesh of
the virtual CPU devices. The problem is tests/test_spmd.py's: a 256-vertex
body, 32x32, T=16, N=2, chunk 2, window 16 (D=2: 4 chunks a rank; D=4: 2).

Tolerances: against JAX, as tests/test_torch_engine.py (loss and parts
1e-3 relative, gradients 1e-2 relative norm, params after 3 fused cycles
5e-3). Against the port's single process on the same time layout: bit
for bit, because each chunk computes the same bits and the sharded cycle
adds the chunks' shared terms in the single process's order.
"""

import concurrent.futures
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import jax_model_arrays, n, rel_err, t, torch_model_of

from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
from mhmocap_tpu.engine import optimizer as JE
from mhmocap_tpu.engine import predictor as JPr
from mhmocap_tpu.models.smpl import smpl_forward
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops.cameras import intrinsics_from_fov, project_points
from mhmocap_tpu.parallel import spmd as JS
from mhmocap_tpu_torch import convert
from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
from mhmocap_tpu_torch.engine import optimizer as TE
from mhmocap_tpu_torch.engine import predictor as TPr
from mhmocap_tpu_torch.parallel import spmd as TS
from mhmocap_tpu_torch.parallel.ranks import run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
T, N, W = 16, 2, 32
CFG = dict(image_size=(W, W), num_people=N, num_frames=T, chunk=2,
           window=16, face_chunk=128, frame_bucket=16)
# cycles 2-4 past a warmup of 2: the scene rebuilds every cycle and the
# filtered targets refresh at 2 and 4
FUSED = dict(warmup_cycles=2, update_filters_every=2, scene_update_every=1)
CYCLES = (2, 3, 4)
# stale spans across the shard boundaries of both D (4 and 8)
STALE = np.zeros((T, N), bool)
STALE[3:6, 0] = True
STALE[7:10, 1] = True
DS = (2, 4)
RANK_TIMEOUT = 400.0


def seq_fields(jm):
    """tests/test_spmd.py's sequence: 2D poses from the body itself."""
    K = intrinsics_from_fov((W, W), 60.0)
    rng = np.random.RandomState(0)
    poses = 0.05 * rng.randn(T, N, 72).astype(np.float32)
    betas = np.zeros((T, N, 10), np.float32)
    pT = np.zeros((T, N, 1, 3), np.float32)
    pT[:, :, 0, 2] = 3.0
    pT[:, 0, 0, 0], pT[:, 1, 0, 0] = -0.4, 0.4
    out = smpl_forward(jm, jnp.asarray(betas.reshape(-1, 10)),
                       jnp.asarray(poses.reshape(-1, 72)))
    j3d = np.asarray(out["joints_alphapose"]).reshape(T, N, 17, 3) + pT
    uv = np.asarray(project_points(jnp.asarray(j3d), jnp.asarray(K)))
    pose2d = np.concatenate([uv, 0.9 * np.ones((T, N, 17, 1), np.float32)],
                            -1)
    seg = np.zeros((T, N, W, W), np.float32)
    seg[:, 0, 8:24, 4:14] = 1
    seg[:, 1, 8:24, 18:28] = 1
    return dict(
        images=np.zeros((T, W, W, 3), np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, W, W), 0, 1).astype(
            np.float32),
        instances=np.zeros((T, W, W), np.uint8), seg_mask=seg,
        backmasks=1.0 - seg.max(axis=1), pose2d=pose2d,
        cam_smpl=np.zeros((T, N, 3), np.float32), poses_smpl=poses,
        betas_smpl=betas, valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": K, "fov": 60.0, "Kd": None, "image_size": (W, W)})


@pytest.fixture(scope="module")
def prob():
    jm = make_synthetic_smpl(num_vertices=256, seed=2)
    kw = seq_fields(jm)
    jcfg = JE.EngineConfig(**CFG)
    jp, _, _ = JE.init_params(jm, kw["pose2d"], kw["poses_smpl"],
                              kw["betas_smpl"], kw["cam"]["K"], jcfg,
                              num_iter=20)
    betas_ref = np.mean(kw["betas_smpl"], 0, keepdims=True)
    payload = dict(model=jax_model_arrays(jm), seq=kw, cfg=CFG,
                   params=[np.asarray(x) for x in jp], betas_ref=betas_ref,
                   coefs=JE.default_coefs(), stale=STALE, cycles=CYCLES,
                   fused_cfg=FUSED)
    return dict(jm=jm, kw=kw, jp=jp, betas_ref=betas_ref, payload=payload,
                coefs=JE.default_coefs())


@pytest.fixture(scope="module")
def ranks(prob):
    """tests/torch_spmd_ranks.py:cycle_job on D = 2 and 4 ranks, the two
    groups side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(DS)) as ex:
        futs = {D: ex.submit(run_ranks, "torch_spmd_ranks:cycle_job", D,
                             prob["payload"], timeout=RANK_TIMEOUT,
                             path=[TESTS], threads=1) for D in DS}
        return {D: f.result() for D, f in futs.items()}


def jax_problem(prob, overrides=None, stale=None):
    cfg = JE.EngineConfig(**{**CFG, **(overrides or {})})
    data = JE.prepare_seq_data(JSeq(**prob["kw"], lagged_tn=stale), cfg)
    aux = JE.init_aux(cfg, 256, jnp.asarray(prob["betas_ref"]))
    return cfg, data, aux


def jax_sharded_loss(prob, D, overrides=None, stale=None):
    cfg, data, aux = jax_problem(prob, overrides, stale)
    mesh = JS.make_mesh(jax.devices()[:D])
    f = jax.jit(jax.value_and_grad(
        lambda pa, d, a: JS.spmd_cycle_loss(pa, prob["jm"], d, a,
                                            prob["coefs"], cfg, mesh),
        has_aux=True))
    (loss, parts), g = f(JS.shard_params(prob["jp"], mesh),
                         JS.shard_data(data, mesh), JS.shard_aux(aux, mesh))
    return float(loss), np.asarray(parts), [np.asarray(x) for x in g]


def torch_single_loss(prob, overrides=None, stale=None):
    cfg = TE.EngineConfig(**{**CFG, **(overrides or {})})
    data = TE.prepare_seq_data(TSeq(**prob["kw"], lagged_tn=stale), cfg)
    aux = TE.init_aux(cfg, 256, t(prob["betas_ref"]))
    loss, parts, g = TE.cycle_loss_and_grads(
        convert.params_from_numpy(prob["payload"]["params"]),
        torch_model_of(prob["jm"]), data, aux, prob["coefs"], cfg)
    return float(loss), n(parts), [n(x) for x in g]


def check_loss(got, ref, loss_rtol, grad_rel, parts_atol):
    if loss_rtol == 0:
        assert got["loss"] == ref[0]
        np.testing.assert_array_equal(got["parts"], ref[1])
        for name, a, b in zip(TE.PARAM_NAMES, got["grads"], ref[2]):
            np.testing.assert_array_equal(a, b, err_msg=name)
        return
    np.testing.assert_allclose(got["loss"], ref[0], rtol=loss_rtol)
    np.testing.assert_allclose(got["parts"], ref[1], rtol=loss_rtol,
                               atol=parts_atol)
    for name, a, b in zip(TE.PARAM_NAMES, got["grads"], ref[2]):
        assert rel_err(a, b) < grad_rel, (name, rel_err(a, b))


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("user_bucket", [0, 30, 64])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_tune_time_layout_matches_jax(n_dev, user_bucket):
    """Every length of interest, the lcm inflation warning included."""
    for T_ in (5, 8, 16, 31, 32, 64, 100, 201, 2000, 2300):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = TPr.tune_time_layout(T_, n_dev, user_bucket, 10)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            ref = JPr.tune_time_layout(T_, n_dev, user_bucket, 10)
        assert got == ref, (T_, got, ref)
        assert [w.category for w in tw] == [w.category for w in jw], T_
        chunk, bucket = got
        if n_dev > 1:
            assert bucket % (n_dev * chunk) == 0


def test_bench_layouts():
    """bench-ts1 (T=201): chunk 29 x 7 on one rank, 34 x 3 a rank on 2
    (padded 204), 17 x 3 a rank on 4: the raster calls of B=34 and B=17
    that workload.KERNEL_SHAPES holds for the card's checks."""
    from mhmocap_tpu_torch.workload import KERNEL_SHAPES
    for D, chunk in ((1, 29), (2, 34), (4, 17)):
        c, b = TPr.tune_time_layout(201, D)
        cfg = TE.EngineConfig(image_size=(256, 256), num_people=3,
                              num_frames=201, chunk=c, frame_bucket=b)
        assert c == chunk and cfg.padded_frames // (D * c) in (3, 7)
        assert (c, (160, 128, 112)) in KERNEL_SHAPES


def test_indivisible_layout_raises():
    """8 ranks x chunk 3 does not divide padded 36: a ValueError before
    any exchange."""
    bad = TE.EngineConfig(image_size=(16, 16), num_people=1, num_frames=30,
                          chunk=3, frame_bucket=16)
    assert bad.padded_frames % (8 * bad.chunk) != 0
    mesh = TS.TimeMesh(rank=0, size=8, group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        TS.spmd_cycle_loss_and_grads(None, None, None, None, None, bad, mesh)
    assert mesh.collectives["all_gather"] == 0


@pytest.mark.parametrize("D", DS)
def test_sharded_loss_matches_jax(prob, ranks, D):
    ref = jax_sharded_loss(prob, D)
    for r in ranks[D]:
        check_loss(r["loss"], ref, 1e-3, 1e-2, 1e-7)


@pytest.mark.parametrize("D", DS)
def test_sharded_loss_matches_single_process(prob, ranks, D):
    """Loss, parts and every gradient, bit for bit."""
    ref = torch_single_loss(prob)
    for r in ranks[D]:
        check_loss(r["loss"], ref, 0, 0, 0)


@pytest.mark.parametrize("D", DS)
def test_gap_aware_halo_matches(prob, ranks, D):
    """gap_aware_temporal widens the halo to 2 frames and carries the
    stale mask across with it; the stale spans cross the shard
    boundaries. reg_gap_accel is live."""
    over = {"gap_aware_temporal": True}
    for r in ranks[D]:
        got = r["gap"]
        assert got["parts"][list(TE.LOG_KEYS).index("reg_gap_accel")] > 0
        check_loss(got, jax_sharded_loss(prob, D, over, STALE), 1e-3, 1e-2,
                   1e-7)
        check_loss(got, torch_single_loss(prob, over, STALE), 0, 0, 0)


@pytest.fixture(scope="module")
def fused_refs(prob):
    """The fused cycles CYCLES from the init state: the JAX package's
    sharded cycle on each D and the port's single-process cycle."""
    cfg, data, aux = jax_problem(prob, FUSED)
    out = {}
    for D in DS:
        mesh = JS.make_mesh(jax.devices()[:D])
        p = JS.shard_params(jax.tree.map(jnp.array, prob["jp"]), mesh)
        st = JS.shard_opt_state(JE.make_stage1_optimizer().init(p), mesh)
        a = JS.shard_aux(jax.tree.map(jnp.array, aux), mesh)
        d = JS.shard_data(data, mesh)
        losses, parts = [], []
        for c in CYCLES:
            p, st, a, loss, pa = JS.spmd_stage1_cycle_fused(
                p, st, a, jnp.uint32(c), prob["jm"], d, prob["coefs"], cfg,
                mesh)
            losses.append(float(loss))
            parts.append(np.asarray(pa))
        out[D] = dict(loss=losses, parts=parts,
                      params=[np.asarray(x) for x in p],
                      scene_depth=np.asarray(a.scene.depth),
                      dvf=np.asarray(a.verts_filt_diff.astype(jnp.float32)))
    tcfg = TE.EngineConfig(**{**CFG, **FUSED})
    tdata = TE.prepare_seq_data(TSeq(**prob["kw"]), tcfg)
    tp = convert.params_from_numpy(prob["payload"]["params"])
    taux = TE.init_aux(tcfg, 256, t(prob["betas_ref"]))
    tst = TE.rmsprop_init(tp)
    tm = torch_model_of(prob["jm"])
    losses, parts = [], []
    for c in CYCLES:
        tp, tst, taux, loss, pa = TE.stage1_cycle_fused(
            tp, tst, taux, c, tm, tdata, prob["coefs"], tcfg)
        losses.append(float(loss))
        parts.append(n(pa))
    out["single"] = dict(loss=losses, parts=parts, params=[n(x) for x in tp],
                         scene_depth=n(taux.scene.depth),
                         dvf=n(taux.verts_filt_diff.float()))
    return out


@pytest.mark.parametrize("ref", ["jax", "single"])
@pytest.mark.parametrize("D", DS)
def test_fused_cycles_match(ranks, fused_refs, D, ref):
    """Three fused cycles with the scene rebuild and the filter refresh,
    on every rank. Against JAX: losses and parts per cycle to 1e-3
    relative, params after the three to 5e-3 (RMSprop's normalized
    steps, see test_torch_engine), the refreshed scene depth to 1e-3
    relative and the bf16 filtered targets to 2e-3 m. Against the
    single process: all of it bit for bit."""
    want = fused_refs[D if ref == "jax" else "single"]
    for r in ranks[D]:
        got = r["fused"]
        assert got["have"] == (True, True)
        if ref == "single":
            assert got["loss"] == want["loss"]
            for k in ("parts", "params"):
                for a, b in zip(got[k], want[k]):
                    np.testing.assert_array_equal(a, b, err_msg=k)
            np.testing.assert_array_equal(got["scene_depth"],
                                          want["scene_depth"])
            np.testing.assert_array_equal(got["dvf"], want["dvf"])
            continue
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
        np.testing.assert_allclose(np.stack(got["parts"]),
                                   np.stack(want["parts"]), rtol=1e-3,
                                   atol=1e-6)
        for name, a, b in zip(TE.PARAM_NAMES, got["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=5e-3, rtol=0, err_msg=name)
        np.testing.assert_allclose(got["scene_depth"], want["scene_depth"],
                                   rtol=1e-3)
        np.testing.assert_allclose(got["dvf"], want["dvf"], atol=2e-3)


@pytest.mark.parametrize("D", DS)
def test_replicated_params_equal_on_every_rank(ranks, D):
    """betas, xscale and their RMSprop state after the three cycles:
    the same bits on every rank."""
    first = ranks[D][0]["fused"]["replicated"]
    for r in ranks[D][1:]:
        for a, b in zip(r["fused"]["replicated"], first):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("D", DS)
def test_collectives_within_budget(ranks, D):
    """Each fused cycle makes exactly the exchanges of
    spmd.cycle_collectives: 3 all_gathers (the halo, its gradient, each
    chunk's loss and shared gradients), one more for the z bounds of a
    scene rebuild and one for the poses of a filter refresh, no barrier;
    the bytes are the halo's, the chunks' rows and the refreshes' (O(T N
    75) poses, never O(T N V) vertices, never O(T H W) depths)."""
    for r in ranks[D]:
        got, budget = r["fused"]["collectives"], r["fused"]["budget"]
        assert got == budget
        assert [b["all_gather"] for b in budget] == [5, 4, 5]
        assert max(b["all_gather_bytes"] for b in budget) <= 4 * (
            (T // D) * N * 75 + (T // D) * 2 + 2 * 2 * N * 77 + 200)


# ---------------------------------------------------------------------------
# The Predictor and the entry point on ranks

@pytest.fixture(scope="module")
def predictor_ranks(prob, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spmd_predictor"))
    payload = dict(model=prob["payload"]["model"], seq=prob["kw"],
                   stale=STALE, tmp=tmp, num_iter=3)
    return tmp, run_ranks("torch_spmd_ranks:predictor_job", 2, payload,
                          timeout=RANK_TIMEOUT, path=[TESTS], threads=1)


def test_predictor_run_on_two_ranks(prob, predictor_ranks):
    """Predictor.run under a 2-rank process group: the banner, the
    pickles written once (rank 0's directory only), the stale mask in
    optvar_stage1.pkl, and the stage-1 result of the single-process run
    (T=16 gets the same time layout on 1 and 2 ranks: bit for bit)."""
    from mhmocap_tpu_torch.workload import bench_args
    tmp, res = predictor_ranks
    assert (res[0]["chunk"], res[0]["padded"]) == (
        TPr.tune_time_layout(T, 2)[0], T) and res[0]["gap"]
    assert "fit: sharding 16 frames over 2 devices" in res[0]["printed"]
    assert "fit: sharding" not in res[1]["printed"]
    assert sorted(os.listdir(os.path.join(tmp, "own1"))) == []
    assert {"optvar_init.pkl", "optvar_stage1.pkl"} <= set(
        os.listdir(os.path.join(tmp, "own0")))
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    np.testing.assert_array_equal(res[0]["betas"], res[1]["betas"])
    with open(os.path.join(tmp, "own0", "optvar_stage1.pkl"), "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["lagged_tn"], STALE)

    args = bench_args(3, None, 16)
    args.gap_aware_temporal = True
    single = TPr.Predictor(TSeq(**prob["kw"], lagged_tn=STALE),
                           torch_model_of(prob["jm"]),
                           str(tmp) + "/single", args, device="cpu")
    assert not single.use_spmd
    assert (single.cfg.chunk, single.cfg.padded_frames) == (
        res[0]["chunk"], res[0]["padded"])
    ref = single.run(verbose=False)["stage1_optvar"]
    for k in ("poses_T", "poses_smpl", "betas_smpl", "min_z", "max_z",
              "scale_factor", "scene_depth"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_checkpoint_resume_under_sharding(predictor_ranks):
    """4 cycles unbroken against 2 + 2 resumed from rank 0's gathered
    checkpoint with checkpoint_every=1: bit for bit."""
    tmp, res = predictor_ranks
    assert "resumed from checkpoint at cycle 1" in res[0]["resumed_printed"]
    for r in res:
        np.testing.assert_array_equal(r["resumed_losses"],
                                      r["whole_losses"][2:])
    pk = {}
    for d in ("whole", "split"):
        with open(os.path.join(tmp, d, "optvar_stage1.pkl"), "rb") as f:
            pk[d] = pickle.load(f)
    for k, v in pk["whole"].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(pk["split"][k], v, err_msg=k)


@pytest.mark.parametrize("entry", ["predict_mupots", "predict_internet"])
def test_entry_point_under_the_launcher(tmp_path, entry):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    mhmocap_tpu_torch.<entry> ... --device cpu on a port-written tree:
    both ranks ingest and fit sharded over gloo, rank 0 writes the
    pickles."""
    from mhmocap_tpu_torch import sweep
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    body = make_synthetic_smpl(num_vertices=512)
    generate_sequence(str(tmp_path / "data" / "TS1"), num_frames=8,
                      num_people=2, image_size=(64, 64), model=body, seed=3,
                      mupots_gt=True)
    cfg = sweep.write_config(str(tmp_path / "p.yml"), sweep.sweep_config(
        str(tmp_path / "data"), 3, raster_window=32))
    if entry == "predict_mupots":
        args = ["--ts_id", "1", "--output_path", str(tmp_path / "out")]
        out = tmp_path / "out" / "TS1"
        want = {"optvar_init.pkl", "optvar_stage1.pkl", "mupots_annot.pkl"}
    else:
        args = ["--input_path", str(tmp_path / "data" / "TS1"),
                "--output_path", str(tmp_path / "out")]
        out = tmp_path / "out"
        want = {"optvar_init.pkl", "optvar_stage1.pkl"}
    env = dict(os.environ, MHMOCAP_SYNTHETIC_SMPL="512", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", f"mhmocap_tpu_torch.{entry}",
         "--configs_yml", cfg, *args, "--device", "cpu"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("fit: sharding 8 frames over 2 devices") == 1
    assert set(os.listdir(out)) == want
    with open(out / "optvar_stage1.pkl", "rb") as f:
        st1 = pickle.load(f)
    assert st1["poses_T"].shape == (8, 2, 1, 3)
    assert np.isfinite(st1["poses_T"]).all()

"""The port's headline benchmark (`mhmocap_tpu_torch/bench.py`) and the
capture ahead of the cycles (`CycleGraph.prepare`, `on_snapshot`), on
the CPU.

A tiny bench workload (T=8, N=2, 64x64, a 384-vertex synthetic body,
window 32, window boundaries (4, 6, 8, 10)). On the port's side the
refresh cadence is shrunk (warmup_cycles 5, update_filters_every 3), so
that the first scene rebuild (cycle 5), the first filter refresh (6)
and the first rebuild with filters (7) fall inside the timed windows.
Both packages' `bench.main` run unedited: only attributes of their
modules are replaced (make_ts1_like_seq, T, N, SIDE, WINDOW,
BENCH_CYCLES, and on the JAX side the TPU backend wait).
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import n, torch_model_of

from mhmocap_tpu.engine import optimizer as JE
from mhmocap_tpu.engine import predictor as JPr
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch import bench as tbench
from mhmocap_tpu_torch import workload
from mhmocap_tpu_torch.engine import cycle_graph as CG
from mhmocap_tpu_torch.engine import predictor as TPr

T, N, SIDE, WINDOW = 8, 2, 64, 32
CYCLES = (4, 6, 8, 10)
CADENCE = dict(warmup_cycles=5, update_filters_every=3)
# the four variants of a fit at CADENCE over cycles [0, 11), in their
# order of first use (cycles 0, 5, 6 and 7)
VARIANTS = [CG.Variant(False, False, False, False),
            CG.Variant(True, False, True, False),
            CG.Variant(True, True, True, True),
            CG.Variant(True, False, True, True)]


class ShortCadence(TPr.Predictor):
    """The port's Predictor with the refresh cadence shrunk."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.cfg = dataclasses.replace(self.cfg, **CADENCE)


@pytest.fixture(scope="module")
def body():
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    return jm, torch_model_of(jm)


@pytest.fixture
def port_bench(body, monkeypatch):
    """The port's bench module on the tiny workload."""
    _, tm = body
    monkeypatch.setattr(tbench, "make_ts1_like_seq",
                        lambda T, N, side: workload.make_ts1_like_seq(
                            T, N, side, model=tm))
    for name, value in (("T", T), ("N", N), ("SIDE", SIDE),
                        ("WINDOW", WINDOW), ("BENCH_CYCLES", CYCLES),
                        ("Predictor", ShortCadence)):
        monkeypatch.setattr(tbench, name, value)
    return tbench


def _lines(out):
    """(the JSON object, the `#` line's key=value tokens) of a bench
    run's output."""
    lines = out.strip().splitlines()
    line = [x for x in lines if x.startswith("{")][-1]
    rest = lines[lines.index(line) + 1:]
    assert len(rest) == 1 and rest[0].startswith("# "), rest
    keys = [tok.split("=")[0] for tok in rest[0][2:].split()
            if "=" in tok]
    return json.loads(line), keys


def test_bench_line_matches_jax(body, port_bench, monkeypatch, capsys):
    """The port's JSON line has the JAX bench.main line's keys, unit,
    baseline flag, number of windows and workload string, on the same
    tiny workload; its value is T over the median window's seconds a
    cycle, and its `#` line names the device and its power limit."""
    jm, _ = body
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       jax.config.jax_compilation_cache_dir)
    import bench
    orig = bench.make_ts1_like_seq
    monkeypatch.setattr(bench, "make_ts1_like_seq",
                        lambda: orig(T=T, N=N, side=SIDE, model=jm))
    for name, value in (("T", T), ("N", N), ("SIDE", SIDE),
                        ("WINDOW", WINDOW), ("BENCH_CYCLES", CYCLES),
                        ("_wait_for_backend", lambda: None)):
        monkeypatch.setattr(bench, name, value)
    bench.main()
    ref, ref_keys = _lines(capsys.readouterr().out)

    res = port_bench.main(["--device", "cpu"])
    got, keys = _lines(capsys.readouterr().out)
    assert got == res
    assert set(got) == set(ref)
    assert set(got["secondary"]) == set(ref["secondary"])
    for k in ("metric", "unit", "baseline_estimated"):
        assert got[k] == ref[k], k
    assert got["secondary"]["workload"] == ref["secondary"]["workload"] \
        == f"T={T} N={N} side={SIDE} window={WINDOW} cycles{list(CYCLES)}"
    wins = got["secondary"]["window_frame_cycles_per_sec"]
    assert len(wins) == len(ref["secondary"]["window_frame_cycles_per_sec"]) \
        == len(CYCLES) - 1
    assert all(np.isfinite(w) and w > 0 for w in wins)
    # the median of three windows' rates is T / the median s a cycle
    assert got["value"] == pytest.approx(float(np.median(wins)), abs=0.02)
    assert got["vs_baseline"] == pytest.approx(
        got["value"] / tbench.REFERENCE_FRAME_CYCLES_PER_SEC, abs=1e-3)
    # bench.py's `#` line, with the set-up in place of the compile
    assert keys == ["device", "power", "setup", "prod_cycle", "bare_cycle",
                    "dispersion", "total_run"]
    assert [k for k in ref_keys if k != "compile"] == \
        [k for k in keys if k not in ("power", "setup")]


@pytest.fixture(scope="module")
def bare_states(body, tmp_path_factory):
    """The steps of bench_bare_cycle in both packages on the tiny
    sequence: (JAX loss, parts), (port loss, parts)."""
    jm, tm = body
    import bench
    jseq, _ = bench.make_ts1_like_seq(T=T, N=N, side=SIDE, model=jm)
    tseq, _ = workload.make_ts1_like_seq(T, N, SIDE, model=tm)
    args = workload.bench_args(CYCLES[-1] + 1, CYCLES, WINDOW)
    args.spmd = False
    jpred = JPr.Predictor(jseq, jm, str(tmp_path_factory.mktemp("j")), args)
    tpred = TPr.Predictor(tseq, tm, str(tmp_path_factory.mktemp("t")), args,
                          device="cpu")
    cfg = jpred.cfg
    params, _, _ = JE.init_params(
        jm, jseq.pose2d, jseq.poses_smpl, jseq.betas_smpl, jseq.cam["K"],
        cfg, num_iter=5)
    data = JE.prepare_seq_data(jseq, cfg)
    aux = JE.init_aux(cfg, jm.num_vertices, jnp.asarray(
        jseq.betas_smpl[:1].mean(0, keepdims=True)))
    aux = aux._replace(scene=JE.update_scene(params, data, cfg),
                       have_scene=jnp.ones(()))
    opt_state = JE.make_stage1_optimizer().init(params)
    _, _, jloss, jparts = JE.stage1_cycle(params, opt_state, jm, data, aux,
                                          jpred.coefs, cfg)
    graph = tbench.bare_cycle_graph(tpred)
    graph.replay(0)
    return ((float(jloss), np.asarray(jparts)),
            (float(graph.state.losses[0]), n(graph.state.parts[0])))


def test_bare_cycle_matches_jax(bare_states):
    """bench_bare_cycle's state (a 5-step init solve, the scene rebuilt
    from it, one cycle) gives JAX's loss and parts: 1e-3 relative (atol
    1e-7 on the parts), test_torch_engine's cycle tolerance, since hard
    z-buffer coverage can flip at an ulp-level vertex difference."""
    (jl, jparts), (tl, tparts) = bare_states
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    np.testing.assert_allclose(tparts, jparts, rtol=1e-3, atol=1e-7)


def test_bare_cycle_has_a_scene_and_no_refresh(body, tmp_path):
    """The bare cycle is the variant with a scene, no filtered targets
    and no refresh, and its replays step the optimizer."""
    _, tm = body
    seq, _ = workload.make_ts1_like_seq(T, N, SIDE, model=tm)
    pred = TPr.Predictor(seq, tm, str(tmp_path), workload.bench_args(
        1, None, WINDOW), device="cpu")
    graph = tbench.bare_cycle_graph(pred, n_meas=2)
    assert graph.num_cycles == 3 and graph.have_scene
    assert graph.state.scene.valid.any()
    v = graph.replay(0)
    assert v == CG.Variant(False, False, True, False)
    p0 = graph.state.params.poses_T.clone()
    assert graph.replay(0) == v and int(graph.state.count) == 2
    assert not torch.equal(graph.state.params.poses_T, p0)


def _fit(tm, tmp, bench_cycles):
    seq, _ = workload.make_ts1_like_seq(T, N, SIDE, model=tm)
    args = workload.bench_args(CYCLES[-1] + 1, bench_cycles, WINDOW)
    pred = ShortCadence(seq, tm, str(tmp), args, device="cpu")
    out = pred.run(verbose=False)
    return pred, out


def test_timed_fit_is_bit_identical(body, tmp_path):
    """A fit with bench_cycles (synchronized at the window marks) equals
    a fit without them bit for bit (losses, parts, params, scene,
    filtered targets), and records one time a window; on the CPU no
    graph is captured."""
    _, tm = body
    plain, plain_out = _fit(tm, tmp_path / "plain", None)
    timed, timed_out = _fit(tm, tmp_path / "timed", CYCLES)
    assert plain.capture_seconds == timed.capture_seconds == {}
    assert plain.bench_window_seconds is None
    assert len(timed.bench_window_seconds) == len(CYCLES) - 1
    np.testing.assert_array_equal(timed.stage1_losses, plain.stage1_losses)
    assert timed_out["stage1_log"] == plain_out["stage1_log"]
    for a, b in zip(CG.tree_leaves((timed._params, timed._aux)),
                    CG.tree_leaves((plain._params, plain._aux))):
        assert torch.equal(a, b)


def _graph(tm, tmp_path, num_cycles=10):
    """A CycleGraph over the tiny sequence at CADENCE, at cycle 0."""
    seq, _ = workload.make_ts1_like_seq(T, N, SIDE, model=tm)
    pred = ShortCadence(seq, tm, str(tmp_path), workload.bench_args(
        1, None, WINDOW), device="cpu")
    cfg, model = pred.cfg, pred.model
    from mhmocap_tpu_torch.engine import optimizer as TE
    params, _, opt_scale = TE.init_params(
        model, seq.pose2d, seq.poses_smpl, seq.betas_smpl, seq.cam["K"],
        cfg, num_iter=5)
    data = TE.prepare_seq_data(seq, cfg)
    aux = TE.init_aux(cfg, model.num_vertices, torch.as_tensor(
        np.mean(seq.betas_smpl, 0, keepdims=True)))
    return CG.CycleGraph(params, TE.rmsprop_init(params), aux, model, data,
                         pred.coefs, cfg, opt_scale, num_cycles=num_cycles)


def test_prepare_finds_the_variants_replay_runs(body, tmp_path):
    """The variants prepare captures on the card (`variants`) are those
    replay runs, in their order of first use, from cycle 0 and mid-fit;
    on the CPU prepare captures nothing and leaves the state alone."""
    _, tm = body
    graph = _graph(tm, tmp_path, num_cycles=CYCLES[-1] + 1)
    assert graph.variants(0, CYCLES[-1] + 1) == VARIANTS
    assert graph.variants(0, 5) == VARIANTS[:1]
    before = [x.clone() for x in CG.tree_leaves(graph.state)]
    graph.prepare(0, CYCLES[-1] + 1)
    assert graph.graphs == {} and graph.capture_seconds == {}
    for a, b in zip(CG.tree_leaves(graph.state), before):
        assert torch.equal(a, b)
    ran = []
    for c in range(6):
        ran.append(graph.replay(c))
    assert graph.variants(6, CYCLES[-1] + 1) == VARIANTS[2:]
    for c in range(6, CYCLES[-1] + 1):
        ran.append(graph.replay(c))
    assert list(dict.fromkeys(ran)) == VARIANTS


def test_on_snapshot_restores_every_buffer(body, tmp_path):
    """A cycle run `on_snapshot` (as prepare runs a capture's warm-up)
    changes the state while it runs and leaves every static buffer as it
    found it, mid-fit, for each variant the fit has left; the cycles
    after it equal those of a graph that never ran it, bit for bit."""
    _, tm = body
    ref, graph = _graph(tm, tmp_path / "ref"), _graph(tm, tmp_path / "g")
    for c in range(6):
        ref.replay(c)
        graph.replay(c)
    before = [x.clone() for x in CG.tree_leaves(graph.state)]
    for v in graph.variants(6, 10):
        def run():
            CG.cycle_body(graph.state, v, graph.model, graph.data,
                          graph.coefs, graph.cfg, graph.optimize_scale)
            return (int(graph.state.cycle), int(graph.state.count),
                    sum(not torch.equal(a, b) for a, b in zip(
                        CG.tree_leaves(graph.state), before)))
        row, count, changed = graph.on_snapshot(run)
        assert (row, count) == (7, 7) and changed > 3, v
        for a, b in zip(CG.tree_leaves(graph.state), before):
            assert torch.equal(a, b)
    for c in range(6, 10):
        assert graph.replay(c) == ref.replay(c)
    for a, b in zip(CG.tree_leaves(graph.state), CG.tree_leaves(ref.state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_bench_needs_a_gpu_unless_device_cpu(argv):
    """Without a GPU the bench raises, naming --device cpu, before it
    builds anything; it never measures the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tbench.main(argv)

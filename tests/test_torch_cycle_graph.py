"""The port's static-state cycle and init bodies (`engine/cycle_graph.py`),
which the card captures as CUDA graphs, on the CPU, where they run
eagerly: against the eager loop bit for bit, against the JAX package's
`stage1_cycles_fused` and `init_global_poses` within the tolerances of
tests/test_torch_helpers.py and tests/test_torch_engine.py, their
schedule tables, checkpoint resume through the static buffers, and a
guard that no body builds a tensor from host data or reads the device
back after its first call (what a capture refuses).

Tiny sequence (T=8, N=2, 48x48, 384-vertex body) with the refresh
cadence shrunk (warmup_cycles 2, update_filters_every 3), so that cycles
0-6 run every variant: no refresh (0-1), the scene rebuild (2), both
refreshes (3, 6), the rebuild with filters (4-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode

from test_torch_engine import CFG, params_np, seq_arrays
from torch_parity import n, t, torch_model_of

from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
from mhmocap_tpu.engine import optimizer as JE
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch import convert
from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
from mhmocap_tpu_torch.engine import cycle_graph as CG
from mhmocap_tpu_torch.engine import optimizer as TE
from mhmocap_tpu_torch.engine import predictor as TPr
from mhmocap_tpu_torch.ops import image as TI
from mhmocap_tpu_torch.ops import phase_marks as PM

CYCLES = 7
CADENCE = dict(CFG, warmup_cycles=2, update_filters_every=3)
# person 1 unobserved over frames 3-5 (the robust profile's stale frames)
STALE = np.zeros((CFG["num_frames"], CFG["num_people"]), bool)
STALE[3:6, 1] = True


@pytest.fixture(scope="module")
def body():
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    return jm, torch_model_of(jm), seq_arrays(jm)


def _setup(body, knob):
    """The port's (model, data, cfg, params, aux) from its own init
    solve, with the default or the robust (gap_aware_temporal) knobs."""
    _, tm, kw = body
    robust = knob == "robust"
    cfg = TE.EngineConfig(**dict(CADENCE, gap_aware_temporal=robust))
    seq = dict(kw, lagged_tn=STALE if robust else None)
    params, _, _ = TE.init_params(tm, kw["pose2d"], kw["poses_smpl"],
                                  kw["betas_smpl"], kw["cam"]["K"], cfg)
    aux = TE.init_aux(cfg, 384, t(np.mean(kw["betas_smpl"], 0,
                                          keepdims=True)))
    return tm, TE.prepare_seq_data(TSeq(**seq), cfg), cfg, params, aux


def _eager(params, aux, tm, data, cfg, cycles=CYCLES):
    st = TE.rmsprop_init(params)
    losses, parts = [], []
    for c in range(cycles):
        params, st, aux, loss, p = TE.stage1_cycle_eager(
            params, st, aux, c, tm, data, TE.default_coefs(), cfg)
        losses.append(loss)
        parts.append(p)
    return params, st, aux, torch.stack(losses), torch.stack(parts)


def _graph(params, aux, tm, data, cfg, cycles=CYCLES, marks=False):
    g = CG.CycleGraph(params, TE.rmsprop_init(params), aux, tm, data,
                      TE.default_coefs(), cfg, num_cycles=cycles,
                      phase_marks=marks)
    return g, [g.replay(c) for c in range(cycles)]


def _assert_same(a, b, what):
    for i, (x, y) in enumerate(zip(CG.tree_leaves(a), CG.tree_leaves(b))):
        assert torch.equal(x, y), f"{what}[{i}]"


@pytest.mark.parametrize("knob", ["default", "robust"])
def test_static_body_matches_eager_loop(body, knob):
    """CycleGraph's static-state body over cycles 0-6 (every variant)
    equals the eager stage1_cycle_eager loop bit for bit: losses, parts,
    params, RMSprop state and step count, scene and filtered targets."""
    tm, data, cfg, params, aux = _setup(body, knob)
    ep, est, eaux, el, eparts = _eager(params, aux, tm, data, cfg)
    g, variants = _graph(params, aux, tm, data, cfg)
    assert set(variants) == {CG.Variant(False, False, False, False),
                             CG.Variant(True, False, True, False),
                             CG.Variant(True, True, True, True),
                             CG.Variant(True, False, True, True)}
    st = g.state
    assert torch.equal(st.losses, el) and torch.equal(st.parts, eparts)
    _assert_same(st.params, ep, "params")
    _assert_same((st.nu, st.trace), (est.nu, est.trace), "RMSprop")
    assert int(st.count) == est.count == CYCLES
    _assert_same((st.scene, st.verts_filt_diff, st.betas_ref),
                 (eaux.scene, eaux.verts_filt_diff, eaux.betas_ref), "aux")
    assert g.aux().have_scene and g.aux().have_filters
    if knob == "robust":
        assert float(el[-1]) > 0 and float(eparts[:, -1].max()) > 0


def test_eager_cycle_takes_the_static_state(body):
    """stage1_cycle_eager continues from a CycleGraph's static buffers
    (what stage1_cycle{,s}_fused return on the card; its step count a
    device tensor): cycles 0-2 through the graph, then 3-4 eagerly,
    bit for bit the eager loop's losses and params."""
    tm, data, cfg, params, aux = _setup(body, "default")
    ep, _, _, el, _ = _eager(params, aux, tm, data, cfg, cycles=5)
    g, _ = _graph(params, aux, tm, data, cfg, cycles=3)
    p, st, a = g.state.params, g.state.opt_state(), g.aux()
    losses = list(g.state.losses)
    for c in (3, 4):
        p, st, a, loss, _ = TE.stage1_cycle_eager(
            p, st, a, c, tm, data, TE.default_coefs(), cfg)
        losses.append(loss)
    assert int(st.count) == 5
    assert torch.equal(torch.stack(losses), el)
    _assert_same(p, ep, "params")


@pytest.fixture(scope="module")
def jax_cycles(body):
    """tests/test_torch_helpers.py's comparison: the JAX package's
    stage1_cycles_fused(n_cycles=3) from its init params with CFG's
    cadence (cycle 1 rebuilds the scene, cycle 2 also refreshes the
    filtered targets), and the port's inputs from the same params."""
    jm, tm, kw = body
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
                tp=tp, taux=TE.init_aux(tcfg, 384, t(br)), tm=tm,
                tdata=TE.prepare_seq_data(TSeq(**kw), tcfg), tcfg=tcfg)


def test_static_body_matches_jax_cycles(jax_cycles):
    """The static-state body over cycles 0-2 lands where the JAX
    package's stage1_cycles_fused(n_cycles=3) does, at the tolerances
    tests/test_torch_helpers.py holds the eager stage1_cycles_fused to:
    losses and parts to 1e-3 relative, params to 5e-3."""
    p = jax_cycles
    g, _ = _graph(p["tp"], p["taux"], p["tm"], p["tdata"], p["tcfg"],
                  cycles=3)
    jl, jparts, jq = p["jax"]
    np.testing.assert_allclose(n(g.state.losses), jl, rtol=1e-3)
    np.testing.assert_allclose(n(g.state.parts), jparts, rtol=1e-3,
                               atol=1e-6)
    for name, a, b in zip(TE.PARAM_NAMES, g.state.params, jq):
        np.testing.assert_allclose(n(a), b, atol=5e-3, rtol=0, err_msg=name)


def _init_inputs(body):
    """(model, init_global_poses' tensor arguments, its keywords)."""
    _, tm, kw = body
    cfg = TE.EngineConfig(**CADENCE)
    args = [t(kw[k]) for k in ("pose2d", "poses_smpl", "betas_smpl")]
    args += [t(kw["cam"]["K"]), torch.zeros((1, CFG["num_people"], 1, 1))]
    return tm, args, dict(dist_coef=TE._dist_coef(cfg, "cpu"),
                          pose_weights=TE._j17_weights(cfg, "cpu"))


def _init_reference(tm, pose2d, poses_smpl, betas, cam_K, xscale,
                    num_iter=100):
    """The init solve's loop as it was before its schedule became a
    table: the learning rate built on the host at every step."""
    from mhmocap_tpu_torch.models.smpl import smpl_forward
    from mhmocap_tpu_torch.ops.cameras import project_points
    T, N = pose2d.shape[:2]
    with torch.no_grad():
        out = smpl_forward(tm, betas.reshape(T * N, -1),
                           poses_smpl.reshape(T * N, -1))
        joints = torch.pow(1.1, xscale) * out["joints_alphapose"].reshape(
            T, N, -1, 3)
    vis = (pose2d[..., 2:] > 0.15).to(torch.float32)
    gt2d = pose2d[..., 0:2]
    poses_T = torch.tensor([0.0, 0.0, 1.0]).expand(T, N, 1, 3).contiguous()
    mu, nu, hist = torch.zeros_like(poses_T), torch.zeros_like(poses_T), []
    for i in range(num_iter):
        p = poses_T.detach().requires_grad_(True)
        proj = project_points(joints + p, cam_K)
        loss_2d = torch.mean(torch.square(vis * proj - vis * gt2d))
        loss = 1.0 * loss_2d + 0.05 * torch.sum(torch.square(p[1:] - p[:-1]))
        (g,) = torch.autograd.grad(loss, p)
        upd, mu, nu = TE.adam_update(g, mu, nu, i,
                                     TE._exp_decay(0.5, 0.95, i), 0.5, 0.5,
                                     1e-6)
        poses_T = poses_T + upd
        hist.append(loss_2d.detach())
    return poses_T, torch.stack(hist)


def test_init_static_body_matches(body):
    """init_global_poses_fused (on the CPU: the body into its static
    outputs) equals the eager init_global_poses and the loop as it was
    before the table bit for bit, and the JAX init_global_poses within
    tests/test_torch_engine.py's tolerance: history 1e-4 relative or
    1e-5 of the first loss, translations 5e-3."""
    jm, _, kw = body
    tm, args, kw_opt = _init_inputs(body)
    got = CG.init_global_poses_fused(tm, *args, **kw_opt)
    for ref in (TE.init_global_poses(tm, *args, **kw_opt),
                _init_reference(tm, *args)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    jT, jh = JE.init_global_poses(
        jm, *[jnp.asarray(n(a)) for a in args])
    np.testing.assert_allclose(n(got[1]), np.asarray(jh), rtol=1e-4,
                               atol=1e-5 * float(jh[0]))
    np.testing.assert_allclose(n(got[0]), np.asarray(jT), atol=5e-3, rtol=0)


@pytest.mark.parametrize("init,rate", [(0.01, 0.99), (0.5, 0.95)])
def test_schedule_tables_match(init, rate):
    """RMSprop's (0.01, 0.99) and the init solve's Adam (0.5, 0.95)
    learning-rate tables equal _exp_decay at counts 0..600 bit for bit,
    read by a Python count and by a device count alike; a Python count
    past any table built so far gets a longer one."""
    table = TE.exp_decay_table(init, rate, TE.schedule_len(601),
                               torch.device("cpu"))
    for c in range(601):
        ref = TE._exp_decay(init, rate, c)
        assert torch.equal(table[c], ref), c
        assert torch.equal(TE._decayed(init, rate, c, "cpu"), ref)
        assert torch.equal(TE._decayed(init, rate, torch.tensor(c), "cpu",
                                       steps=601), ref.reshape(1))
    assert torch.equal(TE._decayed(init, rate, 5000, "cpu"),
                       TE._exp_decay(init, rate, 5000))


@pytest.mark.parametrize("b", [0.5, 0.9])
def test_adam_bias_tables_match(b):
    """Adam's bias corrections at counts 0..600 from the table (a device
    count) equal the division by the Python float 1 - b**(count + 1)
    rounded to float32 (a Python count) bit for bit, and the table holds
    that float32 divisor on the CPU."""
    table = TE.adam_bias_table(b, TE.schedule_len(601), torch.device("cpu"))
    x = torch.from_numpy(np.random.RandomState(0).randn(64).astype(
        np.float32))
    for c in range(601):
        d = float(np.float32(1 - b ** (c + 1)))
        assert float(table[c]) == d, c
        ref = x / d
        assert torch.equal(TE._unbias(x, b, c, None), ref), c
        assert torch.equal(TE._unbias(x, b, torch.tensor(c), 601), ref), c


# what builds a tensor from host data or reads a tensor back to the host
GUARDED = {"tensor", "as_tensor", "item", "tolist", "cpu", "numpy",
           "__bool__", "__int__", "__float__"}


class HostGuard(TorchFunctionMode):
    """Records the guarded torch calls made while it is active."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        if name in GUARDED:
            self.calls.append(name)
        return func(*args, **(kwargs or {}))


def _plain_fillin_rounds(monkeypatch):
    """The rounds each call of the plain fill-in runs, recorded. It is
    the fill-in's CPU path and reads each round's count on the host
    (one int a round) to stop; on the card the kernel stops on the
    device and reads nothing."""
    rounds, plain = [], TI.fillin_plain

    def counted(*args, **kw):
        out = plain(*args, **kw)
        rounds.append(len(out[2]))
        return out

    monkeypatch.setattr(TI, "fillin_plain", counted)
    return rounds


def _fixed_round_fillin(x, mask, filter_size, max_iters=64):
    """A stand-in for the plain fill-in that runs two of its rounds and
    has no stop, so that it reads nothing back to the host."""
    xv, m = x.to(torch.float32, copy=True), mask.to(torch.float32, copy=True)
    for _ in range(2):
        med, ok = TI.masked_window_median(xv, m, filter_size)
        newly = (m < 0.5) & ok
        xv = torch.where(newly, med, xv)
        m = torch.where(newly, torch.ones_like(m), m)
    return xv, m, []


def _guarded(monkeypatch, fn):
    """The guarded calls `fn` makes; torch.from_numpy, which no mode
    sees, is wrapped for the call."""
    from_numpy = torch.from_numpy
    with HostGuard() as guard:
        monkeypatch.setattr(torch, "from_numpy", lambda a: (
            guard.calls.append("from_numpy"), from_numpy(a))[1])
        fn()
        monkeypatch.undo()
    return guard.calls


@pytest.mark.parametrize("marks", [False, True], ids=["unmarked", "marked"])
@pytest.mark.parametrize("variant", [
    CG.Variant(False, False, False, False), CG.Variant(True, False, True,
                                                       False),
    CG.Variant(True, True, True, True), CG.Variant(True, False, True, True),
    "init"], ids=["none", "scene", "scene_filters", "with_filters", "init"])
def test_bodies_are_capture_safe(body, monkeypatch, variant, marks):
    """On its second call a body (each cycle variant, with the robust
    knobs so that every branch runs, and the init solve; the cycle
    variants with phase marks off and on) builds no tensor from host
    data and reads nothing back (torch.tensor, as_tensor, from_numpy,
    item, tolist, cpu, numpy, bool, int, float), but for the plain
    fill-in's stop (one int a round, the CPU path only; on the card the
    fill-in kernel stops on the device), which the scene variants run.
    With the plain fill-in swapped for a stand-in that has no stop, a
    body reads nothing at all."""
    tm, data, cfg, params, aux = _setup(body, "robust")
    if variant == "init":
        tm, args, kw_opt = _init_inputs(body)

        def run():
            CG.init_global_poses_fused(tm, *args, **kw_opt)
    else:
        g = CG.CycleGraph(params, TE.rmsprop_init(params), aux, tm, data,
                          TE.default_coefs(), cfg, num_cycles=3,
                          phase_marks=marks)

        def run():
            CG.cycle_body(g.state, variant, tm, data, TE.default_coefs(),
                          cfg, True, g.marks)
    run()
    rounds = _plain_fillin_rounds(monkeypatch)
    assert _guarded(monkeypatch, run) == ["__int__"] * sum(rounds)
    assert bool(rounds) == (variant != "init" and variant.do_scene)
    monkeypatch.setattr(TI, "fillin_plain", _fixed_round_fillin)
    assert _guarded(monkeypatch, run) == []


def test_phase_marks_fill_a_row_a_cycle(body):
    """With marks on, cycles 0-6 (every variant) each fill their ring
    row: every slot stamped, non-decreasing; the scene and the filter
    phases read 0 where the variant skips them and the marks stamp
    the slots in table order; rows past the last cycle stay -1."""
    tm, data, cfg, params, aux = _setup(body, "default")
    g = CG.CycleGraph(params, TE.rmsprop_init(params), aux, tm, data,
                      TE.default_coefs(), cfg, num_cycles=CYCLES + 1,
                      phase_marks=True)
    variants = [g.replay(c) for c in range(CYCLES)]
    rows = g.phase_rows(0, CYCLES + 1)
    assert rows.shape == (CYCLES + 1, 5 + 2 * cfg.num_chunks)
    assert (rows[-1] == -1).all()
    rows = rows[:CYCLES]
    assert (rows > 0).all() and (rows.diff(dim=1) >= 0).all()
    assert (rows[1:, 0] >= rows[:-1, -1]).all()
    ms = PM.phase_ms(rows, cfg.num_chunks)
    names = PM.slot_names(cfg.num_chunks)
    for c, v in enumerate(variants):
        assert (ms["scene"][c] == 0) == (not v.do_scene), c
        assert (ms["filter"][c] == 0) == (not v.do_filt), c
        order = g.mark_order[v]
        assert order == tuple(n for n in names
                              if (n != "scene" or v.do_scene)
                              and (n != "filter" or v.do_filt)), v


def test_phase_marks_leave_the_fit_bit_identical(body):
    """Cycles 0-6 with marks on and off: the same losses, parts, params,
    RMSprop state, scene and filtered targets, bit for bit; without
    marks the state holds no ring."""
    tm, data, cfg, params, aux = _setup(body, "robust")
    off, _ = _graph(params, aux, tm, data, cfg)
    on, _ = _graph(params, aux, tm, data, cfg, marks=True)
    assert off.state.ring is None and off.marks is None
    assert torch.equal(on.state.losses, off.state.losses)
    assert torch.equal(on.state.parts, off.state.parts)
    _assert_same((on.state.params, on.state.nu, on.state.trace,
                  on.state.count, on.state.scene, on.state.verts_filt_diff),
                 (off.state.params, off.state.nu, off.state.trace,
                  off.state.count, off.state.scene,
                  off.state.verts_filt_diff), "state")


def test_marks_off_call_no_mark(body, monkeypatch):
    """With marks off no cycle body calls a mark (a mark raises here);
    with marks on the same cycles do."""
    tm, data, cfg, params, aux = _setup(body, "default")

    def refuse(*a, **k):
        raise AssertionError("a mark was called")
    monkeypatch.setattr(PM.PhaseMarks, "__call__", refuse)
    g, _ = _graph(params, aux, tm, data, cfg)
    assert g.mark_order == {}
    with pytest.raises(AssertionError, match="a mark was called"):
        _graph(params, aux, tm, data, cfg, cycles=1, marks=True)


def test_capture_seconds_is_read_from_the_spans(body, monkeypatch):
    """`capture_seconds` holds, for each variant `prepare` captures, the
    seconds of the warm-up and capture spans its capture recorded
    (spans opened inside them, such as a library's first build, do not
    count). The capture is a stand-in here: the CPU captures nothing."""
    from mhmocap_tpu_torch.spans import span
    tm, data, cfg, params, aux = _setup(body, "default")
    g = CG.CycleGraph(params, TE.rmsprop_init(params), aux, tm, data,
                      TE.default_coefs(), cfg, num_cycles=CYCLES)
    assert g.capture_seconds == {}

    class Graph:
        def pool(self):
            return None

    def capture(body, device, pool=None, name="cycle_graph"):
        with span(f"{name}.warmup"):
            with span("build lib"):
                pass
        with span(f"{name}.capture"):
            pass
        return Graph()
    monkeypatch.setattr(CG, "capture_graph", capture)
    monkeypatch.setattr(g, "device", torch.device("cuda"))
    g.prepare(0, CYCLES)
    want = g.variants(0, CYCLES)
    assert list(g.capture_seconds) == want and len(want) == 4
    recs = g.spans.records
    warm = [r.seconds for r in recs if r.name == "cycle_graph.warmup"]
    cap = [r.seconds for r in recs if r.name == "cycle_graph.capture"]
    assert list(g.capture_seconds.values()) == list(zip(warm, cap))
    assert {r.parent for r in recs if r.name in (
        "cycle_graph.warmup", "cycle_graph.capture")} == {
            "cycle_graph.prepare"}


def test_checkpoint_resume_through_static_buffers(body, tmp_path):
    """Cycles 0-1 through a CycleGraph, a checkpoint copied out of its
    static buffers, then a new CycleGraph loaded from it runs cycles
    2-6: bit for bit the unbroken run's losses, params and RMSprop
    state (the aux is not saved and is still its initial value at the
    resume point, before warmup_cycles)."""
    tm, data, cfg, params, aux = _setup(body, "default")
    whole, _ = _graph(params, aux, tm, data, cfg)
    first, _ = _graph(params, aux, tm, data, cfg, cycles=2)
    TPr.save_checkpoint(str(tmp_path), 1, first.state.params,
                        first.state.opt_state())
    last, rp, rst = TPr.load_checkpoint(str(tmp_path), "cpu")
    assert last == 1 and rst.count == 2
    resumed = CG.CycleGraph(rp, rst, aux, tm, data, TE.default_coefs(),
                            cfg, num_cycles=CYCLES)
    for c in range(2, CYCLES):
        resumed.replay(c)
    a, b = resumed.state, whole.state
    assert torch.equal(a.losses[2:], b.losses[2:])
    assert torch.equal(a.parts[2:], b.parts[2:])
    _assert_same((a.params, a.nu, a.trace, a.count),
                 (b.params, b.nu, b.trace, b.count), "state")

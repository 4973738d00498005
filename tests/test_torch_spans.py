"""The port's host spans (`mhmocap_tpu_torch/spans.py`) and the readers of
its device phase marks (`ops/phase_marks.py`), on the CPU: the
recorder's nesting, parents and order and its silence when off, spans
as profiler ranges, `load_sequence`'s timings and the Predictor's
set-up read from spans, the Predictor's `profile_dir` output, and the
phase readers on synthetic rings and traces.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from mhmocap_tpu_torch import workload
from mhmocap_tpu_torch.data.ingestion import load_sequence
from mhmocap_tpu_torch.data.synthetic import generate_sequence
from mhmocap_tpu_torch.engine.predictor import Predictor
from mhmocap_tpu_torch.models.smpl import joints_function
from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch.ops import phase_marks as PM
from mhmocap_tpu_torch.spans import Spans, span


def test_recorder_keeps_nesting_parents_and_order():
    """Records end child first, name their enclosing span, nest in time;
    roots are the top-level spans; a recorder entered again while
    active keeps each span once; two recorders both keep a span opened
    inside both."""
    outer, inner = Spans(), Spans()
    with outer:
        with span("a"):
            with span("b"):
                with inner, span("c"):
                    pass
            with outer, span("d"):
                pass
        with span("e"):
            pass
    assert [(r.name, r.parent) for r in outer.records] == [
        ("c", "b"), ("b", "a"), ("d", "a"), ("a", None), ("e", None)]
    assert [(r.name, r.parent) for r in inner.records] == [("c", "b")]
    by = {r.name: r for r in outer.records}
    for child, parent in (("b", "a"), ("c", "b"), ("d", "a")):
        assert by[parent].start_ns <= by[child].start_ns
        assert by[child].end_ns <= by[parent].end_ns
    assert by["b"].end_ns <= by["d"].start_ns
    assert [r.name for r in outer.roots()] == ["a", "e"]
    assert outer.seconds("a") == by["a"].seconds > 0


def test_recorder_is_silent_when_off():
    """Spans outside every recorder are kept nowhere, and a recorder
    keeps nothing after it is left; a span on another thread does not
    see the caller's recorder."""
    rec = Spans()
    with span("before"):
        pass
    with rec:
        with span("inside"):
            pass
        def on_thread():
            with span("thread"):
                pass
        t = threading.Thread(target=on_thread)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    with span("after"):
        pass
    assert [r.name for r in rec.records] == ["inside"]


def test_span_decorates_a_function():
    """`@span(name)` records one span a call, with the function's own
    name and docstring kept."""
    @span("deco")
    def f(x):
        """doc"""
        with span("child"):
            return x + 1

    with Spans() as rec:
        assert f(1) == 2 and f(2) == 3
    assert [r.name for r in rec.records] == ["child", "deco"] * 2
    assert f.__name__ == "f" and f.__doc__ == "doc"


def test_spans_show_in_a_profiler_trace():
    """Each span is a record_function range of a CPU torch.profiler
    trace, nested as the spans are, with or without a recorder."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mhmocap.outer"):
            with Spans(), span("mhmocap.inner"):
                torch.ones(4).sum()
    ev = {e.name: e for e in prof.events()
          if e.name.startswith("mhmocap.")}
    assert set(ev) == {"mhmocap.outer", "mhmocap.inner"}
    o, i = ev["mhmocap.outer"].time_range, ev["mhmocap.inner"].time_range
    assert o.start <= i.start and i.end <= o.end


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "TS1")
    model = make_synthetic_smpl(num_vertices=384, seed=3)
    generate_sequence(root, num_frames=4, num_people=2, image_size=(64, 64),
                      model=model, seed=3)
    return root, model


def test_load_sequence_timings_are_its_spans(tiny_tree):
    """`timings` keeps its keys; each part is the seconds of its span,
    the three spans lie inside "load_sequence" in order, and "total" is
    their sum."""
    root, model = tiny_tree
    timings = {}
    with Spans() as rec:
        load_sequence(root, joints_function(model, "joints_alphapose"),
                      resize_factor=1.0, post_process_depth=False,
                      renormalize_depth=False, device="cpu",
                      verbose=False, timings=timings)
    assert list(timings) == ["decode", "postprocess", "assignment", "total"]
    parts = ["ingest.decode", "ingest.postprocess", "ingest.assignment"]
    assert [r.name for r in rec.records] == parts + ["load_sequence"]
    for key, name in zip(timings, parts):
        assert timings[key] == rec.seconds(name) > 0
    assert timings["total"] == pytest.approx(sum(
        timings[k] for k in ("decode", "postprocess", "assignment")))
    assert rec.seconds("load_sequence") >= timings["total"]
    assert all(r.parent == "load_sequence" for r in rec.records[:3])
    assert [r.name for r in rec.roots()] == ["load_sequence"]


SETUP_SPANS = ["predictor.init", "init_params", "prepare_seq_data",
               "init_aux", "cycle_graph.init"]


def test_predictor_profile_dir_writes_the_phases(tmp_path):
    """With `profile_dir` a CPU fit writes the cycle-2 trace and
    `phases_cycle2.json`: the slot table, a filled, non-decreasing ring
    row, each phase's ms (the plain cycle's scene and filter read 0),
    the slots its marks stamped and the set-up spans; the Predictor's
    recorder holds the set-up spans and `init_seconds` is the init
    solve's span."""
    model = make_synthetic_smpl(num_vertices=384, seed=1)
    seq, _ = workload.make_ts1_like_seq(T=8, N=2, side=64, model=model)
    args = workload.bench_args(4, None, 32)
    args.profile_dir = str(tmp_path / "prof")
    pred = Predictor(seq, model, str(tmp_path / "out"), args, device="cpu")
    pred.run(verbose=False)
    assert os.path.exists(tmp_path / "prof" / "trace_cycle2.json")
    with open(tmp_path / "prof" / "phases_cycle2.json") as f:
        out = json.load(f)
    K = pred.cfg.num_chunks
    assert out["slots"] == list(PM.slot_names(K)) and out["cycle"] == 2
    ring = np.asarray(out["ring_ns"])
    assert (ring > 0).all() and (np.diff(ring) >= 0).all()
    assert list(out["phase_ms"]) == list(PM.slot_names(K))[1:]
    assert out["phase_ms"]["scene"] == out["phase_ms"]["filter"] == 0
    assert out["marked"] == ["start"] + [
        f"{k}{i}" for i in range(K) for k in ("forward", "backward")] + [
        "scale_reg", "update"]
    names = [r[0] for r in out["setup_spans"]]
    roots = [r.name for r in pred.spans.roots()]
    assert roots[:len(SETUP_SPANS)] == SETUP_SPANS
    assert set(SETUP_SPANS) <= set(names)
    assert "predictor.model_upload" in names
    assert pred.init_seconds == pred.spans.seconds("init_params") > 0


def _ring(rows):
    return torch.as_tensor(np.asarray(rows, np.int64))


def test_phase_ms_and_groups_read_a_ring():
    """Each phase is its slot less the one before it; the groups sum a
    chunk's forwards, its backwards with the scale regularizer, and the
    update; rows of one table only."""
    names = PM.slot_names(2)
    assert names == ("start", "scene", "filter", "forward0", "backward0",
                     "forward1", "backward1", "scale_reg", "update")
    assert len(PM.slot_names(7)) == 19
    ns = np.cumsum([[0, 1, 2, 3, 4, 5, 6, 7, 8],
                    [10, 0, 0, 1, 1, 1, 1, 1, 1]], axis=1) * 1_000_000
    ms = PM.phase_ms(_ring(ns), 2)
    assert list(ms) == list(names[1:])
    np.testing.assert_allclose(ms["scene"], [1, 0])
    np.testing.assert_allclose(ms["update"], [8, 1])
    g = PM.group_ms(_ring(ns), 2)
    assert list(g) == list(PM.GROUPS)
    np.testing.assert_allclose(g["forward"], [3 + 5, 1 + 1])
    np.testing.assert_allclose(g["backward"], [4 + 6 + 7, 1 + 1 + 1])
    np.testing.assert_allclose(g["update"], [8, 1])
    np.testing.assert_allclose(sum(g.values()), (ns[:, -1] - ns[:, 0]) / 1e6)


def _ops(order, per_phase, cycles, start=0.0):
    """A synthetic one-stream trace: `cycles` cycles, each a mark kernel
    for every slot of `order`, with per_phase[phase] ops of 2 us, 1 us
    apart, before the mark that ends it."""
    ops, t = [], start
    for _ in range(cycles):
        for name in order:
            for _ in range(per_phase.get(name, 0)):
                ops.append((t, t + 2, "void at::native::kernel"))
                t += 3
            ops.append((t, t + 1, f"mhmocap_phase::{PM.KERNEL}(long long*)"))
            t += 2
    return ops


@pytest.mark.parametrize("order", [
    ("start", "forward0", "backward0", "scale_reg", "update"),
    ("start", "scene", "filter", "forward0", "backward0", "scale_reg",
     "update")], ids=["plain", "refresh"])
def test_split_cuts_a_trace_at_the_marks(order):
    """Launches and busy time of each phase summed over the cycles; the
    idle time is each phase's gaps; nothing falls between cycles."""
    per = {name: k + 1 for k, name in enumerate(order[1:])}
    cuts = PM.split(_ops(order, per, cycles=3), [order] * 3)
    assert len(cuts) == 3 and cuts[0] == cuts[1]
    out = PM.total(cuts)
    assert set(out) == set(order[1:]) | {"between"}
    for name, k in per.items():
        assert out[name].launches == 3 * k
        assert out[name].busy_s == pytest.approx(3 * k * 2e-6)
        assert out[name].idle_s == pytest.approx(3 * (k + 1) * 1e-6)
    assert out["between"].launches == 0
    assert out["between"].idle_s == pytest.approx(2 * 1e-6)
    total = sum(p.launches for p in out.values())
    assert total == 3 * sum(per.values())


def test_split_counts_ops_outside_the_marks():
    """Operations before the first mark count under "before", those after
    a cycle's last mark under "between"."""
    order = ("start", "forward0", "update")
    first = _ops(order, {"forward0": 2}, 1, start=5)
    end = first[-1][1]
    ops = ([(0, 1, "memset")] + first + [(end + 2, end + 3, "copy")]
           + _ops(order, {"forward0": 2}, 1, start=end + 10))
    first, second = PM.split(ops, [order] * 2)
    assert "before" not in second and "between" not in second
    out = PM.total([first, second])
    assert first["before"].launches == first["between"].launches == 1
    assert out["forward0"].launches == 4 and out["update"].launches == 0
    assert sum(p.launches for p in out.values()) == len(ops) - 6


def test_split_gives_each_cycle_its_own_order():
    """A plain, a refresh and a plain cycle replayed back to back: each
    cycle's operations go to the phases of its own order."""
    plain = ("start", "forward0", "update")
    refresh = ("start", "filter", "forward0", "update")
    ops = (_ops(plain, {"forward0": 2}, 1)
           + _ops(refresh, {"filter": 5, "forward0": 2}, 1, start=100)
           + _ops(plain, {"forward0": 2}, 1, start=200))
    cuts = PM.split(ops, [plain, refresh, plain])
    assert "filter" not in cuts[0] and "filter" not in cuts[2]
    assert cuts[1]["filter"].launches == 5
    assert [c["forward0"].launches for c in cuts] == [2, 2, 2]


@pytest.mark.parametrize("lost", [-1, 0, 3])
def test_split_refuses_a_trace_that_lost_marks(lost):
    """A trace that holds another number of marks than the cycles stamp
    (here one dropped: the last, the first or one inside) cannot be cut
    into phases: split raises rather than put operations in the wrong
    phase."""
    order = ("start", "scene", "forward0", "backward0", "update")
    ops = _ops(order, {"scene": 1, "forward0": 2, "backward0": 3}, 2)
    at = [i for i, o in enumerate(ops) if PM.KERNEL in o[2]][lost]
    with pytest.raises(ValueError, match="9 marks .* stamp 10"):
        PM.split(ops[:at] + ops[at + 1:], [order] * 2)
    with pytest.raises(ValueError, match="10 marks .* stamp 15"):
        PM.split(ops, [order] * 3)

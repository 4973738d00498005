"""CPU tests of the port's benchmark (`portbench`).

    python -m pytest portbench/tests -q -p no:cacheprovider

The runs here use a tiny cell on the CPU, where the port runs its
eager bodies and the raster kernels' plain version; the test marked
`cuda` runs on a card only and skips here.
"""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check as CK
from portbench import harness as H
from portbench import work as W
from portbench.generate import generate
from portbench.reference.raster import Work, face_planes, raster_window
from portbench.trace import Span

PKG = Path(H.__file__).resolve().parent
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_cell(**limits) -> H.Cell:
    """ts1-fit's files at a size the CPU runs in about a minute."""
    cell = H.load_cell("ts1-fit", ROOT)
    cfg = dict(cell.config, frames=6, people=2, image_side=48,
               raster_window=48, body=dict(num_vertices=256, seed=0))
    return cell._replace(name="tiny", config=cfg,
                         limits=dict(cell.limits, **limits))


# --- the generator --------------------------------------------------------

def test_generator_is_deterministic_per_seed_and_differs_across_seeds():
    cell = tiny_cell()
    big = 2 ** 31 + 12345
    a, body_a = generate(cell.config, cell.traffic, big, "cpu")
    b, body_b = generate(cell.config, cell.traffic, big, "cpu")
    c, _ = generate(cell.config, cell.traffic, big + 1, "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for k in body_a:
        np.testing.assert_array_equal(body_a[k], body_b[k])
    assert not np.array_equal(a["depths"], c["depths"])
    assert not np.array_equal(a["poses_smpl"], c["poses_smpl"])
    # what the seed does not draw is the same: sizes, masks, camera
    for k in ("seg_mask", "backmasks", "K"):
        np.testing.assert_array_equal(a[k], c[k])


# --- the work counts ------------------------------------------------------

def test_raster_work_matches_a_hand_count():
    """One triangle in a 16 px window, counted pixel by pixel: live
    pairs (d|d|/blur < 104), covered pixels, live rows, winners."""
    win, blur = 16, 0.5
    K = torch.tensor([[10.0, 0, 8], [0, 10.0, 8], [0, 0, 1]])
    # a triangle at z = 2 whose pixels lie in the window's middle
    tri = torch.tensor([[[-0.4, -0.4, 2.0], [0.4, -0.4, 2.0],
                         [0.0, 0.4, 2.0]]])
    faces = torch.tensor([[0, 1, 2]])
    zbuf, sil, origin, wk = raster_window(tri, faces, K, win, (16, 16), 1.0,
                                          blur, count=True)
    assert origin.tolist() == [[0, 0]]
    uv = tri[0, :, :2] / tri[0, :, 2:] * 10.0 + 8.0
    planes, bbox, _, _ = face_planes(uv[None, None], tri[0, :, 2][None, None],
                                     1.0)
    p, bb = planes[0, 0], bbox[0, 0]
    live = covered = 0
    rows = set()
    for y in range(win):
        for x in range(win):
            px, py = x + 0.5, y + 0.5
            d = max(p[0] * px + p[1] * py + p[2], p[3] * px + p[4] * py + p[5],
                    p[6] * px + p[7] * py + p[8],
                    max(bb[0] - px, px - bb[1], bb[2] - py, py - bb[3]))
            if d * abs(d) / blur < 104:
                live += 1
                rows.add(y)
            covered += int(d <= 0)
    assert wk == Work(live, covered, len(rows), covered)
    assert int(torch.isfinite(zbuf).sum()) == covered
    # the itemised operations and bytes of that call
    assert W.raster_ops("fwd", wk) == 24 * live + 7 * covered + 7 * len(rows)
    assert W.raster_ops("bwd", wk) == 33 * live + 3 * covered + 30 * len(rows)
    assert W.raster_bytes("fwd", 1, 1, win) == 64 + 3 * 256 * 4
    assert W.raster_bytes("bwd", 1, 1, win) == 64 + 3 * 256 * 4 + 48
    assert W.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert W.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_skin_flops_hand_count():
    assert W.skin_flops(1) == 60 + 144 + 1242 + 576 + 18 + 102


# --- data-driven layout ---------------------------------------------------

def _copy_tree(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_cell_and_a_metric_added_as_files_only_are_found(tmp_path):
    root = _copy_tree(tmp_path)
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (pb / "configs" / "dummy.json").write_text(
        (pb / "configs" / "mupots-ts1.json").read_text())
    traffic = json.loads((pb / "workloads" / "near-fit.json").read_text())
    (pb / "workloads" / "far-fit.json").write_text(json.dumps(
        dict(traffic, name="far-fit", depth_m=[6.8, 8.4, 10.0])))
    (pb / "limits" / "dummy-fit.json").write_text(
        (pb / "limits" / "ts1-fit.json").read_text())
    (pb / "metrics" / "dummy_share.py").write_text(
        "def read(facts):\n    return 42.0\n")
    bench["configs"].append(dict(bench["configs"][0], name="dummy",
                                 file="portbench/configs/dummy.json"))
    bench["workloads"].append({"name": "dummy-fit", "config": "dummy",
                               "traffic": "far-fit", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "dummy.share", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "fit_frame_cycles_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; from pathlib import Path\n"
        "from portbench import harness as H\n"
        "c = H.load_cell('dummy-fit', Path('.'))\n"
        "print(c.traffic['depth_m'], c.config['frames'],\n"
        "      [m['name'] for m in c.per_layer],\n"
        "      H.metric_reader('dummy.share').read(None))\n"
        "t = H.load_cell('ts1-fit', Path('.'))\n"
        "print('dummy.share' in [m['name'] for m in t.per_layer])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.strip().splitlines()
    assert first.startswith("[6.8, 8.4, 10.0] 201")
    assert "'dummy.share'" in first and first.endswith("42.0")
    # every cell reports every metric
    assert second == "True"


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone: the run exits
    non-zero and its standard output holds no result line."""
    root = _copy_tree(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "ts1-fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_benchmark_json_keeps_the_contract_shapes():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("end_to_end", "per_layer"):
        for m in bench[k]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (PKG / "workloads" / f"{w['traffic']}.json").exists()
        assert (PKG / "limits" / f"{w['name']}.json").exists()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
        for k in c["reduced"]:
            assert NAME.match(k)
    for m in bench["per_layer"]:
        H.metric_reader(m["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


# --- imports --------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_and_the_reference_imports_no_port():
    for f in PKG.rglob("*.py"):
        tops = set(_imports(f))
        assert not tops & {"jax", "jaxlib", "flax", "mhmocap_tpu"}, f
        if f.parent.name == "reference":
            assert "mhmocap_tpu_torch" not in tops, f
    # only program.py reaches the port
    users = {f.name for f in PKG.rglob("*.py")
             if "mhmocap_tpu_torch" in set(_imports(f))
             and f.parent.name != "tests"}
    assert users == {"program.py"}


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mhmocap_tpu_torch_x", sys)
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mhmocap_tpu.ops", sys)
    assert H.forbidden_modules() == ["mhmocap_tpu"]


# --- a whole run on the CPU, sound and with faults ------------------------

def _plant(monkeypatch, fault: str):
    from mhmocap_tpu_torch.engine import optimizer as E
    from portbench import program as P
    if fault == "frozen":
        # a step that returns its state unchanged
        monkeypatch.setattr(P.Fit, "replay", lambda self, cycle: None)
    elif fault == "halfbatch":
        # half of the batch left out, the mean taken over the rest
        orig = E.cycle_loss_and_grads

        def half(params, model, data, aux, coefs, cfg):
            keep = (torch.arange(len(data.frame_valid)) % 2 == 0).float()
            loss, parts, grads = orig(params, model, data._replace(
                frame_valid=data.frame_valid * keep), aux, coefs, cfg)
            return 2 * loss, 2 * parts, E.StageParams(*[2 * g for g in grads])
        monkeypatch.setattr(E, "cycle_loss_and_grads", half)
    elif fault == "altered":
        # an answer altered where it is produced
        orig = P.Fit.replay

        def altered(self, cycle):
            orig(self, cycle)
            with torch.no_grad():
                self.graph.state.params.poses_T[1] += 0.01
        monkeypatch.setattr(P.Fit, "replay", altered)


@pytest.mark.parametrize("fault", ["sound", "frozen", "halfbatch", "altered"])
def test_a_run_is_correct_and_each_fault_is_caught(monkeypatch, fault):
    torch.set_num_threads(4)
    if fault != "sound":
        _plant(monkeypatch, fault)
    out = H.run_cell(tiny_cell(), 2 ** 31 + 7, 0.2, False, "cpu",
                     time.time(), log=lambda *a: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert set(out["metrics"]) == {"fit_frame_cycles_per_s",
                                   "peak_device_gib", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    json.dumps(out)


def test_traced_line_carries_breakdown_and_device_times():
    span = Span(0.2, 0.15, 3, {"k1": (2, 0.1), "k2": (1, 0.05)},
                [(1e-3, "sync after k1")])
    b = H.breakdown({"plain": span, "refresh": span})
    assert b["device_ops"][0] == ["k1", 0.2]
    assert len(b["idle_gaps"]) == 2 and b["idle_gaps"][0][1] == 1e-3


def test_judge_fails_on_a_missing_or_nan_number():
    ok, rows = CK.judge({"a": 0.1, "b": float("nan")}, {"a": 1.0, "b": 1.0})
    assert not ok
    ok, _ = CK.judge({"a": 0.1}, {"a": 1.0, "b": 1.0})
    assert not ok
    ok, _ = CK.judge({"a": 0.1, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert ok


def _judge_controls(cell: H.Cell, out, names):
    """The sound run passes the cell's limits and each control fails
    them."""
    limits = {k: v for k, v in cell.limits.items() if k != "steps"}
    assert out["correct"] is True, out["checks"]
    ok, _ = CK.judge({k: row["value"] for k, row in out["checks"].items()},
                     limits)
    assert ok
    for name in names:
        assert set(out["controls"][name]) >= set(limits), name
        ok, rows = CK.judge(out["controls"][name], limits)
        assert not ok, (name, rows)


def test_controls_are_not_correct_on_the_cpu():
    """The controls of a tiny cell on the CPU, judged by the limits the
    harness judges a run by; TF32 is a card's precision and is left to
    the card's test."""
    torch.set_num_threads(4)
    cell = tiny_cell()
    out = H.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu", time.time(),
                     controls=True, log=lambda *a: None)
    _judge_controls(cell, out, ("halfbatch", "altered", "frozen"))


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_controls_are_not_correct_on_the_card(workload):
    """The controls, at the cell's own size and window on the card: the
    reference in TF32 in the program's place, half the frames, an
    altered answer, a frozen state. Each fails the cell's limits, which
    the sound run beside them passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = H.load_cell(workload, ROOT)
    out = H.run_cell(cell, 31337, BENCH["run_seconds"], False, "cuda:0",
                     time.time(), controls=True, log=lambda *a: None)
    _judge_controls(cell, out, H.CONTROLS)

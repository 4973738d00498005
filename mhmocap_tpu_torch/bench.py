"""Benchmark: the production stage-1 cadence on one card.

Port of the JAX package's root `bench.py`. Prints ONE JSON line with
bench.py's keys and units:
    {"metric": "production_frame_cycles_per_sec", "value": N,
     "unit": "frame-cycles/s", "vs_baseline": R,
     "baseline_estimated": true, "secondary": {...}}
then a `#` line: the card's name and power limit, the set-up seconds,
the production and bare cycle times, the dispersion across windows
and the run's total.

The workload is bench.py's: the synthetic TS1-scale sequence
(`workload.make_ts1_like_seq`: 201 frames, 3 people, 256x256, the full
synthetic body) through `Predictor.run` with raster_window 160 for 76
cycles: the scene rebuilt every cycle from cycle 30, the One-Euro
targets refreshed every 25, per-person raster windows, per-cycle loss
parts logged. The fit is timed over the three disjoint 15-cycle windows
[30, 45), [45, 60), [60, 75); the headline `value` is T / (the median
window's seconds a cycle), T the sequence's frames, and the spread
across windows is `secondary.window_dispersion_pct`. The secondary rate
is the bare cycle (`bench_bare_cycle`): one RMSprop step of the
full-batch gradient with a scene and no refresh, replayed alone.

On the card every cycle is one CUDA graph replay: `Predictor.fit`
captures the graph of every variant the fit runs before its loop
(`CycleGraph.prepare`), so the windows hold replays only. The set-up,
reported apart, is the init solve plus every variant's warm-up and
capture, the bare cycle's included.

vs_baseline divides by 60 frame-cycles/s, bench.py's estimate of the
reference implementation on its TITAN V (`BASELINE.md`, "Appendix: the
60 f-c/s estimate"), hence `baseline_estimated: true`.

Usage:
    python -m mhmocap_tpu_torch.bench [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from .config import gpu_name_and_power, require_device
from .engine import optimizer as E
from .engine.cycle_graph import CycleGraph
from .engine.predictor import Predictor
from .workload import N, SIDE, T, WINDOW, bench_args, make_ts1_like_seq

REFERENCE_FRAME_CYCLES_PER_SEC = 60.0   # estimate; see BASELINE.md
# three disjoint 15-cycle windows past the warmup (cycle 30), where the
# scene/contact terms and the filter-refresh cadence are engaged
BENCH_CYCLES = (30, 45, 60, 75)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bare_cycle_graph(pred: Predictor, n_meas: int = 3) -> CycleGraph:
    """The bare cycle's state, built as bench.py builds it: params from
    a 5-step init solve, the scene rebuilt once from them, no filtered
    targets, betas_ref from frame 0, over a CycleGraph whose cycle 0
    (no refresh below `warmup_cycles`) is the bare cycle. Its log
    covers n_meas + 1 cycles."""
    seq, cfg, model, dev = pred.seq, pred.cfg, pred.model, pred.device
    params, _, _ = E.init_params(
        model, seq.pose2d, seq.poses_smpl, seq.betas_smpl, seq.cam["K"],
        cfg, num_iter=5)
    data = E.prepare_seq_data(seq, cfg, dev)
    aux = E.init_aux(cfg, model.num_vertices, torch.as_tensor(
        seq.betas_smpl[:1].mean(0, keepdims=True), device=dev))
    aux = aux._replace(scene=E.update_scene(params, data, cfg),
                       have_scene=True)
    return CycleGraph(params, E.rmsprop_init(params), aux, model, data,
                      pred.coefs, cfg, num_cycles=n_meas + 1)


def bench_bare_cycle(pred: Predictor, n_meas: int = 3):
    """(seconds a bare cycle, set-up seconds): the bare cycle's graph
    prepared (on the card its warm-up and capture, the span
    "cycle_graph.prepare"; nothing on the CPU), then n_meas replays
    timed by the host clock between synchronizations."""
    graph = bare_cycle_graph(pred, n_meas)
    dev = pred.device
    graph.prepare(0, 1)
    _sync(dev)
    setup_s = graph.spans.seconds("cycle_graph.prepare")
    t0 = time.perf_counter()
    for _ in range(n_meas):
        graph.replay(0)
    _sync(dev)
    return (time.perf_counter() - t0) / n_meas, setup_s


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="The production stage-1 cadence (bench.py's line).")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the benchmark; prints bench.py's JSON line and the `#` line
    and returns the JSON object."""
    device = require_device(parse_args(argv).device, "--device cpu")
    seq, model = make_ts1_like_seq(T, N, SIDE)
    args = bench_args(BENCH_CYCLES[-1] + 1, BENCH_CYCLES, WINDOW)
    # the headline is the one-card cadence: never shard
    args.spmd = False
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, args, device=device)
        bare_cycle, bare_setup = bench_bare_cycle(pred)

        t0 = time.time()
        pred.run(verbose=False)
        total_s = time.time() - t0
    setup_s = (pred.init_seconds + bare_setup
               + sum(w + c for w, c in pred.capture_seconds.values()))

    win_cycle = (np.asarray(pred.bench_window_seconds)
                 / np.diff(np.asarray(BENCH_CYCLES)))
    win_fcs = T / win_cycle
    per_cycle = float(np.median(win_cycle))
    prod_fcs = T / per_cycle
    dispersion_pct = float((win_fcs.max() - win_fcs.min())
                           / np.median(win_fcs) * 100.0)
    bare_fcs = T / bare_cycle

    result = {
        "metric": "production_frame_cycles_per_sec",
        "value": round(prod_fcs, 2),
        "unit": "frame-cycles/s",
        "vs_baseline": round(prod_fcs / REFERENCE_FRAME_CYCLES_PER_SEC, 3),
        "baseline_estimated": True,
        "secondary": {
            "bare_stage1_frame_cycles_per_sec": round(bare_fcs, 2),
            "window_frame_cycles_per_sec": [round(float(v), 2)
                                            for v in win_fcs],
            "window_dispersion_pct": round(dispersion_pct, 2),
            "workload": f"T={T} N={N} side={SIDE} window={WINDOW} "
                        f"cycles{list(BENCH_CYCLES)}",
        },
    }
    print(json.dumps(result))
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        power = gpu_name_and_power().split(", ")[-1]
    else:
        name, power = "cpu", "n/a"
    print(f"# device={name} power={power} "
          f"setup={setup_s:.1f}s prod_cycle={per_cycle * 1e3:.1f}ms "
          f"bare_cycle={bare_cycle * 1e3:.1f}ms "
          f"dispersion={dispersion_pct:.1f}% total_run={total_s:.1f}s",
          flush=True)
    return result


if __name__ == "__main__":
    main()

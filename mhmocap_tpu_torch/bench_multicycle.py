"""A/B of the stage-1 cycle's dispatch: eager, one CUDA graph replay a
cycle, K replays a host interaction.

    python -m mhmocap_tpu_torch.bench_multicycle [--Ks 5,15] [--meas 30]
        [--reps 2] [--check] [--device cuda] [--out FILE]

Counterpart of the JAX package's `script/bench_multicycle.py`, on the
bench workload (`workload.make_ts1_like_seq`: T=201, N=3, 256x256,
windows 160/128/112, the full body, V=6890, F=12672) in steady state:
after the init solve it runs the cycles up to the first filter refresh
past `warmup_cycles` and the cycle after it through the graphs (cycles
0-51: every variant the measured cycles run is captured there), then
times `--meas` cycles of each mode, `--reps` times in turn:

  * loop: `optimizer.stage1_cycle_eager`, one eager cycle a call;
  * graph: `optimizer.stage1_cycle_fused`, one graph replay a call;
  * graphK: `optimizer.stage1_cycles_fused(n_cycles=K)`, K replays a
    call (the JAX script's scanK).

`--check` first runs one refresh period (`update_filters_every` cycles,
a filter refresh included) in each mode from the same state and
requires their losses to be equal bit for bit. Seconds a cycle come from
the host clock between synchronizations. The default device is the GPU;
without one the run raises (`--device cpu` runs every mode eagerly).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .config import require_device
from .engine import optimizer as E
from .engine.cycle_graph import tree_map
from .engine.predictor import Predictor
from .workload import WINDOW, bench_args, make_ts1_like_seq


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(seq, model, Ks=(5, 15), meas=30, reps=2, check=False,
        device="cuda", report=print):
    """Warm, optionally check, then time each mode. Returns {mode: median
    seconds a cycle}."""
    dev = require_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, WINDOW),
                         device=dev)
    cfg, m, coefs = pred.cfg, pred.model, pred.coefs
    params, _, opt_scale = E.init_params(m, seq.pose2d, seq.poses_smpl,
                                         seq.betas_smpl, seq.cam["K"], cfg)
    data = E.prepare_seq_data(seq, cfg, dev)
    aux = E.init_aux(cfg, m.num_vertices, torch.as_tensor(
        np.mean(seq.betas_smpl, axis=0, keepdims=True), device=dev))

    def one_a_call(cycle):
        """n cycles from c0, one `cycle` call each -> (state, losses)."""
        def fn(state, c0, n):
            params, st, aux = state
            losses = []
            for c in range(c0, c0 + n):
                params, st, aux, loss, _ = cycle(
                    params, st, aux, c, m, data, coefs, cfg, opt_scale)
                losses.append(loss)
            return (params, st, aux), torch.stack(losses)
        return fn

    def k_a_call(K):
        def fn(state, c0, n):
            params, st, aux = state
            losses = []
            for c in range(c0, c0 + n, K):
                params, st, aux, ls, _ = E.stage1_cycles_fused(
                    params, st, aux, c, m, data, coefs, cfg, opt_scale,
                    n_cycles=min(K, c0 + n - c))
                losses.append(ls)
            return (params, st, aux), torch.cat(losses)
        return fn

    modes = {"loop": one_a_call(E.stage1_cycle_eager),
             "graph": one_a_call(E.stage1_cycle_fused)}
    modes.update({f"graph{K}": k_a_call(K) for K in Ks})

    period = cfg.update_filters_every
    c0 = -(-cfg.warmup_cycles // period) * period + 2
    _sync(dev)
    t0 = time.perf_counter()
    state, _ = modes["graph"]((params, E.rmsprop_init(params), aux), 0, c0)
    _sync(dev)
    report(f"warm: cycles 0-{c0 - 1} through the graphs (init solve, "
           f"captures) in {time.perf_counter() - t0:.1f}s")

    if check:
        # each mode from its own copy: the graph modes load theirs into
        # the static buffers, which `state` holds
        start, ref = tree_map(torch.clone, state), None
        for name, fn in modes.items():
            _, losses = fn(tree_map(torch.clone, start), c0, period)
            losses = losses.cpu()
            if ref is None:
                ref = losses
            elif not torch.equal(losses, ref):
                raise AssertionError(
                    f"{name} losses differ from loop's over cycles "
                    f"{c0}-{c0 + period - 1}: {losses} vs {ref}")
        report(f"check: the losses of {', '.join(modes)} over cycles "
               f"{c0}-{c0 + period - 1} are equal bit for bit "
               f"({ref[:3].tolist()} ...)")
        state = start

    seconds = {name: [] for name in modes}
    for rep in range(reps):
        for name, fn in modes.items():
            _sync(dev)
            t = time.perf_counter()
            state, losses = fn(state, c0, meas)
            _sync(dev)
            dt = (time.perf_counter() - t) / meas
            seconds[name].append(dt)
            report(f"{name}[{rep}] cycles {c0}-{c0 + meas - 1}: "
                   f"{1e3 * dt:.1f} ms a cycle ({cfg.num_frames / dt:.1f} "
                   f"frame-cycles/s)")
            c0 += meas
            if not torch.isfinite(losses).all():
                raise AssertionError(f"{name}: non-finite losses")
    med = {name: float(np.median(v)) for name, v in seconds.items()}
    base = med["loop"]
    report(f"summary on {_device_name(dev)} (median of {reps}): " + ", ".join(
        f"{name} {1e3 * s:.1f} ms a cycle ({100 * (base - s) / base:+.1f}% "
        f"vs loop)" for name, s in med.items()))
    return med


def _device_name(dev) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--Ks", default="5,15")
    ap.add_argument("--meas", type=int, default=30,
                    help="steady-state cycles per measurement")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--check", action="store_true",
                    help="the modes' losses equal over one refresh period")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    lines = []

    def report(line):
        print(line, flush=True)
        lines.append(line)

    seq, model = make_ts1_like_seq()
    med = run(seq, model, tuple(int(k) for k in a.Ks.split(",")), a.meas,
              a.reps, a.check, a.device, report)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return med


if __name__ == "__main__":
    main()

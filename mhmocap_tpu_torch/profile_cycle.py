"""Profile steady-state stage-1 cycles of the port on one GPU.

    python -m mhmocap_tpu_torch.profile_cycle [--warm 31] [--timed 40]
        [--profiled 3] [--out FILE]

Counterpart of the JAX package's `script/profile_cycle.py` on the bench
workload (`workload.make_ts1_like_seq`: T=201, N=3, 256x256, windows
160/128/112). The cycles are replays of a `CycleGraph` captured with
phase marks on (`ops/phase_marks.py`), as `Predictor.fit` captures
them. It reports:

  * the set-up spans (`spans.py`): the Predictor's layout, the init
    solve, data, aux, the graph's build and each variant's warm-up and
    capture, each with its seconds;
  * after `--warm` cycles (30 warm-up cycles, so the scene rebuild runs
    in every measured cycle), the wall time per cycle over `--timed`
    cycles, synchronized at both ends and not profiled;
  * from the marks of those replayed cycles, on the device's clock:
    each phase group's median ms (scene rebuild, One-Euro refresh, the
    chunks' forward, their backward with `_scale_reg`, the RMSprop
    update) over the plain cycles and over the refresh cycles (the
    One-Euro targets refreshed), their sum beside the cycle's time
    between CUDA events, each slot's median over the plain cycles, and
    the groups' medians over the first and the second half of the plain
    cycles;
  * over `--profiled` plain cycles, back to back, and one refresh cycle
    (profiled between two plain ones) under torch.profiler: the
    device's busy time (the sum of kernel, copy and memset times; one
    stream, so they do not overlap) as a share of the profiled wall and
    of the unprofiled cycle, the device launches per cycle, each phase
    group's launches, busy and idle time (the trace cut at the mark
    kernels, `phase_marks.split`; a trace that lost marks is reported
    as unreadable by phase), the raster kernel launches beside the face
    set-up kernels' and the window-loss kernels', the mark kernel's
    launches, the fill-in kernel's counts (calls, round launches, live
    rounds), the top device rows, the rows of the face set-up,
    window-loss and fill-in kernels, of every sort and of every indexing
    backward, and the top host ops by self time.

The report goes to stdout and, with --out, to that file as well.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import gpu_name_and_power
from .engine import optimizer as E
from .engine.cycle_graph import CycleGraph
from .engine.predictor import Predictor
from .ops import face_setup as FS
from .ops import fillin_cuda as FC
from .ops import phase_marks as PM
from .ops import raster_cuda as RC
from .ops import window_loss as WL
from .spans import Spans
from .workload import WINDOW, bench_args, make_ts1_like_seq


def _synced(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _groups_line(groups, which):
    return ", ".join(f"{g} {np.median(groups[g][which]):.3f}"
                     for g in PM.GROUPS)


def _phase_report(graph: CycleGraph, first: int, events, report):
    """The marks of cycles [first, first + len(events)) against the
    cycle times between their events."""
    cfg = graph.cfg
    last = first + len(events)
    groups = PM.group_ms(graph.phase_rows(first, last), cfg.num_chunks)
    ms = np.asarray([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    refresh = np.asarray([E.refresh_flags(c, cfg)[1]
                          for c in range(first, last)])
    plain = ~refresh
    total = sum(groups[g] for g in PM.GROUPS)
    report(f"phase ms, median of {plain.sum()} plain cycles: "
           f"{_groups_line(groups, plain)}; sum {np.median(total[plain]):.3f}"
           f"; cycle between events {np.median(ms[plain[1:]]):.3f}")
    if refresh.any():
        report(f"phase ms, median of {refresh.sum()} refresh cycles: "
               f"{_groups_line(groups, refresh)}; sum "
               f"{np.median(total[refresh]):.3f}; cycle between events "
               f"{np.round(ms[refresh[1:]], 3).tolist()}")
    slots = PM.phase_ms(graph.phase_rows(first, last), cfg.num_chunks)
    report("slot ms, median of the plain cycles: " + ", ".join(
        f"{k} {np.median(v[plain]):.3f}" for k, v in slots.items()))
    idx = np.flatnonzero(plain)
    half = len(idx) // 2
    if half:
        report("phase ms, plain cycles, first half / second half: "
               + ", ".join(f"{g} {np.median(groups[g][idx[:half]]):.3f} / "
                           f"{np.median(groups[g][idx[half:]]):.3f}"
                           for g in PM.GROUPS))


def _split_report(prof, orders, pick, what: str, report):
    """Launches, busy and idle time by phase group of the cycles `pick`
    (indices into `orders`, one order a replayed cycle) of a profiled
    run; a trace that lost marks is reported as unreadable."""
    ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda r: r[0])
    try:
        cuts = PM.split(ops, orders)
    except ValueError as err:
        report(f"{what}: unreadable by phase, {err}")
        return
    by_group = {}
    for phase, p in PM.total(cuts[i] for i in pick).items():
        g = PM.group_of(phase) if phase in orders[pick[0]] else phase
        row = by_group.setdefault(g, [0, 0.0, 0.0])
        row[0] += p.launches
        row[1] += p.busy_s
        row[2] += p.idle_s
    launches = sum(r[0] for r in by_group.values())
    marks = sum(len(orders[i]) for i in pick)
    n = len(pick)
    report(f"{what}: launches by phase a cycle "
           + ", ".join(f"{g} {r[0] / n:.0f}" for g, r in by_group.items())
           + f"; the phases hold {launches} launches and {marks} marks, of "
           f"the trace's {len(ops)} device ops over {len(orders)} cycles")
    report(f"{what}: busy ms / idle us by phase a cycle "
           + ", ".join(f"{g} {1e3 * r[1] / n:.3f} / {1e6 * r[2] / n:.1f}"
                       for g, r in by_group.items()))


def profile_cycles(warm: int, timed: int, profiled: int, report):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_cycle runs on a CUDA device")
    report(f"device: {gpu_name_and_power()}; torch {torch.__version__}")
    seq, model = make_ts1_like_seq()
    with Spans() as setup:
        with tempfile.TemporaryDirectory() as tmp:
            pred = Predictor(seq, model, tmp, bench_args(1, None, WINDOW),
                             device="cuda")
        cfg, m, coefs = pred.cfg, pred.model, pred.coefs
        params, _, opt_scale = E.init_params(
            m, seq.pose2d, seq.poses_smpl, seq.betas_smpl, seq.cam["K"], cfg)
        data = E.prepare_seq_data(seq, cfg, "cuda")
        betas_ref = torch.as_tensor(np.mean(seq.betas_smpl, axis=0,
                                            keepdims=True), device="cuda")
        aux = E.init_aux(cfg, m.num_vertices, betas_ref)
        every = cfg.update_filters_every
        num_cycles = warm + timed + profiled + 2 * every + 3
        graph = CycleGraph(params, E.rmsprop_init(params), aux, m, data,
                           coefs, cfg, opt_scale, num_cycles=num_cycles,
                           phase_marks=True)
        graph.prepare(0, num_cycles)
    report(f"set-up spans: {sum(r.seconds for r in setup.roots()):.3f} s "
           f"at the top level; " + ", ".join(
               f"{r.name} {r.seconds:.3f}" for r in
               sorted(setup.records, key=lambda r: r.start_ns)))
    cycle = 0

    def run(n):
        """Replay the next n cycles; returns the mark order of each."""
        nonlocal cycle
        orders = []
        for _ in range(n):
            orders.append(graph.mark_order[graph.replay(cycle)])
            cycle += 1
        return orders

    run(warm)
    first, events = cycle, []

    def timed_run():
        nonlocal cycle
        for _ in range(timed):
            graph.replay(cycle)
            cycle += 1
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
    per_cycle = _synced(timed_run) / timed
    report(f"cycles {first}..{cycle - 1}: {per_cycle:.4f} s per cycle "
           f"(unprofiled, synchronized at both ends)")
    _phase_report(graph, first, events, report)

    # plain cycles back to back, then the next refresh cycle between
    # two plain ones (a trace may drop its run's tail)
    refresh = -(-(cycle + profiled + 1) // every) * every
    run(refresh - profiled - 1 - cycle)
    for counts in (RC.launches, FS.launches, WL.launches, PM.launches,
                   FC.launches):
        counts.reset()
    first, orders = cycle, []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _synced(lambda: orders.extend(run(profiled)))
    _split_report(prof, orders, range(profiled),
                  f"plain cycles {first}..{cycle - 1}", report)
    ka = prof.key_averages()
    dev = sorted(((k.key, k.device_time_total / 1e3, k.count) for k in ka
                  if k.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    n_dev = sum(r[2] for r in dev)
    busy_cycle = busy / profiled
    report(f"profiled cycles {first}..{cycle - 1}: wall {wall:.4f} s; "
           f"device busy {busy:.2f} ms = {100 * busy / (1e3 * wall):.1f}% "
           f"of the profiled wall (idle "
           f"{100 - 100 * busy / (1e3 * wall):.1f}%); {busy_cycle:.2f} ms "
           f"per cycle = {100 * busy_cycle / (1e3 * per_cycle):.1f}% of the "
           f"unprofiled cycle (idle "
           f"{100 - 100 * busy_cycle / (1e3 * per_cycle):.1f}%)")
    report(f"device launches {n_dev} ({n_dev / profiled:.0f} per cycle, "
           f"marks included); raster kernel launches "
           f"{dict(RC.launches)}; face set-up kernel launches "
           f"{dict(FS.launches)}; window-loss kernel launches "
           f"{dict(WL.launches)}; mark kernel "
           f"{dict(PM.launches)}; fill-in kernel {dict(FC.launches)}")
    report("top device rows:")
    for key, ms, cnt in dev[:15]:
        report(f"  {ms:10.3f} ms  {100 * ms / busy:5.1f}%  x{cnt:6d}  "
               f"{key[:90]}")
    report("device rows of the face set-up, window-loss and fill-in "
           "kernels, of sorts and of indexing backwards:")
    for key, ms, cnt in dev:
        if any(w in key.lower() for w in ("mhmocap_faces", "mhmocap_fill",
                                          "mhmocap_window_loss", "sort",
                                          "indexing_backward")):
            report(f"  {ms:10.3f} ms  {100 * ms / busy:5.1f}%  x{cnt:6d}  "
                   f"{key[:90]}")
    host = sorted(((k.key, k.self_cpu_time_total / 1e3, k.count) for k in ka
                   if k.device_type == DeviceType.CPU), key=lambda r: -r[1])
    report(f"host self time {sum(r[1] for r in host):.1f} ms over "
           f"{profiled} cycles; top host ops:")
    for key, ms, cnt in host[:12]:
        report(f"  {ms:10.3f} ms  x{cnt:6d}  {key[:90]}")

    orders = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _synced(lambda: orders.extend(run(3)))
    _split_report(prof, orders, [1], f"refresh cycle {refresh} (profiled "
                  f"between cycles {refresh - 1} and {refresh + 1})", report)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warm", type=int, default=31)
    ap.add_argument("--timed", type=int, default=40)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    lines = []

    def report(line):
        print(line, flush=True)
        lines.append(line)

    profile_cycles(a.warm, a.timed, a.profiled, report)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()

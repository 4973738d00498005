"""Profile steady-state stage-1 cycles of the port on one GPU.

    python -m mhmocap_tpu_torch.profile_cycle [--warm 31] [--timed 10]
        [--profiled 3] [--out FILE]

Counterpart of the JAX package's `script/profile_cycle.py` on the bench
workload (`workload.make_ts1_like_seq`: T=201, N=3, 256x256, windows
160/128/112). The cycles are `stage1_cycle_fused` calls, i.e. CUDA
graph replays (`engine/cycle_graph.py`); the phases alone run eagerly.
After the init solve and `--warm` cycles (30 warm-up cycles, so the
scene rebuild runs in every measured cycle) it reports:

  * the wall time per cycle over `--timed` cycles, synchronized at both
    ends and not profiled;
  * the wall time of each phase of one cycle run alone, synchronized:
    `update_scene`, `update_filtered_targets` (every 25th cycle only on
    the main path) and `cycle_loss_and_grads`;
  * over `--profiled` cycles under torch.profiler: the device's busy
    time (the sum of kernel, copy and memset times; one stream, so they
    do not overlap) as a share of the profiled wall and of the
    unprofiled cycle, the device launches per cycle, the raster kernel
    launches, the fill-in kernel's counts (calls, round launches, live
    rounds), the top device rows, the rows of the fill-in kernel and of
    every sort, and the top host ops by self time.

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
from .engine.predictor import Predictor
from .ops import fillin_cuda as FC
from .ops.raster_cuda import RasterPlanes
from .workload import WINDOW, bench_args, make_ts1_like_seq


def _synced(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def profile_cycles(warm: int, timed: int, profiled: int, report):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_cycle runs on a CUDA device")
    report(f"device: {gpu_name_and_power()}; torch {torch.__version__}")
    seq, model = make_ts1_like_seq()
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, WINDOW),
                         device="cuda")
    cfg, m, coefs = pred.cfg, pred.model, pred.coefs
    params, _, opt_scale = E.init_params(m, seq.pose2d, seq.poses_smpl,
                                         seq.betas_smpl, seq.cam["K"], cfg)
    data = E.prepare_seq_data(seq, cfg, "cuda")
    betas_ref = torch.as_tensor(np.mean(seq.betas_smpl, axis=0,
                                        keepdims=True), device="cuda")
    aux = E.init_aux(cfg, m.num_vertices, betas_ref)
    st = E.rmsprop_init(params)
    cycle = 0

    def run(n):
        nonlocal params, st, aux, cycle
        for _ in range(n):
            params, st, aux, _, _ = E.stage1_cycle_fused(
                params, st, aux, cycle, m, data, coefs, cfg, opt_scale)
            cycle += 1

    run(warm)
    per_cycle = _synced(lambda: run(timed)) / timed
    report(f"cycles {warm}..{warm + timed - 1}: {per_cycle:.4f} s per "
           f"cycle (unprofiled, synchronized at both ends)")
    phases = {
        "update_scene": lambda: E.update_scene(params, data, cfg),
        "update_filtered_targets":
            lambda: E.update_filtered_targets(params, m, cfg),
        "cycle_loss_and_grads": lambda: E.cycle_loss_and_grads(
            params, m, data, aux, coefs, cfg),
    }
    report("phases alone, synchronized: " + ", ".join(
        f"{k} {_synced(fn):.4f} s" for k, fn in phases.items()))

    RasterPlanes.launches.reset()
    FC.launches.reset()
    first = cycle
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _synced(lambda: run(profiled))
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
    report(f"device launches {n_dev} ({n_dev / profiled:.0f} per cycle); "
           f"raster kernel launches {dict(RasterPlanes.launches)}; fill-in "
           f"kernel {dict(FC.launches)}")
    report("top device rows:")
    for key, ms, cnt in dev[:15]:
        report(f"  {ms:10.3f} ms  {100 * ms / busy:5.1f}%  x{cnt:6d}  "
               f"{key[:90]}")
    report("device rows of the fill-in kernel and of sorts:")
    for key, ms, cnt in dev:
        if "mhmocap_fill" in key or "sort" in key.lower():
            report(f"  {ms:10.3f} ms  {100 * ms / busy:5.1f}%  x{cnt:6d}  "
                   f"{key[:90]}")
    host = sorted(((k.key, k.self_cpu_time_total / 1e3, k.count) for k in ka
                   if k.device_type == DeviceType.CPU), key=lambda r: -r[1])
    report(f"host self time {sum(r[1] for r in host):.1f} ms over "
           f"{profiled} cycles; top host ops:")
    for key, ms, cnt in host[:12]:
        report(f"  {ms:10.3f} ms  x{cnt:6d}  {key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warm", type=int, default=31)
    ap.add_argument("--timed", type=int, default=10)
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

"""Realistic end-to-end run: a TS1-length sequence through the whole
pipeline, from files on disk to the stage-1 pickles.

Port of `script/bench_e2e.py`. Workload: a synthetic MuPoTs-like tree
written by the port's writer (T=201 frames, N=3 people, 256x256, the
full 6890-vertex body), ingested by `load_sequence`, then the init solve
and 250 stage-1 cycles of `Predictor.run` with raster_window 128 and
the reference cycle schedule (the scene rebuilt every cycle and the
filtered targets refreshed from cycle 30). Prints the wall time of each
part and the steady cycle time over cycles [30, 55), one full
filter-refresh period past the warmup.

Usage:
    python -m mhmocap_tpu_torch.bench_e2e [--frames 201] [--people 3]
        [--cycles 250] [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile
import time

from .config import require_device
from .data.ingestion import load_sequence
from .data.synthetic import generate_sequence
from .engine.predictor import Predictor
from .models.smpl import joints_function
from .models.synthetic import make_synthetic_smpl
from .workload import bench_args


def main(argv=None):
    """Run the workload; returns (Predictor, its run() output)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=201)
    ap.add_argument("--people", type=int, default=3)
    ap.add_argument("--cycles", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device, "--device cpu")

    t_all = time.time()
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as root:
        model = make_synthetic_smpl()
        generate_sequence(root, num_frames=args.frames,
                          num_people=args.people, image_size=(256, 256),
                          model=model, seed=3)
        t_gen = time.time() - t_all

        model = model.to(device)
        t0 = time.time()
        seq = load_sequence(root, joints_function(model, "joints_alphapose"),
                            resize_factor=1.0, post_process_depth=False,
                            renormalize_depth=False, device=device)
        t_ingest = time.time() - t0
        print(f"e2e: generate (test harness) {t_gen:.0f}s  "
              f"ingest (load_sequence) {t_ingest:.0f}s", flush=True)

        # the steady window: one full filter-refresh period past the
        # scene/contact warmup
        bc = (30, 55) if args.cycles > 55 else None
        pa = bench_args(args.cycles, bc, 128, verbose=True)
        pa.spmd = False
        t0 = time.time()
        with tempfile.TemporaryDirectory() as out:
            p = Predictor(seq, model, out, pa, device=device)
            res = p.run()
        t_fit = time.time() - t0
    total = time.time() - t_all

    log = res["stage1_log"]
    print(f"e2e: T={args.frames} N={args.people} window={p.cfg.window}"
          f" cycles={args.cycles}")
    print(f"e2e: generate {t_gen:.0f}s  ingest {t_ingest:.0f}s  "
          f"fit+init {t_fit:.0f}s  "
          f"TOTAL {total:.0f}s ({total / 60:.1f} min)")
    if p.bench_window_seconds:
        per_cycle = sum(p.bench_window_seconds) / (bc[1] - bc[0])
        print(f"e2e: steady-state cycle {per_cycle * 1e3:.0f}ms -> "
              f"{args.frames / per_cycle:.0f} frame-cycles/s "
              f"(cycles [{bc[0]}, {bc[1]}))")
    print(f"e2e: loss first/last = {log[0]['loss_pose24j']:.2f} / "
          f"{log[-1]['loss_pose24j']:.2f}")
    return p, res


if __name__ == "__main__":
    main()

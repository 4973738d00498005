"""Parallel MuPoTs TS1..TS20 sweep: one process per sequence, each pinned
to one card.

Port of `script/predict_mupots_sweep.py`. The per-sequence fits are
independent (the reference runs them as a sequential shell loop,
script/predict_mupots_full.sh), so on a host with several cards the
sweep is embarrassingly parallel across them: the process-level half of
the scaling story, beside the frame-axis sharding inside one sequence
(`parallel/spmd.py`), which is the tool when one long sequence must
finish fast.

Each worker gets `CUDA_VISIBLE_DEVICES=<slot>`, so that the process sees
exactly one card (as its cuda:0); with `--device cpu` the sweep runs CPU
workers instead (the tests, and smoke runs on a host without a card).

Usage:
    python -m mhmocap_tpu_torch.predict_mupots_sweep \
        --configs_yml configs/predict_mupots.yml \
        --output_path ./output/mupots \
        --workers 8 [--ts 1,2,5] [--retries 1] [--device cuda]

Arguments it does not know are passed on to every predict_mupots call.
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import threading
import time

from .parallel.ranks import PACKAGE_ROOT


def build_commands(ts_ids, configs_yml, output_path, extra_args=(),
                   device="cuda"):
    """One predict_mupots invocation per TS id."""
    return [
        [sys.executable, "-m", "mhmocap_tpu_torch.predict_mupots",
         "--configs_yml", configs_yml, "--ts_id", str(ts),
         "--output_path", output_path, "--device", device, *extra_args]
        for ts in ts_ids
    ]


def worker_env(slot: int, device: str = "cuda") -> dict:
    """Environment of a worker pinned to card `slot` (none on the CPU),
    with the package importable from any working directory."""
    env = dict(os.environ)
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    else:
        env["CUDA_VISIBLE_DEVICES"] = str(slot)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p and p != PACKAGE_ROOT])
    return env


def run_sweep(cmds, workers: int, device: str = "cuda",
              log_dir: str | None = None, retries: int = 0,
              labels=None, job_timeout: float | None = None):
    """Run `cmds` over `workers` pinned slots; returns {label:
    returncode}. A failed command is retried up to `retries` times on
    the same slot before it is recorded as failed. A job that runs past
    `job_timeout` seconds is killed and recorded (or retried) as rc=124,
    so that one hung worker cannot stall the sweep."""
    labels = labels or [f"job{i}" for i in range(len(cmds))]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    queue = list(zip(labels, cmds))
    results = {}
    lock = threading.Lock()

    def pump(slot):
        while True:
            with lock:
                if not queue:
                    return
                label, cmd = queue.pop(0)
            env = worker_env(slot, device)
            for attempt in range(retries + 1):
                t0 = time.time()
                log_f = None
                if log_dir:
                    log_f = open(os.path.join(log_dir, f"{label}.log"),
                                 "ab")
                try:
                    try:
                        rc = subprocess.run(
                            cmd, cwd=PACKAGE_ROOT, env=env, stdout=log_f,
                            stderr=subprocess.STDOUT if log_f else None,
                            timeout=job_timeout,
                        ).returncode
                    except subprocess.TimeoutExpired:
                        rc = 124
                finally:
                    if log_f:
                        log_f.close()
                dt = time.time() - t0
                print(f"[slot {slot}] {label}: rc={rc} ({dt:.0f}s, "
                      f"attempt {attempt + 1})", flush=True)
                if rc == 0:
                    break
            with lock:
                results[label] = rc

    threads = [threading.Thread(target=pump, args=(s,))
               for s in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def audit_windows(output_path: str, ts_ids):
    """Post-run audit: each sequence's raster window and residual
    supervision clip rate from its stage-1 pickle (the window guard
    otherwise reports only on stdout at init)."""
    for ts in ts_ids:
        pkl = os.path.join(output_path, f"TS{ts}", "optvar_stage1.pkl")
        if not os.path.exists(pkl):
            continue
        with open(pkl, "rb") as f:
            ov = pickle.load(f)
        win = ov.get("raster_window")
        clip = ov.get("window_clip_rate")
        if win is not None:
            flag = " !" if (clip or 0) > 0 else ""
            print(f"TS{ts}: raster_window={win} "
                  f"clip_rate={100 * (clip or 0):.2f}%{flag}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs_yml", default="configs/predict_mupots.yml")
    ap.add_argument("--output_path", default="./output/mupots")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--ts", default=",".join(str(i) for i in range(1, 21)))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--log_dir", default=None,
                    help="per-TS log files (default: stream to stdout)")
    args, extra = ap.parse_known_args(argv)

    ts_ids = [int(t) for t in args.ts.split(",") if t]
    # the workers run from the repository's root
    cmds = build_commands(ts_ids, args.configs_yml,
                          os.path.abspath(args.output_path), extra,
                          args.device)
    labels = [f"TS{t}" for t in ts_ids]
    t0 = time.time()
    results = run_sweep(cmds, min(args.workers, len(cmds)),
                        device=args.device, log_dir=args.log_dir,
                        retries=args.retries, labels=labels)
    failed = {k: v for k, v in results.items() if v != 0}
    print(f"sweep: {len(results) - len(failed)}/{len(results)} ok in "
          f"{time.time() - t0:.0f}s"
          + (f"; FAILED: {sorted(failed)}" if failed else ""))
    audit_windows(args.output_path, ts_ids)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

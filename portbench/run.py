"""Run one cell of the port's benchmark once, on one card.

    python -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Prints, as its last lines on standard
error, each number the check compared beside its limit, and as the last
line of standard output one JSON object: `correct`, `attempted` (cycles
in the window), `failed` (of them, cycles whose loss is not finite),
`metrics` (with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`. The line before it gives the card's SM
clock and power over the window. It exits non-zero and prints no result
without a CUDA card (or with fewer than the cell asks for), when a
module of JAX, Flax or the JAX package is loaded once the window has
closed or before the result is printed, or when anything fails.
`--controls 1` (not for the benchmark's own runs) adds each control's
readings under "controls".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """Wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = process_start()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--controls", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from .harness import forbidden_modules, load_cell, run_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T_PROCESS, controls=bool(args.controls))
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']:.6g} (limit {row['limit']:.6g})",
              file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How far rounding alone moves the fit's accuracy, on the card.

    python -m mhmocap_tpu_torch.rounding_spread [--trees ts3 entry1]
        [--variants kernel one_group] [--seeds 0 1 2 3]
        [--workdir build/rounding_spread] [--out FILE]

Writes each tree once, then runs it through `predict_mupots.main` and
`eval_mupots.main` once per (variant, perturbation). The runs differ
only in rounding:

  * the forward kernel's chunk groups: `kernel` is the library built
    from csrc/ (8 groups a block), `one_group` the same source with
    `raster_ablation`'s edit to one group, built under build/ and
    swapped in for the whole run. Its z-buffer and winners are
    bit-identical; only the order in which a pixel's log-sums meet
    changes;
  * the params after the init solve: unperturbed, or every entry moved
    by one ulp up or down, the direction drawn by a CPU
    `torch.Generator` seeded with each of `--seeds` (through the
    Predictor's Python API: `Predictor.fit` receives the perturbed
    params).

Trees (60 frames, 256x256, the full synthetic body, 100 cycles):

  ts3     the degraded sweep's TS3 (`sweep.degradation_plan(3)`, seed 10,
          3 people) under the robust knobs (id_swap_fix 0.5,
          gap_aware_temporal), as `sweep --degraded --swap_fix 0.5
          --gap_temporal` runs it;
  entry1  `chip_smoke.py` phase 6's TS1 (seed 8, 3 people) with
          post_process_depth on.

Prints one line per run (pck_rel, mm_rel_error, abs_jitter), then
min / median / max of each per tree and variant and over the whole
tree, and nvidia-smi's name and power limit. `--device cpu` with
`--variants kernel` runs the tool on the CPU (the plain raster).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess
import time

import torch

from . import eval_mupots, predict_mupots, sweep
from .config import require_device
from .data.synthetic import generate_sequence
from .engine import optimizer as E
from .engine.predictor import Predictor
from .models.synthetic import make_synthetic_smpl
from .ops import raster_cuda as RC

METRICS = ("pck_rel", "mm_rel_error", "abs_jitter")
# the trees' size: frames, image side, synthetic body vertices, cycles
FRAMES, SIDE, NUM_VERTICES, NUM_ITER = 60, 256, 6890, 100

# (TS id, people, writer seed, degradations, sweep_config keywords)
TREES = {
    "ts3": (3, 3, 7 + 3, "degraded",
            dict(gap_aware_temporal=True, id_swap_fix=0.5)),
    "entry1": (1, 3, 7 + 1, None, dict(post_process_depth=True)),
}


def perturb_ulp(params: E.StageParams, seed: int) -> E.StageParams:
    """Every entry moved by one ulp towards +inf or -inf, the direction
    drawn per entry by a CPU generator seeded with `seed` (the same
    draws on any device)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for p in params:
        up = torch.rand(p.shape, generator=gen) < 0.5
        inf = torch.where(up, float("inf"), float("-inf")).to(p.device)
        out.append(torch.nextafter(p, inf))
    return E.StageParams(*out)


class PerturbedPredictor(Predictor):
    """The Predictor with its init-solve params perturbed by
    `perturb_ulp(params, seed)` before the fit (`seed` None: as is)."""

    seed = None

    def fit(self, params, optimize_scale, verbose=True):
        if self.seed is not None:
            params = perturb_ulp(params, self.seed)
        return super().fit(params, optimize_scale, verbose=verbose)


@contextlib.contextmanager
def _swapped(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def one_group_library():
    """The raster library with the forward kernel at one chunk group
    (raster_ablation's `one_group` edit), built under build/."""
    from .raster_ablation import build
    lib, proc = build("one_group")
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for one_group:\n{log}")
    return RC._bind(ctypes.CDLL(str(lib)))


def write_tree(data_path, tree, frames, image_size, model):
    ts, people, seed, deg, _ = TREES[tree]
    generate_sequence(
        os.path.join(data_path, f"TS{ts}"), num_frames=frames,
        num_people=people, image_size=(image_size, image_size),
        model=model, seed=seed, mupots_gt=True,
        degradations=(sweep.degradation_plan(ts, frames)
                      if deg == "degraded" else None))


def run_once(cfg_path, ts, out, seed, library, device, log):
    """predict_mupots + eval_mupots on TS`ts` with the forward library
    `library` (None: the one built from csrc/) and init params perturbed
    by `seed`; returns the tree's (pck_rel, mm_rel_error, abs_jitter)."""
    swap_lib = (_swapped(RC, "_library", lambda: library) if library
                else contextlib.nullcontext())
    with swap_lib, _swapped(predict_mupots, "Predictor",
                            PerturbedPredictor), \
            _swapped(PerturbedPredictor, "seed", seed), \
            contextlib.redirect_stdout(log):
        predict_mupots.main(["--configs_yml", cfg_path, "--ts_id", str(ts),
                             "--output_path", out, "--device", device])
        final = eval_mupots.main(["--configs_yml", cfg_path, "--input_path",
                                  out, "--device", device])
    return tuple(float(final[k][0]) for k in METRICS)


def summary(rows):
    """min / median / max of each metric over `rows` of METRICS."""
    cols = list(zip(*rows))
    return "  ".join(
        f"{k} {min(c):.2f} / {statistics.median(c):.2f} / {max(c):.2f}"
        for k, c in zip(METRICS, cols))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=list(TREES),
                    choices=list(TREES))
    ap.add_argument("--variants", nargs="+", default=["kernel", "one_group"],
                    choices=["kernel", "one_group"])
    ap.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "rounding_spread"))
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    device = require_device(args.device, "--device cpu")
    if "one_group" in args.variants and device.type != "cuda":
        ap.error("the one_group variant edits the CUDA kernel: it needs "
                 "the card")

    libraries = {"kernel": None}
    if "one_group" in args.variants:
        libraries["one_group"] = one_group_library()
    model = make_synthetic_smpl(num_vertices=NUM_VERTICES)
    lines, results = [], {}

    def emit(line):
        lines.append(line)
        print(line, flush=True)

    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "runs.log"), "w") as log:
        for tree in args.trees:
            ts, _, _, _, knobs = TREES[tree]
            root = os.path.join(args.workdir, tree)
            data = os.path.join(root, "data")
            write_tree(data, tree, FRAMES, SIDE, model)
            cfg = sweep.write_config(
                os.path.join(root, "predict.yml"),
                sweep.sweep_config(data, NUM_ITER, **knobs))
            for variant in args.variants:
                for seed in [None] + list(args.seeds):
                    t0 = time.time()
                    out = os.path.join(root, "out", f"{variant}_{seed}")
                    got = run_once(cfg, ts, out, seed, libraries[variant],
                                   args.device, log)
                    results.setdefault(tree, {}).setdefault(
                        variant, []).append(got)
                    emit(f"{tree} {variant:9s} seed {str(seed):4s} "
                         + "  ".join(f"{k} {v:.2f}"
                                     for k, v in zip(METRICS, got))
                         + f"  ({time.time() - t0:.1f}s)")
    for tree, by_variant in results.items():
        for variant, rows in by_variant.items():
            emit(f"{tree} {variant:9s} min/median/max  {summary(rows)}")
        emit(f"{tree} all       min/median/max  "
             f"{summary([r for rows in by_variant.values() for r in rows])}")
    if device.type == "cuda":
        emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return results


if __name__ == "__main__":
    main()

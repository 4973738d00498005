"""Synthetic end-to-end accuracy sweep of the port.

Port of `script/synthetic_e2e_sweep.py`: writes K synthetic
MuPoTs-format trees with the port's writer (TS i: 3 people when i is
odd, else 2; seed 7 + i; the full 6890-vertex synthetic body;
annot.mat / occlusion.mat / intrinsics.txt), runs `predict_mupots.main`
on each and `eval_mupots.main` over all of them in this process, prints
the averaged FinalResults as one JSON line and checks the tier's pinned
bounds. Without SMPL_NEUTRAL.pkl the prediction resolves the same
synthetic body the writer used, so GT and fit agree.

Tiers:
  * clean (default): `BOUNDS["clean"]` over the K trees;
  * `--hard_clean M` appends M harder clean trees (fast motion, a close
    pair with depth-tested confidences; `hard_clean_plan`) checked
    against `BOUNDS["hard"]`; `--num_seqs 0 --hard_clean M` runs them
    alone;
  * `--degraded`: each tree stresses one robustness path
    (`degradation_plan`); it must complete with finite metrics, and
    with the robust profile (`--swap_fix` > 0 and `--gap_temporal`) it
    is checked against `BOUNDS["robust"]`.
The knobs `--swap_fix`, `--gap_temporal`, `--gap_interp` and
`--lagged_decay` set `id_swap_fix`, `gap_aware_temporal`,
`gap_interpolate` and `lagged_conf_decay`, and each adds the JAX
sweep's suffix to the work directory.

Usage:
    python -m mhmocap_tpu_torch.sweep [--num_seqs 5] [--frames 60]
        [--num_iter 100] [--hard_clean M] [--degraded] [--swap_fix 0.5]
        [--gap_temporal] [--gap_interp] [--lagged_decay 0.8]
        [--device cuda] [--workdir build/mupots_synth]

Exits 2 when a bound is violated.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import eval_mupots, predict_mupots
from .config import PROJECT_DIR, dump_yaml
from .data.synthetic import generate_sequence
from .models.synthetic import make_synthetic_smpl

# Pinned accuracy bounds per tier, as in the JAX sweep
# (script/synthetic_e2e_sweep.py BOUNDS); each averages its tier's
# sequences unweighted. hard: the JAX package measured 94.5 / 47.9;
# robust: the degraded tier under swap_fix 0.5 + gap_aware_temporal,
# 97.13 / 28.09 mm (docs/PARITY.md section 5).
BOUNDS = {
    "clean": {"pck_rel": (">=", 98.5), "mm_rel_error": ("<=", 48.0)},
    "hard": {"pck_rel": (">=", 91.5), "mm_rel_error": ("<=", 58.0)},
    "robust": {"pck_rel": (">=", 96.5), "abs_jitter": ("<=", 30.0)},
}


def degradation_plan(ts_id: int, frames: int) -> dict:
    """Per-sequence degradation mix of the --degraded tier: TS1..TS4
    each stress one robustness path, TS5 combines them at milder rates
    (see data/synthetic.py `degradations`); ids past 5 wrap around."""
    third = max(frames // 3, 2)
    plans = {
        1: {"crossing_paths": True},
        2: {"id_switch_spans": [(third, third + 5),
                                (2 * third, 2 * third + 4)],
            "detection_dropout": 0.10},
        3: {"romp_person_dropout": 0.20, "romp_missing_frames": 0.10},
        4: {"enter_leave": True},
        5: {"crossing_paths": True, "enter_leave": True,
            "id_switch_spans": [(third, third + 4)],
            "detection_dropout": 0.05,
            "romp_person_dropout": 0.10,
            "romp_missing_frames": 0.05},
    }
    return plans[1 + (ts_id - 1) % 5]


def hard_clean_plan(k: int) -> dict:
    """The k-th harder clean sequence, cycling two scenarios: fast
    motion (2.5x frequency, 1.6x drift) and a close pair weaving at
    near-equal depth with depth-tested joint confidences."""
    plans = [
        {"motion": {"speed": 2.5, "amp": 1.6}, "num_people": 3,
         "degradations": None},
        {"motion": {"close_pair": True, "speed": 1.5}, "num_people": 2,
         "degradations": {"occlusion_conf": True}},
    ]
    return plans[k % 2]


def sweep_config(data_path: str, num_iter: int, raster_window: int = 128,
                 post_process_depth: bool = False,
                 gap_interpolate: bool = False,
                 gap_aware_temporal: bool = False,
                 lagged_conf_decay: float = 1.0, id_swap_fix: float = 0.0,
                 **extra_args) -> dict:
    """The JAX sweep's prediction config (make_config); `extra_args`
    are added to ARGS."""
    return {
        "ARGS": {
            "batch_size": 10,
            "gap_interpolate": gap_interpolate,
            "gap_aware_temporal": gap_aware_temporal,
            "resize_factor": 1.0,
            "erode_segmentation_iters": 0,
            "erode_backmask_iters": 0,
            "renormalize_depth": False,
            "post_process_depth": post_process_depth,
            "num_iter": num_iter,
            "proj2d_loss_coef": 1.0,
            "depth_loss_coef": 0.05,
            "silhouette_loss_coef": 0.1,
            "reg_poses_coef": 0.002,
            "reg_scales_coef": 0.0001,
            "reg_velocity_coef": 0.05,
            "reg_verts_filter_coef": 0.002,
            "reg_contact_coef": 0.001,
            "reg_foot_sliding_coef": 0.01,
            "save_visualizations": False,
            "raster_window": raster_window,
            **extra_args,
        },
        "smpl": {"smpl_model_parameters_path": "/nonexistent-synthetic"},
        "data": {
            "data_path": data_path,
            "depth_path": "DPT_large_monodepth",
            "joint_confidence_thr": 0.5,
            "use_hrnet_pose": False,
            "start_frame": 0,
            "end_frame": -1,
            "step_frame": 1,
            "lagged_conf_decay": lagged_conf_decay,
            "id_swap_fix": id_swap_fix,
        },
    }


def write_config(path: str, cfg: dict) -> str:
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path


def check_bounds(final: dict, n_std: int, n_hard: int = 0,
                 degraded: bool = False, robust: bool = False):
    """(n_checks, violations) of the pinned BOUNDS against a
    FinalResults dict (metric -> [TS1..TSn, weighted Avg.]), each on
    the unweighted average of its tier: clean over the first `n_std`
    sequences and hard over the `n_hard` after them; a degraded run is
    checked only under the robust profile (`robust`), against
    BOUNDS["robust"] over its `n_std` sequences.

    An empty tier has nothing to pin and makes no check: its average
    would be nan, and every comparison with nan is False, so a
    `value < bound` test would pass it silently. For the same reason a
    bound is met only when the comparison holds, so a nan average
    violates it."""
    tiers = ([("robust", 0, n_std)] if robust else []) if degraded else [
        ("clean", 0, n_std), ("hard", n_std, n_std + n_hard)]
    checks = [(tier, key, op, bound, float(np.mean(final[key][lo:hi])))
              for tier, lo, hi in tiers if hi > lo
              for key, (op, bound) in BOUNDS[tier].items()]
    violations = [
        f"{tier} {key}={v:.2f} violates {op} {b}"
        for tier, key, op, b, v in checks
        if not (v >= b if op == ">=" else v <= b)]
    return len(checks), violations


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir",
                    default=os.path.join(PROJECT_DIR, "build",
                                         "mupots_synth"))
    ap.add_argument("--num_seqs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--num_iter", type=int, default=100)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--num_vertices", type=int, default=0,
                    help="downsampled synthetic body for CPU smoke runs "
                         "(0 = full 6890)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hard_clean", type=int, default=0,
                    help="append N harder clean sequences (hard_clean_plan)"
                         " after the standard ones, bounded separately")
    ap.add_argument("--degraded", action="store_true",
                    help="one robustness path per sequence "
                         "(degradation_plan); checked against "
                         "BOUNDS['robust'] under --swap_fix and "
                         "--gap_temporal, else for finite metrics only")
    ap.add_argument("--swap_fix", type=float, default=0.0,
                    help="id_swap_fix ingestion knob (0 = off)")
    ap.add_argument("--gap_temporal", action="store_true",
                    help="gap_aware_temporal: stale-aware temporal terms "
                         "during the fit")
    ap.add_argument("--gap_interp", action="store_true",
                    help="gap_interpolate: post-fit interpolation of the "
                         "unobserved spans")
    ap.add_argument("--lagged_decay", type=float, default=1.0,
                    help="lagged_conf_decay ingestion knob (1.0 = off)")
    args = ap.parse_args(argv)
    if args.hard_clean and args.degraded:
        ap.error("--hard_clean extends the clean tier, not --degraded")
    if args.num_seqs < (0 if args.hard_clean else 1):
        ap.error("--num_seqs must be at least 1 (or 0 with --hard_clean)")

    # the JAX sweep's work-directory suffixes, one per knob
    if args.degraded and args.workdir == ap.get_default("workdir"):
        args.workdir += "_degraded"
    for on, suffix in ((args.lagged_decay < 1.0, "_decay"),
                       (args.gap_interp, "_interp"),
                       (args.swap_fix > 0.0, "_swapfix"),
                       (args.gap_temporal, "_gaptemporal"),
                       (args.hard_clean > 0, "_hard")):
        if on:
            args.workdir += suffix

    if args.num_vertices:
        # the prediction and the evaluation resolve the same downsampled
        # body through the loader's environment hook
        os.environ["MHMOCAP_SYNTHETIC_SMPL"] = str(args.num_vertices)

    data_path = os.path.join(args.workdir, "data")
    out_path = os.path.join(args.workdir, "out")
    os.makedirs(data_path, exist_ok=True)
    ts_ids = list(range(1, args.num_seqs + 1))
    hard_ids = list(range(args.num_seqs + 1,
                          args.num_seqs + 1 + args.hard_clean))

    model = make_synthetic_smpl(num_vertices=args.num_vertices or 6890)
    trees = [(i, dict(num_people=3 if i % 2 else 2,
                      degradations=(degradation_plan(i, args.frames)
                                    if args.degraded else None)))
             for i in ts_ids]
    trees += [(i, hard_clean_plan(k)) for k, i in enumerate(hard_ids)]
    for i, kw in trees:
        t0 = time.time()
        generate_sequence(
            os.path.join(data_path, f"TS{i}"), num_frames=args.frames,
            image_size=(args.image_size, args.image_size),
            model=model, seed=7 + i, mupots_gt=True, **kw)
        print(f"generated TS{i} in {time.time() - t0:.1f}s", flush=True)
    ts_ids += hard_ids

    cfg_path = write_config(
        os.path.join(args.workdir, "predict.yml"),
        sweep_config(data_path, args.num_iter,
                     gap_interpolate=args.gap_interp,
                     gap_aware_temporal=args.gap_temporal,
                     lagged_conf_decay=args.lagged_decay,
                     id_swap_fix=args.swap_fix))
    device = ["--device", args.device]
    for i in ts_ids:
        t0 = time.time()
        predict_mupots.main(["--configs_yml", cfg_path, "--ts_id", str(i),
                             "--output_path", out_path] + device)
        print(f"predicted TS{i} in {time.time() - t0:.1f}s", flush=True)
    final = eval_mupots.main(["--configs_yml", cfg_path,
                              "--input_path", out_path] + device)

    n = args.num_seqs
    keys = ("pck_rel", "mm_rel_error", "abs_jitter")
    out = {
        "metric": "synthetic_e2e_sweep" + ("_degraded" if args.degraded
                                           else ""),
        "sequences": n, "frames": args.frames, "num_iter": args.num_iter,
        "lagged_decay": args.lagged_decay, "gap_interp": args.gap_interp,
        "swap_fix": args.swap_fix, "gap_temporal": args.gap_temporal,
        "device": (torch.cuda.get_device_name(0)
                   if torch.device(args.device).type == "cuda"
                   else args.device),
        "avg": {k: v[-1] for k, v in final.items()},
        "per_ts": {k: v[:n] for k, v in final.items() if k in keys},
    }
    if args.hard_clean:
        out["hard_per_ts"] = {k: v[n:-1] for k, v in final.items()
                              if k in keys}
    print(json.dumps(out), flush=True)
    n_checks, violations = check_bounds(
        final, n, args.hard_clean, degraded=args.degraded,
        robust=args.swap_fix > 0.0 and args.gap_temporal)
    # every tier, the unpinned degraded one included, must end with
    # finite metrics
    bad = sorted(k for k, v in final.items() if not np.isfinite(v).all())
    if bad:
        violations.append(f"non-finite metrics: {bad}")
    if violations:
        print(json.dumps({"bounds_violations": violations}))
        sys.exit(2)
    print(f"bounds OK ({n_checks} checks)")
    return final


if __name__ == "__main__":
    main()

"""Synthetic end-to-end accuracy sweep of the port (clean tier).

Port of the clean tier of `script/synthetic_e2e_sweep.py`: writes K
synthetic MuPoTs-format trees with the port's writer (TS i: 3 people
when i is odd, else 2; seed 7 + i; the full 6890-vertex synthetic body;
annot.mat / occlusion.mat / intrinsics.txt), runs
`predict_mupots.main` on each and `eval_mupots.main` over all of them in
this process, prints the averaged FinalResults as one JSON line and
checks `BOUNDS["clean"]`. Without SMPL_NEUTRAL.pkl the prediction
resolves the same synthetic body the writer used, so GT and fit agree.

Usage:
    python -m mhmocap_tpu_torch.sweep [--num_seqs 5] [--frames 60]
        [--num_iter 100] [--device cuda] [--workdir build/mupots_synth]

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

# Pinned accuracy bounds of the clean tier, as in the JAX sweep
# (script/synthetic_e2e_sweep.py BOUNDS["clean"]); the bounds average
# the tier's sequences unweighted.
BOUNDS = {"clean": {"pck_rel": (">=", 98.5), "mm_rel_error": ("<=", 48.0)}}


def sweep_config(data_path: str, num_iter: int, raster_window: int = 128,
                 post_process_depth: bool = False, **extra_args) -> dict:
    """The JAX sweep's prediction config (make_config) for the clean
    tier; `extra_args` are added to ARGS."""
    return {
        "ARGS": {
            "batch_size": 10,
            "gap_interpolate": False,
            "gap_aware_temporal": False,
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
            "lagged_conf_decay": 1.0,
            "id_swap_fix": 0.0,
        },
    }


def write_config(path: str, cfg: dict) -> str:
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path


def check_bounds(final: dict, n_seqs: int):
    """(n_checks, violations) of BOUNDS["clean"] against the unweighted
    average of the first `n_seqs` sequences of a FinalResults dict
    (metric -> [TS1..TSn, weighted Avg.]).

    An empty tier has nothing to pin and makes no check: its average
    would be nan, and every comparison with nan is False, so a
    `value < bound` test would pass it silently. For the same reason a
    bound is met only when the comparison holds, so a nan average
    violates it."""
    if n_seqs <= 0:
        return 0, []
    checks = [(key, op, bound, float(np.mean(final[key][:n_seqs])))
              for key, (op, bound) in BOUNDS["clean"].items()]
    violations = [
        f"clean {key}={v:.2f} violates {op} {b}"
        for key, op, b, v in checks
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
    args = ap.parse_args(argv)
    if args.num_seqs < 1:
        ap.error("--num_seqs must be at least 1")

    if args.num_vertices:
        # the prediction and the evaluation resolve the same downsampled
        # body through the loader's environment hook
        os.environ["MHMOCAP_SYNTHETIC_SMPL"] = str(args.num_vertices)

    data_path = os.path.join(args.workdir, "data")
    out_path = os.path.join(args.workdir, "out")
    os.makedirs(data_path, exist_ok=True)
    ts_ids = list(range(1, args.num_seqs + 1))

    model = make_synthetic_smpl(num_vertices=args.num_vertices or 6890)
    for i in ts_ids:
        t0 = time.time()
        generate_sequence(
            os.path.join(data_path, f"TS{i}"), num_frames=args.frames,
            num_people=3 if i % 2 else 2,
            image_size=(args.image_size, args.image_size),
            model=model, seed=7 + i, mupots_gt=True)
        print(f"generated TS{i} in {time.time() - t0:.1f}s", flush=True)

    cfg_path = write_config(
        os.path.join(args.workdir, "predict.yml"),
        sweep_config(data_path, args.num_iter))
    device = ["--device", args.device]
    for i in ts_ids:
        t0 = time.time()
        predict_mupots.main(["--configs_yml", cfg_path, "--ts_id", str(i),
                             "--output_path", out_path] + device)
        print(f"predicted TS{i} in {time.time() - t0:.1f}s", flush=True)
    final = eval_mupots.main(["--configs_yml", cfg_path,
                              "--input_path", out_path] + device)

    n = args.num_seqs
    print(json.dumps({
        "metric": "synthetic_e2e_sweep",
        "sequences": n, "frames": args.frames, "num_iter": args.num_iter,
        "device": (torch.cuda.get_device_name(0)
                   if torch.device(args.device).type == "cuda"
                   else args.device),
        "avg": {k: v[-1] for k, v in final.items()},
        "per_ts": {k: v[:n] for k, v in final.items()
                   if k in ("pck_rel", "mm_rel_error")},
    }), flush=True)
    n_checks, violations = check_bounds(final, n)
    if violations:
        print(json.dumps({"bounds_violations": violations}))
        sys.exit(2)
    print(f"bounds OK ({n_checks} checks)")
    return final


if __name__ == "__main__":
    main()

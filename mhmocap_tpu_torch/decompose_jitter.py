"""Per-frame matched-jitter decomposition against the stale mask.

Port of `script/decompose_jitter.py`. The degraded tier's jitter has
three homes (docs/PARITY.md): frames inside a detection gap
(unobserved: a post-fit pass may fix them), the observed frames flanking
a gap (smeared during the fit by the temporal regularizers: only
`gap_aware_temporal` treats them), and ID-switch transients (the wrong
person's real evidence: `id_swap_fix`). This classifies every frame of
one sequence and prints the per-class means and the top spike frames,
so that a knob's effect lands on the class it claims to treat.

Usage:
    python -m mhmocap_tpu_torch.decompose_jitter \
        --workdir build/mupots_synth_degraded_gaptemporal \
        [--ts 4] [--top 8] [--device cuda]

Reads `<workdir>/predict.yml` and `<workdir>/out/TS<ts>` (the sweep's
layout). Re-ingests the sequence on `--device` when the prediction
pickle predates the `lagged_tn` record; the SMPL joints of the metric
run there as well.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def frame_jitter_mm(m: dict) -> np.ndarray:
    """(T,) masked mean matched jitter in mm (eval.metrics arrays)."""
    j, v = m["abs_jitter"], m["valid_joints"]
    num = (j * v).sum(axis=(1, 2))
    den = np.maximum(v.sum(axis=(1, 2)), 1.0)
    return 1000.0 * num / den


def classify_frames(stale_tn: np.ndarray) -> np.ndarray:
    """(T,) class per frame: 0 = clear, 1 = inside a gap (any person
    stale), 2 = observed flank (no person stale at t, but some person
    stale at t-1 or t+1: the during-fit smear target)."""
    any_stale = stale_tn.any(axis=1)
    T = any_stale.shape[0]
    cls = np.zeros(T, np.int64)
    cls[any_stale] = 1
    prev_stale = np.concatenate([[False], any_stale[:-1]])
    next_stale = np.concatenate([any_stale[1:], [False]])
    flank = ~any_stale & (prev_stale | next_stale)
    cls[flank] = 2
    return cls


def main(argv=None):
    """Print the decomposition of one sequence; returns its JSON
    record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--ts", type=int, default=4)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .config import ConfigContext, parse_args, require_device
    from .eval.metrics import pose_error_3dproj
    from .models.loader import resolve_smpl_model
    from .models.smpl import joints_function
    from .predict_mupots import build_mupots_sequence

    device = require_device(args.device, "--device cpu")
    out_dir = os.path.join(args.workdir, "out", f"TS{args.ts}")
    with open(os.path.join(out_dir, "optvar_stage1.pkl"), "rb") as f:
        optvar = pickle.load(f)
    with open(os.path.join(out_dir, "mupots_annot.pkl"), "rb") as f:
        annot = pickle.load(f)

    # --input_path would override data['data_path']; the config's
    # data_path points at the trees
    parsed = parse_args(["--configs_yml",
                         os.path.join(args.workdir, "predict.yml"),
                         "--ts_id", str(args.ts)])
    with ConfigContext(parsed):
        kargs = dict(parsed.smpl)
        kargs.update(parsed.data)
        stale = optvar.get("lagged_tn")
        if stale is None:
            # the pickle predates the record: re-ingest for the mask
            seq, model, *_ = build_mupots_sequence(
                ts_id=args.ts, resize_factor=parsed.resize_factor,
                device=device, **kargs)
            stale = np.asarray(seq.lagged_tn)
        else:
            model = resolve_smpl_model(
                kargs["smpl_model_parameters_path"]).to(device)
        m = pose_error_3dproj(
            optvar, annot["pose3d_gt"], annot["visibility"],
            joints_function(model, "joints_mupots"),
            np.asarray(annot["cam_K"], np.float32))

    jmm = frame_jitter_mm(m)
    cls = classify_frames(stale.astype(bool))
    names = {0: "clear", 1: "gap", 2: "flank"}

    spans = []
    for n in range(stale.shape[1]):
        on = np.flatnonzero(stale[:, n])
        if on.size:
            cuts = np.split(on, np.flatnonzero(np.diff(on) > 1) + 1)
            spans += [f"p{n}[{c[0]}..{c[-1]}]" for c in cuts]
    print(f"TS{args.ts}: {stale.shape[0]} frames, "
          f"{int(stale.sum())} stale person-frames "
          f"({' '.join(spans) if spans else 'none'})")

    per_class = {}
    for c, name in names.items():
        sel = cls == c
        per_class[name] = {
            "frames": int(sel.sum()),
            "mean_jitter_mm": round(float(jmm[sel].mean()), 2)
            if sel.any() else None,
            "max_jitter_mm": round(float(jmm[sel].max()), 2)
            if sel.any() else None,
        }
    order = np.argsort(-jmm)[:args.top]
    print(f"{'t':>4} {'jitter_mm':>10}  class")
    for t in order:
        print(f"{t:>4} {jmm[t]:>10.1f}  {names[int(cls[t])]}")
    record = {"metric": "jitter_decomposition", "ts": args.ts,
              "per_class": per_class,
              "top": [[int(t), round(float(jmm[t]), 1), names[int(cls[t])]]
                      for t in order]}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

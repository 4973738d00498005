"""MuPoTs-3D evaluation driver: metrics tables + FinalResults files.

Port of `mhmocap_tpu/eval/mupots_eval.py` (numpy), the counterpart of
the reference `mhmocap/eval_mupots.py`: loops the
20 test sequences, reloads the prediction pickles, computes
{mm_abs_error, mm_rel_error, mm_mrpe, pck_rel (3DPCK@150mm), ap25_root
(AP@25cm), abs_jitter} on GT and `_univ` (scale := 1) variants,
aggregates with the per-sequence instance-count weights, and writes
FinalResults.json / FinalResults.md (eval_mupots.py:18-186).
"""

from __future__ import annotations

import copy
import json
import os
import pickle
from typing import Callable, Dict, List

import numpy as np

from .metrics import (masked_average_error, masked_average_pck,
                      pose_error_3dproj)

# Per-sequence instance counts used as weights for the "Avg." column
# (eval_mupots.py:94-100).
MUPOTS_NUM_INSTANCES = [
    402, 502, 802, 602, 522, 1082, 1293, 1102, 1002, 502, 2103, 730,
    1023, 1878, 2287, 1503, 1203, 378, 1293, 1503,
]


def compute_mm_pck_results(optvar: Dict, ref_poses3d, visibility,
                           smpl_joints_mupots_fn: Callable,
                           cam_K) -> Dict[str, float]:
    """One sequence's metric dict (eval_mupots.py:18-40)."""
    m = pose_error_3dproj(optvar, ref_poses3d, visibility,
                          smpl_joints_mupots_fn, cam_K)
    return {
        "mm_abs_error": 1000 * masked_average_error(
            m["abs_dist"], m["valid_joints"]),
        "mm_rel_error": 1000 * masked_average_error(
            m["rel_dist"], m["valid_joints"]),
        "mm_mrpe": 1000 * masked_average_error(
            m["abs_root_pos_err"], m["valid_root"]),
        "pck_rel": 100 * masked_average_pck(
            m["rel_dist"], m["valid_joints"], 0.15),
        "ap25_root": 100 * masked_average_pck(
            m["abs_root_pos_err"], m["valid_root"], 0.25),
        "abs_jitter": 1000 * masked_average_error(
            m["abs_jitter"], m["valid_joints"]),
    }


def write_results_as_markdown(results: Dict[str, List[float]],
                              labels: List[str], filename: str):
    """Markdown metric table (eval_mupots.py:43-68 format)."""
    lines = ["| |" + "".join(f" {s} |" for s in labels),
             "| :--: |" + " :--: |" * len(labels)]
    for key, vals in results.items():
        assert len(vals) == len(labels), (key, len(vals), len(labels))
        lines.append(f"| {key} |" + "".join(f" {v:.2f} |" for v in vals))
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")


def append_weighted_average(results: Dict[str, List[float]],
                            weights: List[int]):
    """Instance-count-weighted mean appended per metric
    (eval_mupots.py:71-79)."""
    w = np.asarray(weights, np.float64)
    for key, vals in results.items():
        assert len(vals) == len(weights)
        results[key].append(float(np.sum(np.asarray(vals) * w)
                                  / np.sum(w)))
    return results


def evaluate_mupots(
    input_path: str,
    smpl_joints_mupots_fn: Callable,
    cam_K_per_ts: Dict[int, np.ndarray],
    ts_ids=None,
    num_instances=None,
) -> Dict[str, List[float]]:
    """Evaluate all sequences from their output pickles and write the
    FinalResults files (eval_mupots.py:82-186)."""
    ts_ids = list(ts_ids if ts_ids is not None else range(1, 21))
    if num_instances is None:
        num_instances = [MUPOTS_NUM_INSTANCES[i - 1] for i in ts_ids]

    final: Dict[str, List[float]] = {}
    labels = []
    for ts_id in ts_ids:
        labels.append(f"TS{ts_id}")
        ts_path = os.path.join(input_path, f"TS{ts_id}")
        with open(os.path.join(ts_path, "mupots_annot.pkl"), "rb") as f:
            annot = pickle.load(f)
        with open(os.path.join(ts_path, "optvar_stage1.pkl"), "rb") as f:
            optvar_stage1 = pickle.load(f)
        # (The reference also loads optvar_init.pkl and computes its
        # _univ metrics, but the recording loop is dead code —
        # eval_mupots.py:167-168 assigns nkey and discards — so no
        # init rows ever reach FinalResults; we skip the wasted work.
        # Time-shared betas are broadcast inside pose_error_3dproj.)

        cam_K = cam_K_per_ts[ts_id]

        res = compute_mm_pck_results(
            optvar_stage1, annot["pose3d_gt"], annot["visibility"],
            smpl_joints_mupots_fn, cam_K)
        for key, val in res.items():
            final.setdefault(key, []).append(round(val, 2))

        # _univ variants: scale forced to 1 against universal GT
        stage1_univ = copy.deepcopy(optvar_stage1)
        stage1_univ["scale_factor"] = np.ones_like(
            stage1_univ["scale_factor"])
        res_u = compute_mm_pck_results(
            stage1_univ, annot["pose3d_univ_gt"], annot["visibility"],
            smpl_joints_mupots_fn, cam_K)
        for key, val in res_u.items():
            final.setdefault(key + "_univ", []).append(round(val, 2))

    labels.append("Avg.")
    final = append_weighted_average(final, num_instances)

    with open(os.path.join(input_path, "FinalResults.json"), "w") as f:
        json.dump({"final_results": final}, f)
    write_results_as_markdown(
        final, labels, os.path.join(input_path, "FinalResults.md"))
    return final

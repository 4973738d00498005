"""MuPoTs evaluation entry point.

Port of `mhmocap_tpu/eval_mupots.py`: loops TS1..TS20 under
--input_path, reloads the prediction pickles, and writes
FinalResults.json / FinalResults.md. The SMPL joint regression runs on
`--device`; the metrics are numpy.

Usage:
    python -m mhmocap_tpu_torch.eval_mupots \
        --configs_yml configs/eval_mupots.yml \
        --input_path ./output/mupots [--device cuda]
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

from .config import ConfigContext, parse_args, resolve_device
from .data import mupots
from .eval.mupots_eval import evaluate_mupots, MUPOTS_NUM_INSTANCES
from .models.loader import resolve_smpl_model
from .models.smpl import joints_function


def main(argv=None):
    """Evaluate every TS*/optvar_stage1.pkl under --input_path; returns
    the FinalResults dict (metric -> [TS..., weighted Avg.])."""
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(parsed)
    with ConfigContext(parsed):
        model = resolve_smpl_model(
            parsed.smpl["smpl_model_parameters_path"]).to(device)
        joints_fn = joints_function(model, "joints_mupots")

        data_path = parsed.data["data_path"]
        resize = parsed.resize_factor

        ts_ids = [i for i in range(1, 21) if os.path.exists(os.path.join(
            parsed.input_path, f"TS{i}", "optvar_stage1.pkl"))]
        if not ts_ids:
            raise FileNotFoundError(
                f"no TS*/optvar_stage1.pkl under {parsed.input_path}")

        cam_per_ts = {}
        for i in ts_ids:
            # the working-resolution intrinsics stored by predict_mupots,
            # else the dataset's intrinsics.txt rescaled
            annot_pkl = os.path.join(parsed.input_path, f"TS{i}",
                                     "mupots_annot.pkl")
            K = None
            if os.path.exists(annot_pkl):
                with open(annot_pkl, "rb") as f:
                    K = pickle.load(f).get("cam_K")
            if K is None:
                _, _, K = mupots.load_sequence_metadata(
                    os.path.join(data_path, f"TS{i}", "images"))
                K = resize * K
                K[2, 2] = 1.0
            cam_per_ts[i] = np.asarray(K, np.float32)

        final = evaluate_mupots(
            parsed.input_path, joints_fn, cam_per_ts, ts_ids=ts_ids,
            num_instances=[MUPOTS_NUM_INSTANCES[i - 1] for i in ts_ids])
        print("FinalResults written to", parsed.input_path)
        for k, v in final.items():
            print(f"  {k}: avg={v[-1]:.2f}")
    return final


if __name__ == "__main__":
    main()

"""MuPoTs prediction entry point.

Port of `mhmocap_tpu/predict_mupots.py`: ingests a MuPoTs sequence
(annot.mat / occlusion.mat / intrinsics.txt + the four input
modalities), runs the init solve and the stage-1 fit on `--device`, and
pickles `mupots_annot.pkl` next to `optvar_init.pkl` and
`optvar_stage1.pkl`. Without SMPL_NEUTRAL.pkl under the config's
`smpl_model_parameters_path` the synthetic body is used.

Usage:
    python -m mhmocap_tpu_torch.predict_mupots \
        --configs_yml configs/predict_mupots.yml --ts_id 1 \
        --output_path ./output/mupots [--device cuda]
"""

from __future__ import annotations

import os
import pickle
import sys

from .config import (ConfigContext, parse_args, require_device,
                     resolve_device)
from .data import mupots
from .data.ingestion import load_sequence
from .engine.predictor import Predictor
from .models.loader import resolve_smpl_model
from .models.smpl import joints_function


def build_mupots_sequence(
    data_path, ts_id, smpl_model_parameters_path,
    resize_factor=1.0, start_frame=0, end_frame=-1, step_frame=1,
    cam_K=None,
    use_hrnet_pose=True,
    joint_confidence_thr=0.49,
    depth_path="DPT_midas21_monodepth",
    erode_segmentation_iters=0,
    erode_backmask_iters=0,
    renormalize_depth=True,
    post_process_depth=True,
    filter_2dpose=True,
    filter_min_cutoff=0.01,
    filter_beta=25,
    lagged_conf_decay=1.0,
    id_swap_fix=0.0,
    device="cuda",
    timings=None,
    **_,
):
    """Ingest one MuPoTs TS sequence and its GT on `device`, the GPU
    unless the caller passes device="cpu". Returns (seq, model on
    `device`, pose3d_gt, pose3d_univ_gt, visibility)."""
    device = require_device(device)
    data_root = os.path.join(data_path, f"TS{ts_id}")
    annot, occl, cam_K_ts = mupots.load_sequence_metadata(
        os.path.join(data_root, "images"))
    if cam_K is None:
        cam_K = cam_K_ts

    end = annot.shape[0] if end_frame <= -1 else end_frame
    frame_ids = list(range(start_frame, end, step_frame))

    model = resolve_smpl_model(smpl_model_parameters_path).to(device)
    seq = load_sequence(
        data_root, joints_function(model, "joints_alphapose"),
        cam_K=cam_K,
        frame_ids=frame_ids,
        resize_factor=resize_factor,
        use_hrnet_pose=use_hrnet_pose,
        joint_confidence_thr=joint_confidence_thr,
        depth_path=depth_path,
        erode_segmentation_iters=erode_segmentation_iters,
        erode_backmask_iters=erode_backmask_iters,
        renormalize_depth=renormalize_depth,
        post_process_depth=post_process_depth,
        filter_2dpose=filter_2dpose,
        filter_min_cutoff=filter_min_cutoff,
        filter_beta=filter_beta,
        lagged_conf_decay=lagged_conf_decay,
        id_swap_fix=id_swap_fix,
        device=device,
        timings=timings,
    )
    pose3d_gt, pose3d_univ_gt, visibility = mupots.slice_ground_truth(
        annot, occl, frame_ids)
    return seq, model, pose3d_gt, pose3d_univ_gt, visibility


def main(argv=None):
    """Run one TS sequence. Returns a summary: the output directory,
    the ingestion seconds by phase, the Predictor's EngineConfig, the
    init-solve seconds, the timed cycle windows (when the config sets
    `bench_cycles`), the stage-1 loss parts per cycle and the seconds
    of each visualization export (when the config saves them)."""
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(parsed)
    with ConfigContext(parsed):
        kargs = dict(parsed.smpl)
        kargs.update(parsed.data)
        output_path = os.path.join(parsed.output_path,
                                   f"TS{parsed.ts_id}")
        print("Info: writing output to", output_path)

        timings = {}
        seq, model, p3d, p3d_univ, vis = build_mupots_sequence(
            ts_id=parsed.ts_id,
            resize_factor=parsed.resize_factor,
            erode_segmentation_iters=parsed.erode_segmentation_iters,
            erode_backmask_iters=parsed.erode_backmask_iters,
            renormalize_depth=parsed.renormalize_depth,
            post_process_depth=parsed.post_process_depth,
            device=device, timings=timings,
            **kargs)

        predictor = Predictor(seq, model, output_path=output_path,
                              parsed_args=parsed, device=device)
        result = predictor.run()

        with open(os.path.join(output_path, "mupots_annot.pkl"),
                  "wb") as f:
            pickle.dump({
                "pose3d_gt": p3d,
                "pose3d_univ_gt": p3d_univ,
                "visibility": vis,
                # the working-resolution intrinsics, so that evaluation
                # need not re-ingest the dataset
                "cam_K": seq.cam["K"],
            }, f)
    return {"output_path": output_path, "ingest_seconds": timings,
            "engine_config": predictor.cfg,
            "init_seconds": predictor.init_seconds,
            "cycle_seconds": predictor.bench_window_seconds,
            "stage1_log": result["stage1_log"],
            "export_seconds": predictor.export_seconds}


if __name__ == "__main__":
    main()

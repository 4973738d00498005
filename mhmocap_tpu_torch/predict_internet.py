"""Internet-video prediction entry point.

Port of `mhmocap_tpu/predict_internet.py`: the MuPoTs pipeline without
GT; the camera defaults to FOV=60 when no intrinsics are available.

Usage:
    python -m mhmocap_tpu_torch.predict_internet \
        --configs_yml configs/default.yml \
        --input_path ./data/input_video --output_path ./output/video \
        [--device cuda]
"""

from __future__ import annotations

import sys

from .config import ConfigContext, parse_args, resolve_device
from .data.ingestion import load_sequence
from .engine.predictor import Predictor
from .models.loader import resolve_smpl_model
from .models.smpl import joints_function


def build_internet_sequence(
    data_path, smpl_model_parameters_path, fov=60,
    resize_factor=1.0, start_frame=0, end_frame=-1, step_frame=1,
    use_hrnet_pose=True,
    joint_confidence_thr=0.49,
    depth_path="DPT_midas21_monodepth",
    smpl_pred_path="ROMP_Predictions",
    erode_segmentation_iters=0,
    erode_backmask_iters=0,
    renormalize_depth=True,
    post_process_depth=True,
    filter_2dpose=True,
    filter_min_cutoff=0.01,
    filter_beta=25,
    lagged_conf_decay=1.0,
    id_swap_fix=0.0,
    device="cpu",
    **_,
):
    """Ingest one video tree. Returns (seq, model on `device`)."""
    frame_ids = (list(range(start_frame, end_frame, step_frame))
                 if end_frame > -1 else None)
    model = resolve_smpl_model(smpl_model_parameters_path).to(device)
    seq = load_sequence(
        data_path, joints_function(model, "joints_alphapose"),
        cam_K=None, fov=fov,
        frame_ids=frame_ids,
        resize_factor=resize_factor,
        use_hrnet_pose=use_hrnet_pose,
        joint_confidence_thr=joint_confidence_thr,
        depth_path=depth_path,
        smpl_pred_path=smpl_pred_path,
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
    )
    return seq, model


def main(argv=None):
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(parsed)
    with ConfigContext(parsed):
        kargs = dict(parsed.smpl)
        kargs.update(parsed.data)
        print("Info: writing output to", parsed.output_path)

        seq, model = build_internet_sequence(
            resize_factor=parsed.resize_factor,
            erode_segmentation_iters=parsed.erode_segmentation_iters,
            erode_backmask_iters=parsed.erode_backmask_iters,
            renormalize_depth=parsed.renormalize_depth,
            post_process_depth=parsed.post_process_depth,
            device=device,
            **kargs)

        predictor = Predictor(seq, model,
                              output_path=parsed.output_path,
                              parsed_args=parsed, device=device)
        log = predictor.run()

        sv = log["stage1_optvar"]
        print("scale_factor", sv["scale_factor"].squeeze())
        print("min_z", sv["min_z"].squeeze())
        print("max_z", sv["max_z"].squeeze())


if __name__ == "__main__":
    main()

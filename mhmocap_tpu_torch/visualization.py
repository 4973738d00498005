"""Visualization entry point.

Port of `mhmocap_tpu/visualization.py`: reloads `optvar_stage1.pkl` and
`visualization_data_stage1.pkl`, bilateral-filters the scene depth,
runs SMPL again on `--device` to rebuild the vertices, and opens the
interactive 3D viewer (Open3D, when it is installed and a display is
set) or, headless, exports PLY geometry, the camera view and the
captures into `<input_path>/viz3d/`. The config's ARGS may set
`viz_mode` (scene | skeleton), `capture_rendered_color` and
`capture_rendered_depth`.

Usage:
    python -m mhmocap_tpu_torch.visualization \
        --configs_yml configs/predict_mupots.yml \
        --input_path ./output/mupots/TS1 [--device cuda]
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from .config import ConfigContext, parse_args, resolve_device
from .models.loader import resolve_smpl_model
from .models.smpl import smpl_forward
from .ops.image import bilateral_filter
from .viz import viewer3d
from .viz.viewer3d import SceneHumansVisualizer, SkeletonVisualizer


def main(argv=None):
    """Build the viewer of one output directory and run or export it.
    Returns the export directory (None after an interactive run)."""
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(parsed)
    with ConfigContext(parsed):
        base = parsed.input_path or parsed.output_path
        with open(os.path.join(base, "optvar_stage1.pkl"), "rb") as f:
            optvar = pickle.load(f)
        with open(os.path.join(base, "visualization_data_stage1.pkl"),
                  "rb") as f:
            vis_data = pickle.load(f)

        model = resolve_smpl_model(parsed.smpl["smpl_model_parameters_path"],
                                   device=device)

        # scene depth smoothing (reference visualization.py:906-908)
        scene_depth = optvar.get("scene_depth")
        if scene_depth is None:
            scene_depth = np.median(vis_data["depths"], axis=0)
        scene_depth = bilateral_filter(
            torch.as_tensor(scene_depth.astype(np.float32), device=device),
            d=9, sigma_color=0.05, sigma_space=25.0).cpu().numpy()
        scene_img = optvar.get("scene_img")
        if scene_img is None:
            scene_img = np.median(vis_data["images"], axis=0).astype(
                np.uint8)
        scene_mask = optvar.get("scene_mask")
        if scene_mask is None:
            scene_mask = np.ones(scene_depth.shape, np.float32)

        # rebuild the bodies from the optimized parameters
        T, N = optvar["poses_smpl"].shape[:2]
        with torch.no_grad():
            out = smpl_forward(
                model,
                torch.as_tensor(np.tile(optvar["betas_smpl"],
                                        (T, 1, 1)).reshape(-1, 10),
                                dtype=torch.float32, device=device),
                torch.as_tensor(optvar["poses_smpl"].reshape(-1, 72),
                                dtype=torch.float32, device=device))
        verts = (out["verts"].cpu().numpy().reshape(T, N, -1, 3)
                 * optvar["scale_factor"] + optvar["poses_T"])

        mode = getattr(parsed, "viz_mode", "scene") or "scene"
        cap_color = bool(getattr(parsed, "capture_rendered_color", False))
        cap_depth = bool(getattr(parsed, "capture_rendered_depth", False))
        capture_dir = os.path.join(base, "viz3d_frames")

        if mode == "skeleton":
            # the regressed MuPoTs joints
            joints = (out["joints_mupots"].cpu().numpy().reshape(T, N, -1, 3)
                      * optvar["scale_factor"] + optvar["poses_T"])
            vis15 = np.ones(joints.shape[:3] + (1,), np.float32)
            viewer = SkeletonVisualizer(vis_data["cam"], joints, vis15,
                                        output_path=capture_dir,
                                        capture_rendered_color=cap_color)
        else:
            viewer = SceneHumansVisualizer(
                scene_img, scene_depth, vis_data["cam"], vertices=verts,
                faces=model.faces.cpu().numpy(),
                valid_vertices=vis_data.get("valid"), scene_mask=scene_mask,
                output_path=capture_dir, capture_rendered_color=cap_color,
                capture_rendered_depth=cap_depth, show_coordinate_axis=False)
        if viewer3d.HAVE_OPEN3D and os.environ.get("DISPLAY"):
            viewer.run()
            return None
        out_dir = viewer.export(os.path.join(base, "viz3d"))
        print("Headless: 3D artifacts exported to", out_dir)
        return out_dir


if __name__ == "__main__":
    main()

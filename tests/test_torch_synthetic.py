"""The port's synthetic MuPoTs tree writer against the JAX package's:
the same call writes the same files (to float32 rounding of the two
SMPL forwards)."""

import glob
import json
import os

import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

from mhmocap_tpu.data.synthetic import generate_sequence as jax_generate
from mhmocap_tpu_torch import io as TIO
from mhmocap_tpu_torch.data.synthetic import generate_sequence

DEGRADED = {"crossing_paths": True, "id_switch_spans": [(2, 5)],
            "detection_dropout": 0.15, "romp_person_dropout": 0.2,
            "romp_missing_frames": 0.15, "enter_leave": True}


@pytest.fixture(scope="module", params=["clean", "degraded"])
def pair(request, tmp_path_factory):
    deg = DEGRADED if request.param == "degraded" else None
    kw = dict(num_frames=8, num_people=3, image_size=(96, 96), seed=11,
              num_vertices=512, mupots_gt=True, degradations=deg)
    roots = {}
    for name, fn in (("jax", jax_generate), ("torch", generate_sequence)):
        roots[name] = str(tmp_path_factory.mktemp(name))
        gt = fn(roots[name], **kw)
        roots[name + "_gt"] = gt
    return roots


def _files(root, sub, ext):
    return sorted(glob.glob(os.path.join(root, sub, "*" + ext)))


def test_same_tree_layout(pair):
    def rel(root):
        return sorted(os.path.relpath(p, root) for p in
                      glob.glob(os.path.join(root, "**", "*"),
                                recursive=True))
    assert rel(pair["torch"]) == rel(pair["jax"])


def test_alphapose_json_matches(pair):
    """Same detections (ids, frames, confidences, drop decisions); the
    keypoint positions are projected SMPL joints, 1e-3 px."""
    def load(root):
        with open(os.path.join(root, "AlphaPose",
                               "alphapose-results.json")) as f:
            return json.load(f)
    got, ref = load(pair["torch"]), load(pair["jax"])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k != "keypoints"} == \
            {k: v for k, v in r.items() if k != "keypoints"}
        gk = np.asarray(g["keypoints"]).reshape(-1, 3)
        rk = np.asarray(r["keypoints"]).reshape(-1, 3)
        np.testing.assert_array_equal(gk[:, 2], rk[:, 2])
        np.testing.assert_allclose(gk[:, :2], rk[:, :2], atol=1e-3, rtol=0)


def test_romp_npz_match(pair):
    """The ROMP files hold the same random draws and cams: exact."""
    for g, r in zip(_files(pair["torch"], "ROMP_Predictions", ".npz"),
                    _files(pair["jax"], "ROMP_Predictions", ".npz")):
        gd = np.load(g, allow_pickle=True)["results"].item()
        rd = np.load(r, allow_pickle=True)["results"].item()
        assert sorted(gd) == sorted(rd)
        for k in rd:
            assert gd[k].dtype == rd[k].dtype
            np.testing.assert_array_equal(gd[k], rd[k], err_msg=k)


def test_mupots_gt_matches(pair):
    """annot.mat joints (mm) from the two SMPL forwards to 1e-2 mm;
    occlusion labels and intrinsics.txt exact."""
    gi, ri = (os.path.join(pair[k], "images") for k in ("torch", "jax"))
    ga = sio.loadmat(os.path.join(gi, "annot.mat"))["annotations"]
    ra = sio.loadmat(os.path.join(ri, "annot.mat"))["annotations"]
    assert ga.shape == ra.shape
    for idx in np.ndindex(ra.shape):
        for f in ("annot3", "univ_annot3"):
            np.testing.assert_allclose(ga[idx][f][0, 0], ra[idx][f][0, 0],
                                       atol=1e-2, rtol=0)
    go = sio.loadmat(os.path.join(gi, "occlusion.mat"))["occlusion_labels"]
    ro = sio.loadmat(os.path.join(ri, "occlusion.mat"))["occlusion_labels"]
    for idx in np.ndindex(ro.shape):
        np.testing.assert_array_equal(go[idx], ro[idx])
    with open(os.path.join(gi, "intrinsics.txt")) as a, \
            open(os.path.join(ri, "intrinsics.txt")) as b:
        assert a.read() == b.read()


def test_images_and_maps_match(pair):
    """Decoded with PIL: the disparity PNGs within 1 level of 65535 (the
    z-buffer holds float32 depths of the two SMPL forwards); the
    instance masks and the JPEG files are identical on these fixtures (a
    vertex projected onto a pixel-rounding boundary in one package only
    would move one splat pixel; none does here)."""
    for sub, ext in (("DPT_large_monodepth", ".png"),
                     ("Mask2Former_Instances", ".png"), ("images", ".jpg")):
        gs, rs = _files(pair["torch"], sub, ext), _files(pair["jax"], sub, ext)
        assert len(gs) == len(rs) == 8
        for g, r in zip(gs, rs):
            ga = np.asarray(Image.open(g)).astype(np.int64)
            ra = np.asarray(Image.open(r)).astype(np.int64)
            assert ga.shape == ra.shape
            if sub == "DPT_large_monodepth":
                assert np.abs(ga - ra).max() <= 1, (g, np.abs(ga - ra).max())
                np.testing.assert_array_equal(TIO.read_png(g), ga)
            elif sub == "images":
                with open(g, "rb") as a, open(r, "rb") as b:
                    assert a.read() == b.read(), g
            else:
                np.testing.assert_array_equal(ga, ra, err_msg=g)


def test_returned_ground_truth_matches(pair):
    g, r = pair["torch_gt"], pair["jax_gt"]
    for k in ("cam_K", "poses_T", "poses_smpl", "betas", "scene_depth"):
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert g["image_size"] == r["image_size"]

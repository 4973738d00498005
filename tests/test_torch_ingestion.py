"""Parity of the port's on-disk ingestion (`load_sequence`) and its
device ops (disparity post-processing, label morphology, bidirectional
One-Euro, weak perspective) with mhmocap_tpu, on trees written by the
JAX package's synthetic writer (PIL images)."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import n, t, torch_model_of

from mhmocap_tpu.data import ingestion as JI
from mhmocap_tpu.data.synthetic import generate_sequence
from mhmocap_tpu.models.smpl import smpl_forward
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops import cameras as JC, image as JIm
from mhmocap_tpu.ops import one_euro as JO
from mhmocap_tpu_torch.data import ingestion as TI
from mhmocap_tpu_torch.models.smpl import joints_function
from mhmocap_tpu_torch.ops import cameras as TC, image as TIm
from mhmocap_tpu_torch.ops import morphology as TM, one_euro as TO

DEGRADED = {"crossing_paths": True, "id_switch_spans": [(2, 5)],
            "detection_dropout": 0.15, "romp_person_dropout": 0.2}
# TS3's plan of the degraded sweep tier (sweep.degradation_plan): ROMP
# drops people and, in 10% of the frames, every person
TS3_PLAN = {"romp_person_dropout": 0.2, "romp_missing_frames": 0.1}

# Arrays that go through no float op the two packages order differently
# (pose2d apart from the person-frames taken from the SMPL projection)
EXACT = ("lagged_tn", "instances", "seg_mask", "backmasks",
         "poses_smpl", "betas_smpl", "cam_smpl", "valid_smpl", "frame_ids")

# The frames are JPEGs written by PIL; the port's decoder uses a float
# IDCT where libjpeg uses its integer one (tests/test_torch_codecs.py).
# At resize_factor 0.5 the bicubic resize adds up to a level.
IMAGE_BOUND = {"max": 3, "mean": 0.05}
RESIZED_IMAGE_BOUND = {"max": 4, "mean": 0.3}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    model = make_synthetic_smpl(num_vertices=512, seed=3)
    out = {}
    for name, deg in (("clean", None), ("degraded", DEGRADED),
                      ("ts3", TS3_PLAN)):
        root = str(tmp_path_factory.mktemp(name))
        generate_sequence(root, num_frames=8, num_people=3,
                          image_size=(96, 96), model=model, seed=5,
                          mupots_gt=True, degradations=deg)
        out[name] = root
    return out, model


def _load_both(root, jm, **kw):
    jfn = jax.jit(lambda b, p: smpl_forward(jm, b, p)["joints_alphapose"])
    ref = JI.load_sequence(
        root, lambda b, p: np.asarray(jfn(jnp.asarray(b), jnp.asarray(p))),
        verbose=False, **kw)
    got = TI.load_sequence(
        root, joints_function(torch_model_of(jm), "joints_alphapose"),
        verbose=False, device="cpu", **kw)
    return ref, got


LOAD_KW = dict(resize_factor=1.0, post_process_depth=True,
               renormalize_depth=True, erode_segmentation_iters=3,
               erode_backmask_iters=5)


@pytest.mark.parametrize("tree,resize", [("clean", 1.0), ("degraded", 1.0),
                                         ("ts3", 1.0), ("clean", 0.5)])
def test_load_sequence_matches(trees, tree, resize):
    """The integer, label and bookkeeping arrays are exactly equal (on
    the ts3 tree, which holds an empty ROMP frame, that includes the
    nearest-valid SMPL rows imputed over it), and
    so are the 2D poses but for the person-frames whose lost track the
    assignment refreshed from the matched SMPL projection (all
    confidences 0.502): those come from the two packages' float32 SMPL
    forwards and agree to 1e-4 px. The Hungarian matches are the same
    (the SMPL arrays, reordered by them, are equal). The
    disparity maps agree to 1e-6 where both packages keep a pixel and
    differ on at most 0.5% of the pixels (a Sobel-gradient sum exactly
    at the outlier threshold may fall either side in float32; such a
    pixel takes its window median instead, |diff| <= 0.05). At
    resize_factor 0.5 the maps come from two bicubic implementations
    (PIL's on 16-bit integers, the port's in float32: 2e-2 of the
    normalized range) and are compared before post-processing, whose
    outlier threshold would amplify that difference. The images stay
    within the JPEG decoder's bound."""
    roots, jm = trees
    kw = dict(LOAD_KW, resize_factor=resize,
              post_process_depth=resize == 1.0)
    ref, got = _load_both(roots[tree], jm, **kw)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert got.pose2d.shape == ref.pose2d.shape
    assert got.pose2d.shape[1] == 3
    from_smpl = np.all(ref.pose2d[..., 2] == np.float32(0.502), axis=-1)
    np.testing.assert_array_equal(got.pose2d[~from_smpl],
                                  ref.pose2d[~from_smpl])
    np.testing.assert_allclose(got.pose2d[from_smpl], ref.pose2d[from_smpl],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.cam["K"], ref.cam["K"])
    assert got.cam["image_size"] == ref.cam["image_size"]
    assert got.cam["fov"] == pytest.approx(ref.cam["fov"], rel=1e-6)

    diff = np.abs(got.depths - ref.depths)
    if resize == 1.0:
        assert np.mean(diff > 1e-6) <= 5e-3, np.mean(diff > 1e-6)
        assert diff.max() <= 5e-2, diff.max()
    else:
        assert diff.max() <= 2e-2, diff.max()
    bound = IMAGE_BOUND if resize == 1.0 else RESIZED_IMAGE_BOUND
    d_img = np.abs(got.images.astype(int) - ref.images.astype(int))
    assert got.images.shape == ref.images.shape
    assert d_img.max() <= bound["max"] and d_img.mean() <= bound["mean"], \
        (d_img.max(), d_img.mean())


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_load_images_blocks_match_one_batch(trees, monkeypatch, resize):
    """Decoding and resizing IMAGE_BLOCK frames at a time (3 blocks of
    at most 3 frames here) gives exactly the frames of one block."""
    import glob
    import os
    paths = sorted(glob.glob(os.path.join(trees[0]["clean"], "images",
                                          "*.jpg")))
    whole = TI.load_images(paths, resize)
    monkeypatch.setattr(TI, "IMAGE_BLOCK", 3)
    blocked = TI.load_images(paths, resize)
    assert len(paths) == 8 and blocked.dtype == np.uint8
    np.testing.assert_array_equal(blocked, whole)


def test_degraded_tree_exercises_the_robust_paths(trees):
    """The degraded fixture really drops detections and ROMP rows, so
    the exact comparison above covers the lagged-track imputation and
    the nearest-valid-frame SMPL imputation."""
    roots, jm = trees
    _, got = _load_both(roots["degraded"], jm, **LOAD_KW)
    assert got.lagged_tn.any()
    assert (got.valid_smpl < 1.0).any()


def test_ts3_tree_has_an_empty_romp_frame(trees):
    """The ts3 fixture holds a frame whose ROMP file has no person, so
    every person of it is imputed from the nearest valid frame."""
    import glob
    import os
    from mhmocap_tpu_torch.data.romp import load_romp_prediction
    roots, jm = trees
    files = sorted(glob.glob(os.path.join(roots["ts3"], "ROMP_Predictions",
                                          "*.npz")))
    sizes = [len(load_romp_prediction(f)["cam"]) for f in files]
    assert 0 in sizes, sizes
    _, got = _load_both(roots["ts3"], jm, **LOAD_KW)
    empty = sizes.index(0)
    assert (got.valid_smpl[empty] < 1.0).all()


def test_filter_2dpose_matches(trees):
    """With the One-Euro smoothing on, the 2D poses agree to 1e-4 px."""
    roots, jm = trees
    ref, got = _load_both(roots["clean"], jm,
                          **dict(LOAD_KW, post_process_depth=False,
                                 filter_2dpose=True))
    np.testing.assert_allclose(got.pose2d, ref.pose2d, atol=1e-4, rtol=0)


def test_postprocess_dispmap_matches():
    """Batched disparity post-processing against the JAX per-frame
    function: all but 0.5% of the pixels to 1e-6, the rest within the
    window-median step of 0.05 (see test_load_sequence_matches)."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:40, 0:44]
    base = 0.3 + 0.5 * (yy / 40.0)
    disp = np.stack([base + 0.02 * rng.randn(40, 44) for _ in range(3)])
    disp[:, 10:25, 12:20] = 0.9
    disp = np.clip(disp, 0, 1).astype(np.float32)
    ref = np.stack([np.asarray(JIm.postprocess_dispmap(
        jnp.asarray(d), minz=1, maxz=100, fillin_ksize=7)) for d in disp])
    got = n(TIm.postprocess_dispmap(t(disp), minz=1, maxz=100,
                                    fillin_ksize=7))
    diff = np.abs(got - ref)
    assert np.mean(diff > 1e-6) <= 5e-3 and diff.max() <= 5e-2, \
        (np.mean(diff > 1e-6), diff.max())


@pytest.mark.parametrize("iters", [1, 3])
def test_label_morphology_matches_cv2(iters):
    """Grey-level 3x3 label erosion and dilation: exactly cv2's (the
    calls of the JAX ingestion), border pixels included."""
    rng = np.random.RandomState(iters)
    lab = np.zeros((30, 37), np.uint8)
    for k in range(1, 5):
        y, x = rng.randint(0, 25, 2)
        lab[y:y + 9, x:x + 12] = k
    lab[0, :5] = 7
    kernel = np.ones((3, 3))
    got_e = n(TM.erode_labels(torch.from_numpy(lab[None]), iters))[0]
    got_d = n(TM.dilate_labels(torch.from_numpy(lab[None]), iters))[0]
    np.testing.assert_array_equal(
        got_e, cv2.erode(lab, kernel, iterations=iters))
    np.testing.assert_array_equal(
        got_d, cv2.dilate(lab, kernel, iterations=iters))


def test_one_euro_bidirectional_matches():
    """Forward + backward ramp passes with a hold mask: 1e-5."""
    rng = np.random.RandomState(2)
    x = np.cumsum(0.01 * rng.randn(12, 6, 2), axis=0).astype(np.float32)
    valid = (rng.rand(12, 6, 2) > 0.2).astype(np.float32)
    ref = JO.one_euro_bidirectional(jnp.asarray(x), jnp.asarray(valid),
                                    min_cutoff=0.01, beta=25.0)
    got = TO.one_euro_bidirectional(t(x), t(valid), min_cutoff=0.01,
                                    beta=25.0)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5, rtol=0)


def test_weak_perspective_matches():
    rng = np.random.RandomState(4)
    p3d = rng.randn(5, 17, 3).astype(np.float32)
    cam = np.abs(rng.randn(5, 3)).astype(np.float32)
    ref = JC.weak_perspective_projection(jnp.asarray(p3d), jnp.asarray(cam),
                                         (96, 80))
    got = TC.weak_perspective_projection(t(p3d), t(cam), (96, 80))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-4, rtol=0)
    assert TC.fov_from_focal(96, 80.0) == JC.fov_from_focal(96, 80.0)


def test_ts3_stage1_cycles_match(trees, tmp_path):
    """TS3's plan under the robust knobs (id_swap_fix 0.5 at ingestion,
    gap_aware_temporal in the fit): the two packages' sequences are
    equal as above, and 3 stage-1 cycles from the JAX package's init
    params land where the JAX Predictor's do, to the tolerance of
    tests/test_torch_predictor.py (all entries within RMSprop's 3-step
    reach of 0.08, 99% within 5e-3)."""
    import dataclasses
    import os
    import pickle
    from test_torch_predictor import make_args
    from mhmocap_tpu.data.ingestion import SequenceArrays as JSeq
    from mhmocap_tpu.engine import optimizer as JE
    from mhmocap_tpu.engine import predictor as JPr
    from mhmocap_tpu_torch import convert
    from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
    from mhmocap_tpu_torch.engine import optimizer as TE
    from mhmocap_tpu_torch.engine import predictor as TPr
    roots, jm = trees
    ref, got = _load_both(roots["ts3"], jm, **dict(LOAD_KW, id_swap_fix=0.5))
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    args = make_args(gap_aware_temporal=True)
    jpred = JPr.Predictor(JSeq(**dataclasses.asdict(ref)), jm,
                          str(tmp_path / "jax"), args)
    jpred.run(verbose=False)

    def jax_init(model, *a, **k):
        jp, jh, opt_scale = JE.init_params(jm, *a[:4], jpred.cfg, **k)
        return (convert.params_from_numpy([np.asarray(x) for x in jp]),
                np.asarray(jh), opt_scale)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TE, "init_params", jax_init)
        TPr.Predictor(TSeq(**dataclasses.asdict(got)), torch_model_of(jm),
                      str(tmp_path / "torch"), args,
                      device="cpu").run(verbose=False)
    pk = {}
    for name in ("jax", "torch"):
        with open(os.path.join(str(tmp_path / name), "optvar_stage1.pkl"),
                  "rb") as fh:
            pk[name] = pickle.load(fh)
    assert set(pk["torch"]) == set(pk["jax"])
    for k, v in pk["jax"].items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            diff = np.abs(pk["torch"][k] - v)
            assert diff.max() <= 0.08, (k, diff.max())
            assert np.mean(diff <= 5e-3) >= 0.99, (k, np.mean(diff <= 5e-3))

"""The port's visualization exports (`viz/export.py`) against the JAX
package's: the same files by name and count, PNGs the port's reader
decodes at the expected size, and `visualization_data_stage1.pkl` with
the JAX keys, shapes and dtypes and its values (the pattern of
tests/test_viewer3d.py:172). Pixels are not compared: the JAX package
draws with matplotlib."""

import os
import pickle
import types

import numpy as np
import pytest

from torch_parity import torch_model_of

from mhmocap_tpu.engine import optimizer as JE
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops.cameras import intrinsics_from_fov
from mhmocap_tpu_torch.io import read_png
from mhmocap_tpu_torch.viz import export as TV

T, N, SIDE, V = 3, 2, 32, 256


def _inputs():
    rng = np.random.RandomState(0)

    class Seq(types.SimpleNamespace):
        def __len__(self):
            return T

    seq = Seq(
        images=rng.randint(0, 255, (T, SIDE, SIDE, 3)).astype(np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, SIDE, SIDE), 0.05,
                       1).astype(np.float32),
        backmasks=np.ones((T, SIDE, SIDE), np.float32),
        cam_smpl=np.zeros((T, N, 3), np.float32),
        valid_smpl=np.ones((T, N, 1), np.float32),
        cam={"K": intrinsics_from_fov((SIDE, SIDE), 60.0), "fov": 60.0,
             "Kd": None, "image_size": (SIDE, SIDE)})
    optvar = {
        "scale_factor": np.array([1.0, 1.05], np.float32).reshape(1, N, 1,
                                                                  1),
        "poses_T": (np.array([[-0.3, 0.3, 3.0], [0.4, 0.3, 3.5]])[None]
                    + 0.05 * rng.randn(T, N, 3)).reshape(
                        T, N, 1, 3).astype(np.float32),
        "poses_smpl": (0.1 * rng.randn(T, N, 72)).astype(np.float32),
        "betas_smpl": (0.3 * rng.randn(1, N, 10)).astype(np.float32),
        "min_z": np.full((T, 1, 1), 2.0, np.float32),
        "max_z": np.linspace(6, 8, T).reshape(T, 1, 1).astype(np.float32),
    }
    pose2d = np.concatenate(
        [SIDE * rng.rand(T, N, 17, 2),
         rng.choice([0.3, 0.9], (T, N, 17, 1))], -1).astype(np.float32)
    log = [{k: float(v) for k, v in zip(JE.LOG_KEYS, rng.rand(10) + 0.1)}
           for _ in range(4)]
    return seq, optvar, pose2d, log


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Both packages' exports of the same inputs (2 overlays a stage)."""
    from mhmocap_tpu.viz import export as JV
    jm = make_synthetic_smpl(num_vertices=V, seed=5)
    tm = torch_model_of(jm)
    seq, optvar, pose2d, log = _inputs()
    init_ov = dict(optvar, pose2d=pose2d)
    dirs = {}
    for name, mod, model in (("jax", JV, jm), ("torch", TV, tm)):
        d = str(tmp_path_factory.mktemp(name))
        mod.save_visualization_stage1(d, seq, model, optvar, pose2d, log,
                                      max_overlays=2)
        mod.save_visualization_init_data(d, seq, model, init_ov,
                                         np.array([1.0, 0.5, 0.2]),
                                         max_frames=2)
        dirs[name] = d
    return dirs


def _load(d):
    with open(os.path.join(d, "visualization_data_stage1.pkl"), "rb") as f:
        return pickle.load(f)


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_export_writes_the_jax_files(exports):
    assert _tree(exports["torch"]) == _tree(exports["jax"]) == [
        "fig_optim_curves_init.png", "fig_optim_curves_stage1.png",
        "vis_init/vis_0000.png", "vis_init/vis_0001.png",
        "vis_stage1/vis_0000.png", "vis_stage1/vis_0001.png",
        "visualization_data_stage1.pkl"]


@pytest.mark.parametrize("name,shape", [
    ("fig_optim_curves_init.png", (450, 1200, 3)),
    ("fig_optim_curves_stage1.png", (450, 1200, 3)),
    ("vis_init/vis_0001.png", (SIDE, 2 * SIDE, 3)),
    ("vis_stage1/vis_0001.png", (SIDE, 3 * SIDE, 3)),
])
def test_export_pngs_read_back(exports, name, shape):
    """Each PNG decodes with the port's reader at its size; the
    overlays keep the image where nothing is drawn, and the curves are
    drawn in more than the grid's colours."""
    img = read_png(os.path.join(exports["torch"], name))
    assert img.shape == shape and img.dtype == np.uint8
    if name.startswith("vis_"):
        seq = _inputs()[0]
        i = int(name[-8:-4])
        same = np.all(img[:, :SIDE] == seq.images[i], axis=-1)
        assert 0.2 < same.mean() < 1.0
    else:
        assert len(np.unique(img.reshape(-1, 3), axis=0)) > 3


def test_export_pickle_matches_jax(exports):
    """visualization_data_stage1.pkl: the JAX keys, shapes and dtypes;
    depths equal (the same float32 numpy arithmetic), vertices to 1e-5 m
    (the SMPL forward runs in another framework), the rest equal."""
    ref, got = _load(exports["jax"]), _load(exports["torch"])
    assert list(got) == list(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            continue
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k == "verts":
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["verts"].shape == (T, N, V, 3)
    assert got["depths"].shape == (T, SIDE, SIDE)


def test_clip_segments():
    """Liang-Barsky: inside kept, crossing cut at the border, outside,
    parallel-outside and non-finite segments dropped."""
    p0 = np.array([[1, 1], [-5, 5], [20, 20], [-3, 2], [np.nan, 0]], float)
    p1 = np.array([[4, 6], [15, 5], [30, 25], [-3, 8], [3, 3]], float)
    q0, q1 = TV.clip_segments(p0, p1, 10, 10)
    np.testing.assert_allclose(q0, [[1, 1], [0, 5]])
    np.testing.assert_allclose(q1, [[4, 6], [9, 5]])


def test_draw_lines_and_blend_points():
    img = np.zeros((8, 8, 3), np.uint8)
    TV.draw_lines(img, [(-4, 2)], [(20, 2)], (255, 0, 0))
    assert (img[2, :, 0] == 255).all() and img[:2].max() == 0 \
        and img[3:].max() == 0
    img = np.full((4, 4, 3), 100, np.uint8)
    TV.blend_points(img, [(1, 1), (1, 1), (2.4, 0.6), (9, 9)], (200,) * 3,
                    0.5)
    assert img[1, 1, 0] == 175 and img[1, 2, 0] == 150
    assert (img == 100).sum() == 14 * 3


def test_viridis_ends_and_non_finite():
    rgb = TV.viridis(np.array([[0.0, 1.0, np.inf]]))
    np.testing.assert_array_equal(rgb[0, 0], (68, 1, 84))
    np.testing.assert_array_equal(rgb[0, 1], (253, 231, 37))
    np.testing.assert_array_equal(rgb[0, 2], (68, 1, 84))

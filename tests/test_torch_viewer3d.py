"""Parity of the port's 3D viewer (viz/viewer3d.py) and visualization
entry point with mhmocap_tpu: PLY files, the geometry of the headless
captures (the projected point sets and the depth splat, exactly), file
names and PNG sizes, invalid-body parking, MuPoTs-15 gating, the Open3D
key map under the mock of tests/test_viewer3d_o3d_mock.py, and
`visualization.main` on one port-written output tree."""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from test_viewer3d import CUBE_FACES, _cube_verts
from test_viewer3d_o3d_mock import _fake_o3d
from torch_parity import torch_model_of

from mhmocap_tpu.ops.cameras import project_points as jax_project
from mhmocap_tpu.viz import viewer3d as JV
from mhmocap_tpu_torch.viz import viewer3d as TV


def _camera(side=32, dtype=np.float32):
    K = np.array([[side, 0, side / 2], [0, side, side / 2], [0, 0, 1]],
                 dtype)
    return {"K": K, "image_size": (side, side)}


def _scene_inputs(T=3, N=2):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (32, 32, 3)).astype(np.uint8)
    depth = (3.0 + rng.rand(32, 32)).astype(np.float32)
    mask = (rng.rand(32, 32) > 0.2).astype(np.float32)
    verts = np.stack([np.stack([_cube_verts([0.3 * n - 0.2, 0.1 * t, 2.0])
                                for n in range(N)]) for t in range(T)])
    valid = np.ones((T, N, 1), np.float32)
    valid[1, 0, 0] = 0.0
    return img, depth, mask, verts, valid


def _viewers(tmp_path, **kw):
    img, depth, mask, verts, valid = _scene_inputs()
    return [mod.SceneHumansVisualizer(
        img, depth, _camera(), vertices=verts, faces=CUBE_FACES,
        valid_vertices=valid, scene_mask=mask,
        output_path=str(tmp_path / f"cap_{name}"), verbose=False, **kw)
        for name, mod in (("jax", JV), ("torch", TV))]


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    rows = [ln.split() for ln in lines[end + 1:]]
    return (lines[:end + 1] + [len(r) for r in rows],
            [float(x) for r in rows for x in r])


def _assert_same_tree(ref_dir, got_dir, atol=2e-4, depth_mm=0):
    """The same files; PLY headers equal and values within atol; PNGs of
    the same size and mode, depth PNGs within depth_mm."""
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        a, b = os.path.join(ref_dir, name), os.path.join(got_dir, name)
        if name.endswith(".ply"):
            (ha, va), (hb, vb) = _read_ply(a), _read_ply(b)
            assert ha == hb, name
            if va:
                np.testing.assert_allclose(vb, va, atol=atol, rtol=0,
                                           err_msg=name)
        elif name.endswith(".png"):
            ia, ib = np.asarray(Image.open(a)), np.asarray(Image.open(b))
            assert ia.shape[:2] == ib.shape[:2], name
            assert ia.dtype == ib.dtype, name
            if name.startswith("depth_"):
                np.testing.assert_allclose(ib.astype(int), ia.astype(int),
                                           atol=depth_mm, rtol=0,
                                           err_msg=name)
    return names


def test_export_with_captures_matches(tmp_path):
    """export() with both capture flags: scene.ply, human_*.ply,
    img_/depth_ captures and camera_view_0000.png by the JAX package's
    names, PLY values within 2e-4 (%.4f text of float32 points), depth
    PNGs equal, colour PNGs of JAX's sizes (600 x 600 captures,
    960 x 960 camera view)."""
    jv, tv = _viewers(tmp_path, capture_rendered_color=True,
                      capture_rendered_depth=True)
    jd = jv.export(str(tmp_path / "jax"), max_frames=2)
    td = tv.export(str(tmp_path / "torch"), max_frames=2)
    names = _assert_same_tree(jd, td)
    assert {"scene.ply", "human_0001_1.ply", "img_000001.png",
            "depth_000001.png", "camera_view_0000.png"} <= set(names)
    assert Image.open(os.path.join(td, "img_000000.png")).size == (600, 600)
    assert Image.open(os.path.join(td, "camera_view_0000.png")).size == \
        (960, 960)
    d = np.asarray(Image.open(os.path.join(td, "depth_000000.png")))
    assert d.dtype == np.uint16 and 1900 in d and (d[d > 0] >= 1900).all()


def test_capture_geometry_matches(tmp_path, monkeypatch):
    """What each capture draws: the same points and colours, projected
    to the same pixels within 1e-4 px; the camera view's layers are the
    JAX package's scatter calls."""
    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", JV), ("torch", TV)):
        def record(self, points, colors, color, depth, extra_points=None,
                   _name=name):
            seen[_name].append((np.asarray(points), np.asarray(colors),
                                color, depth))
        monkeypatch.setattr(mod.BaseVisualizer, "_headless_capture", record)
    jv, tv = _viewers(tmp_path, capture_rendered_color=True,
                      capture_rendered_depth=True)
    for v in (jv, tv):
        v.capture_frame(0)
        v.capture_frame(1)
        v.step()
    assert len(seen["jax"]) == len(seen["torch"]) == 3
    K = _camera()["K"]
    for (pj, cj, *fj), (pt, ct, *ft) in zip(seen["jax"], seen["torch"]):
        assert fj == ft
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_allclose(
            TV.project_to_pixels(pt, K),
            np.asarray(jax_project(pj.astype(np.float32), K)), atol=1e-4)
    layers = tv.camera_view_layers(0)
    pts, cols = jv._scene_of(0)
    bodies = jv.frame_vertices(0)
    assert len(layers) == 1 + len(bodies)
    np.testing.assert_allclose(layers[0][0], np.asarray(jax_project(pts, K)),
                               atol=1e-4)
    for n, ((uv, c, alpha), b) in enumerate(zip(layers[1:], bodies)):
        np.testing.assert_allclose(uv, np.asarray(jax_project(
            b.astype(np.float32), K)), atol=1e-4)
        np.testing.assert_array_equal(c, JV.DEFAULT_VIS_COLORS[n])
        assert alpha == 0.5


@pytest.mark.parametrize("kdtype", [np.float32, np.float64])
def test_splat_depth_matches_exactly(kdtype):
    """The z-buffer splat equals the JAX package's bit for bit: points
    behind the camera dropped, truncation before the clip, nearest
    wins on shared pixels."""
    rng = np.random.RandomState(1)
    pts = np.concatenate([
        rng.uniform(-2, 2, (4000, 2)), rng.uniform(-0.5, 6, (4000, 1))],
        -1).astype(np.float32)
    pts[:50, 2] = 0.0
    K = _camera(40, kdtype)["K"]
    got = TV.splat_depth(pts, K, (40, 30))
    ref = JV.splat_depth(pts, K, (40, 30))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert TV.splat_depth(np.zeros((0, 3), np.float32), K, (8, 6)).shape \
        == (6, 8)


def test_invalid_bodies_parked_and_per_frame_scenes(tmp_path):
    """Invalid bodies sit at (0, 0, -1) as in JAX; per-frame scenes give
    the JAX package's point clouds."""
    jv, tv = _viewers(tmp_path)
    for t in range(3):
        for a, b in zip(tv.frame_vertices(t), jv.frame_vertices(t)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.frame_vertices(1)[0],
                                  np.tile([[0, 0, -1.0]], (8, 1)))
    imgs = np.stack([np.full((32, 32, 3), 50 * (t + 1), np.uint8)
                     for t in range(3)])
    depths = np.stack([np.full((32, 32), 2.0 + t, np.float32)
                       for t in range(3)])
    js, ts = (mod.SceneHumansVisualizer(imgs, depths, _camera(),
                                        verbose=False) for mod in (JV, TV))
    assert ts.multiple_scenes and ts.max_frames == 3
    for t in range(3):
        np.testing.assert_allclose(ts._scene_of(t)[0], js._scene_of(t)[0],
                                   atol=1e-6)
        np.testing.assert_array_equal(ts._scene_of(t)[1], js._scene_of(t)[1])
    with pytest.raises(ValueError, match="Invalid"):
        TV.SceneHumansVisualizer(imgs[0], depths, _camera())


@pytest.mark.parametrize("thr", [0.05, 0.5])
def test_mupots15_gating_matches(thr):
    rng = np.random.RandomState(int(thr * 100))
    for _ in range(5):
        pose = rng.randn(17, 3).astype(np.float32)
        vis = rng.choice([0.0, 0.3, 0.9], (17, 1)).astype(np.float32)
        for a, b in zip(TV.mupots15_pose_arrays(pose, vis, thr),
                        JV.mupots15_pose_arrays(pose, vis, thr)):
            np.testing.assert_array_equal(a, b)


def test_skeleton_visualizer_matches(tmp_path):
    """Skeleton exports with colour captures, and the GT overlay through
    the match list: the same skeletons, files and PLY values."""
    T, N = 2, 2
    rng = np.random.RandomState(0)
    pred = rng.uniform(-0.5, 0.5, (T, N, 17, 3)).astype(np.float32)
    pred[..., 2] += 3.0
    vis = rng.choice([0.2, 1.0], (T, N, 17, 1), p=[0.2, 0.8]).astype(
        np.float32)
    gt = pred + 0.1
    match = [(np.array([1, 0]), np.array([0, 1]))] * T
    dirs = {}
    for name, mod in (("jax", JV), ("torch", TV)):
        sk = mod.SkeletonVisualizer(_camera(), pred, vis, pose_gt=gt,
                                    gt_vis=vis, match_list=match,
                                    output_path=str(tmp_path / name),
                                    capture_rendered_color=True)
        dirs[name] = (sk, sk.export(str(tmp_path / f"out_{name}")))
    (js, jd), (ts, td) = dirs["jax"], dirs["torch"]
    for fj, ft in zip(js.frames, ts.frames):
        assert len(fj) == len(ft) == 4
        for a, b in zip(fj, ft):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
    names = _assert_same_tree(jd, td)
    assert "skeleton_0001.ply" in names and "img_000001.png" in names
    with pytest.raises(ValueError, match="match list"):
        TV.SkeletonVisualizer(_camera(), pred, vis, pose_gt=gt, gt_vis=vis)


def test_renderoption_and_run_without_open3d(tmp_path):
    """The shipped RenderOption JSON and write_default_renderoption equal
    the JAX package's; without open3d, run() raises as JAX's does."""
    with open(TV.RENDEROPTION_PATH) as f, open(JV.RENDEROPTION_PATH) as g:
        assert json.load(f) == json.load(g)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    TV.write_default_renderoption(a)
    JV.write_default_renderoption(b)
    assert open(a).read() == open(b).read()
    if not TV.HAVE_OPEN3D:
        tv = _viewers(tmp_path)[1]
        with pytest.raises(RuntimeError, match="Open3D is not installed"):
            tv.run()


@pytest.fixture
def o3d_mock(monkeypatch):
    created = []
    monkeypatch.setattr(TV, "o3d", _fake_o3d(created))
    monkeypatch.setattr(TV, "HAVE_OPEN3D", True)
    return created


def test_o3d_key_map_and_callbacks(tmp_path, o3d_mock):
    """run() under the mock: the full key map N/U/R/J/L/I/K/W/S/A/D/X/C,
    N steps and updates both meshes, the view control gets the
    rotations and translations (C translates -z), U sets the window-
    scaled real intrinsics and FLIP_YZ, R loads the RenderOption, and N
    writes Open3D's buffers as img_ uint8 and depth_ uint16 mm."""
    tv = _viewers(tmp_path, capture_rendered_color=True,
                  capture_rendered_depth=True)[1]
    os.makedirs(tv.output_path, exist_ok=True)
    tv.run()
    vis = o3d_mock[0]
    assert vis.ran and vis.destroyed
    assert set("NURJLIKWSADXC") <= set(vis.callbacks)
    assert vis.callbacks["N"](vis) is True and tv.curr_frame == 1
    assert len(vis.updated) >= 2
    for key in "JIWC":
        vis.callbacks[key](vis)
    assert vis.ctr.rotations == [(1, 0), (0, 1)]
    assert vis.ctr.translations == [(0.01, 0, 0), (0, 0, -0.01)]
    assert vis.callbacks["U"](vis) is False
    w, h, fx, fy, cx, cy = vis.ctr.params_in.intrinsic.set
    np.testing.assert_allclose((w, h, fx, fy, cx, cy),
                               (640, 480, 640, 480, 319.5, 239.5))
    np.testing.assert_array_equal(vis.ctr.params_in.extrinsic, TV.FLIP_YZ)
    assert vis.callbacks["R"](vis) is False
    assert vis.ro.loaded == TV.RENDEROPTION_PATH
    img = np.asarray(Image.open(os.path.join(tv.output_path,
                                             "img_000000.png")))
    dep = np.asarray(Image.open(os.path.join(tv.output_path,
                                             "depth_000000.png")))
    assert img.dtype == np.uint8 and img[0, 0, 0] == 127
    assert dep.dtype == np.uint16 and dep[0, 0] == 2500
    assert tv.curr_image_index == 1


def test_o3d_skeleton_run(tmp_path, o3d_mock):
    T, N = 2, 2
    pred = np.zeros((T, N, 17, 3), np.float32)
    pred[..., 2] = 3.0
    sk = TV.SkeletonVisualizer(_camera(), pred,
                               np.ones((T, N, 17, 1), np.float32),
                               output_path=str(tmp_path / "cap"),
                               capture_rendered_color=True)
    os.makedirs(sk.output_path, exist_ok=True)
    sk.run()
    fake = o3d_mock[0]
    assert fake.ran and fake.destroyed and set("NUR") <= set(fake.callbacks)
    assert fake.callbacks["N"](fake) is True
    assert os.path.exists(os.path.join(sk.output_path, "img_000000.png"))
    assert any(g.last_translate[1] is False for g in fake.geometries
               if getattr(g, "last_translate", None) is not None)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """A port-written output tree: a 3-cycle Predictor.run with the
    visualizations on (optvar_stage1.pkl, visualization_data_stage1.pkl),
    and a config whose ARGS turn both captures on."""
    from test_torch_engine import seq_arrays
    from test_torch_predictor import make_args
    from mhmocap_tpu.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.config import dump_yaml
    from mhmocap_tpu_torch.data.ingestion import SequenceArrays as TSeq
    from mhmocap_tpu_torch.engine import predictor as TPr
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    root = tmp_path_factory.mktemp("tree")
    out = str(root / "TS1")
    TPr.Predictor(TSeq(**seq_arrays(jm, T=6)), torch_model_of(jm), out,
                  make_args(save_visualizations=True),
                  device="cpu").run(verbose=False)
    cfgs = {}
    for mode in ("scene", "skeleton"):
        cfgs[mode] = str(root / f"vis_{mode}.yml")
        with open(cfgs[mode], "w") as f:
            f.write(dump_yaml({
                "ARGS": {"viz_mode": mode, "capture_rendered_color": True,
                         "capture_rendered_depth": True},
                "smpl": {"smpl_model_parameters_path": str(root / "none")}}))
    return jm, out, cfgs


@pytest.mark.parametrize("mode", ["scene", "skeleton"])
def test_visualization_main_matches(port_tree, tmp_path, monkeypatch, mode):
    """visualization.main of both packages on copies of one port-written
    tree (the body passed in for the config's SMPL path): the same
    viz3d file set, PLY values within 2e-4, PNG sizes equal, depth
    captures within 1 mm (the bilateral-filtered scene depth differs in
    its last bits, which the truncation to millimetres can show)."""
    from mhmocap_tpu import visualization as JVis
    from mhmocap_tpu_torch import visualization as TVis
    jm, tree, cfgs = port_tree
    tm = torch_model_of(jm)
    monkeypatch.setattr(JVis, "resolve_smpl_model", lambda path: jm)
    monkeypatch.setattr(TVis, "resolve_smpl_model",
                        lambda path, device="cpu": tm.to(device))
    dirs = {}
    for name, mod, extra in (("jax", JVis, []),
                             ("torch", TVis, ["--device", "cpu"])):
        d = str(tmp_path / name)
        shutil.copytree(tree, d)
        mod.main(["--configs_yml", cfgs[mode], "--input_path", d] + extra)
        dirs[name] = os.path.join(d, "viz3d")
    names = _assert_same_tree(dirs["jax"], dirs["torch"], depth_mm=1)
    first = "scene.ply" if mode == "scene" else "skeleton_0000.ply"
    assert first in names and "img_000000.png" in names
    if mode == "scene":
        assert "depth_000005.png" in names and "human_0005_1.ply" in names

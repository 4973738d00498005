"""The port runs without JAX and without the JAX package's host-side
dependencies (PyYAML, PIL, OpenCV, matplotlib, ...), and keeps float32
matmuls and convolutions out of TF32."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "yaml", "PIL", "cv2", "matplotlib", "optax",
           "flax", "orbax", "mhmocap_tpu")

SCRIPT = textwrap.dedent("""
    import importlib.abc, sys, tempfile, types
    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked for this test: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(2)
    import mhmocap_tpu_torch
    from mhmocap_tpu_torch import (bench, bench_e2e, bench_multicycle,
                                   config, convert, decompose_jitter,
                                   diff_final_results,
                                   eval_mupots, io, predict_internet,
                                   predict_mupots, predict_mupots_sweep,
                                   profile_cycle, raster_ablation,
                                   rounding_spread, sweep, visualization,
                                   workload)
    from mhmocap_tpu_torch.data import (alphapose, assignment, ingestion,
                                        mupots, romp, utils)
    from mhmocap_tpu_torch.data import synthetic as synthetic_tree
    from mhmocap_tpu_torch.engine import (cycle_graph, fhsog, gapfill,
                                          losses, optimizer as E, predictor,
                                          scene)
    from mhmocap_tpu_torch.eval import metrics, mupots_eval
    from mhmocap_tpu_torch.models import loader, smpl, synthetic
    from mhmocap_tpu_torch.ops import (cameras, image, morphology, one_euro,
                                       raster_cuda, rasterizer)
    from mhmocap_tpu_torch.parallel import ranks, spmd
    from mhmocap_tpu_torch.viz import export, viewer3d
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # the JAX io module's helpers and the Predictor module's io_mkdir,
    # PNG and JPEG written without PIL
    import os
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        io.io_mkdir(os.path.join(tmp, "a", "b"))
        predictor.io_mkdir(os.path.join(tmp, "a", "c"))
        img = np.linspace(0.0, 1.0, 16 * 24 * 3).reshape(16, 24, 3)
        for name in ("a/b/x.png", "a/c/x.jpg"):
            io.save_image(img, os.path.join(tmp, name))
        assert np.array_equal(io.read_png(os.path.join(tmp, "a/b/x.png")),
                              (255.9 * img).astype(np.uint8))
        assert io.read_jpeg(os.path.join(tmp, "a/c/x.jpg")).shape == \
            img.shape

    model = synthetic.make_synthetic_smpl(num_vertices=512, seed=1)
    out = smpl.smpl_forward(model, torch.zeros((2, 10)),
                            0.1 * torch.randn(2, 72),
                            torch.tensor([[0.0, 0.3, 3.0]] * 2))
    r = rasterizer.rasterize_bodies(
        out["verts"], model.faces,
        torch.as_tensor(cameras.intrinsics_from_fov((48, 48), 60.0)),
        rasterizer.RasterSettings(image_size=(48, 48), window=32))
    assert torch.isfinite(r["sil"]).all()

    # FHSOG on a 32x40 frame: the full-frame raster, GDFs, carving
    v2 = out["verts"].reshape(1, 2, -1, 3)
    K2 = torch.as_tensor(cameras.intrinsics_from_fov((40, 32), 60.0))
    fog, tex, outmask, masks, gdfs = fhsog.build_fhsog_from_smpl(
        torch.full((1, 32, 40), 5.0), torch.zeros((1, 32, 40, 3)),
        torch.ones((1, 32, 40)), v2, model.faces, K2, 1.0, 16.0,
        num_depth_bins=8)
    assert fog.shape == (8, 32, 40) and masks.any() and fog.sum() > 0
    carved = fhsog.carve_fog_with_meshes(fog, v2[0], model.faces, 2.0, 4.0,
                                         K2)
    assert carved.shape == fog.shape

    seq, _ = workload.make_ts1_like_seq(T=6, N=2, side=64, model=model)
    args = types.SimpleNamespace(
        num_iter=1, verbose=False, proj2d_loss_coef=1.0,
        depth_loss_coef=0.05, silhouette_loss_coef=0.1,
        reg_poses_coef=0.002, reg_scales_coef=1e-4,
        reg_velocity_coef=0.05, reg_verts_filter_coef=0.002,
        reg_contact_coef=0.001, reg_foot_sliding_coef=0.01,
        raster_window=32)
    with tempfile.TemporaryDirectory() as tmp:
        pred = predictor.Predictor(seq, model, tmp, args, device="cpu")
        pred.run(verbose=False)
    # the port's bench on a tiny workload: bench.py's line
    bench.make_ts1_like_seq = lambda T, N, side: workload.make_ts1_like_seq(
        T, N, side, model=model)
    bench.T, bench.N, bench.SIDE, bench.WINDOW = 6, 2, 64, 32
    bench.BENCH_CYCLES = (1, 2, 3)
    res = bench.main(["--device", "cpu"])
    assert res["metric"] == "production_frame_cycles_per_sec"
    assert len(res["secondary"]["window_frame_cycles_per_sec"]) == 2
    cfg = E.EngineConfig(**{{**pred.cfg.__dict__, "warmup_cycles": 0,
                             "update_filters_every": 1}})
    data = E.prepare_seq_data(seq, cfg)
    params = pred._params
    aux = E.init_aux(cfg, model.num_vertices, params.betas.detach())
    aux0 = aux
    params1, st, aux, loss, parts = E.stage1_cycle_fused(
        params, E.rmsprop_init(params), aux0, 0, pred.model, data,
        E.default_coefs(), cfg)
    assert aux.have_scene and aux.have_filters
    assert torch.isfinite(loss) and torch.isfinite(parts).all()

    # the same cycle sharded over a world of one rank (gloo, file
    # rendezvous): the halo comes from the rank itself and is masked
    with tempfile.TemporaryDirectory() as tmp:
        mesh = spmd.init_time_mesh("gloo", "cpu", "file://" + tmp + "/rdzv",
                                   0, 1)
        try:
            _, _, saux, sloss, sparts = spmd.spmd_stage1_cycle_fused(
                spmd.shard_params(params, mesh),
                spmd.shard_opt_state(E.rmsprop_init(params), mesh),
                spmd.shard_aux(aux0, mesh), 0, pred.model,
                spmd.shard_data(data, mesh), E.default_coefs(), cfg, mesh)
        finally:
            torch.distributed.destroy_process_group()
    assert saux.have_scene and saux.have_filters
    assert torch.allclose(sloss, loss, rtol=1e-5), (sloss, loss)
    assert torch.allclose(sparts, parts, rtol=1e-5, atol=1e-8)

    # the entry points on a port-written tree: JPEG/PNG/YAML without
    # PIL, OpenCV or PyYAML, with the robust profile and the
    # visualizations (no matplotlib)
    import json, os, shutil
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_tree.generate_sequence(
            os.path.join(tmp, "data", "TS1"), num_frames=5, num_people=2,
            image_size=(64, 64), model=model, seed=3, mupots_gt=True)
        cfg = sweep.write_config(os.path.join(tmp, "p.yml"),
                                 sweep.sweep_config(
                                     os.path.join(tmp, "data"), 2,
                                     raster_window=32,
                                     post_process_depth=True,
                                     gap_aware_temporal=True,
                                     gap_interpolate=True,
                                     save_visualizations=True))
        predict_mupots.resolve_smpl_model = lambda path: model
        eval_mupots.resolve_smpl_model = lambda path: model
        out = os.path.join(tmp, "out")
        predict_mupots.main(["--configs_yml", cfg, "--ts_id", "1",
                             "--output_path", out, "--device", "cpu"])
        eval_mupots.main(["--configs_yml", cfg, "--input_path", out,
                          "--device", "cpu"])
        names = sorted(os.listdir(os.path.join(out, "TS1")))
        assert names == ["fig_optim_curves_init.png",
                         "fig_optim_curves_stage1.png", "mupots_annot.pkl",
                         "optvar_init.pkl", "optvar_stage1.pkl", "vis_init",
                         "vis_stage1", "visualization_data_stage1.pkl"], names
        with open(os.path.join(out, "FinalResults.json")) as f:
            final = json.load(f)["final_results"]
        assert all(v == v for vals in final.values() for v in vals), final
        assert os.path.exists(os.path.join(out, "FinalResults.md"))

        # the visualization entry point on that tree, both modes, with
        # the color and depth captures (PNG writer, no PIL/matplotlib)
        visualization.resolve_smpl_model = lambda path, device="cpu": model
        for mode in ("scene", "skeleton"):
            vcfg = sweep.write_config(os.path.join(tmp, mode + ".yml"), {{
                "ARGS": {{"viz_mode": mode, "capture_rendered_color": True,
                          "capture_rendered_depth": True}},
                "smpl": {{"smpl_model_parameters_path": "/nonexistent"}}}})
            viz = visualization.main(["--configs_yml", vcfg, "--input_path",
                                      os.path.join(out, "TS1"), "--device",
                                      "cpu"])
            names = set(os.listdir(viz))
            assert "img_000000.png" in names, names
            assert ("scene.ply" in names) == (mode == "scene"), names
            shutil.rmtree(viz)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("PORT-OK")
""")


def test_port_runs_without_jax_and_host_deps():
    """Import every port module and run SMPL, the raster, the FHSOG build
    and carve, a tiny Predictor.run, the bench's main on a tiny
    workload, a cycle with the scene and filter
    refreshes (and the same cycle sharded over one gloo rank), and predict_mupots (with gap_aware_temporal,
    gap_interpolate and save_visualizations) + eval_mupots +
    visualization (both modes, with captures) on a port-written tree
    with --device cpu, in a fresh interpreter where jax, yaml, PIL, cv2,
    matplotlib, optax, flax, orbax and mhmocap_tpu cannot be
    imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PORT-OK" in res.stdout


@pytest.mark.parametrize("mode", ["scene", "skeleton"])
def test_visualization_needs_a_gpu_unless_device_cpu(tmp_path, mode):
    """visualization.main without --device runs on the card: without
    one it raises, naming --device cpu, before it reads or writes
    anything."""
    import torch
    from mhmocap_tpu_torch import visualization
    from mhmocap_tpu_torch.config import dump_yaml
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = tmp_path / "vis.yml"
    cfg.write_text(dump_yaml({"ARGS": {"viz_mode": mode},
                              "smpl": {"smpl_model_parameters_path": "x"}}))
    tree = tmp_path / "tree"
    tree.mkdir()
    with pytest.raises(RuntimeError, match="--device cpu"):
        visualization.main(["--configs_yml", str(cfg), "--input_path",
                            str(tree)])
    assert not os.listdir(tree)


def test_tf32_off_after_import():
    import torch
    import mhmocap_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_profile_cycle_needs_cuda():
    """The cycle profiler measures the card: without one it raises
    before it builds anything, and never profiles the CPU instead."""
    import torch
    from mhmocap_tpu_torch import profile_cycle
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_cycle.main(["--warm", "0", "--timed", "1", "--profiled", "1"])

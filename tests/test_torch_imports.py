"""The port runs without JAX and without the JAX package's host-side
dependencies, and keeps float32 matmuls and convolutions out of TF32."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "yaml", "PIL", "matplotlib", "optax", "flax",
           "orbax", "mhmocap_tpu")

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
    from mhmocap_tpu_torch import convert, profile_cycle, workload
    from mhmocap_tpu_torch.engine import optimizer as E, predictor, scene
    from mhmocap_tpu_torch.models import loader, smpl, synthetic
    from mhmocap_tpu_torch.ops import (cameras, image, morphology, one_euro,
                                       raster_cuda, rasterizer)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    model = synthetic.make_synthetic_smpl(num_vertices=512, seed=1)
    out = smpl.smpl_forward(model, torch.zeros((2, 10)),
                            0.1 * torch.randn(2, 72),
                            torch.tensor([[0.0, 0.3, 3.0]] * 2))
    r = rasterizer.rasterize_bodies(
        out["verts"], model.faces,
        torch.as_tensor(cameras.intrinsics_from_fov((48, 48), 60.0)),
        rasterizer.RasterSettings(image_size=(48, 48), window=32))
    assert torch.isfinite(r["sil"]).all()

    seq, _ = workload.make_ts1_like_seq(T=6, N=2, side=64, model=model)
    args = types.SimpleNamespace(
        num_iter=1, verbose=False, proj2d_loss_coef=1.0,
        depth_loss_coef=0.05, silhouette_loss_coef=0.1,
        reg_poses_coef=0.002, reg_scales_coef=1e-4,
        reg_velocity_coef=0.05, reg_verts_filter_coef=0.002,
        reg_contact_coef=0.001, reg_foot_sliding_coef=0.01,
        raster_window=32)
    with tempfile.TemporaryDirectory() as tmp:
        pred = predictor.Predictor(seq, model, tmp, args)
        pred.run(verbose=False)
    cfg = E.EngineConfig(**{{**pred.cfg.__dict__, "warmup_cycles": 0,
                             "update_filters_every": 1}})
    data = E.prepare_seq_data(seq, cfg)
    params = pred._params
    aux = E.init_aux(cfg, model.num_vertices, params.betas.detach())
    params, st, aux, loss, parts = E.stage1_cycle_fused(
        params, E.rmsprop_init(params), aux, 0, pred.model, data,
        E.default_coefs(), cfg)
    assert aux.have_scene and aux.have_filters
    assert torch.isfinite(loss) and torch.isfinite(parts).all()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("PORT-OK")
""")


def test_port_runs_without_jax_and_host_deps():
    """Import every port module and run SMPL, the raster, a tiny
    Predictor.run and a cycle with the scene and filter refreshes, in a
    fresh interpreter where jax, yaml, PIL, matplotlib, optax, flax,
    orbax and mhmocap_tpu cannot be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PORT-OK" in res.stdout


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

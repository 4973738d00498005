"""Parity of the port's SMPL model and synthetic body with mhmocap_tpu."""

import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import jax_model_arrays, n, t, torch_model_of

from mhmocap_tpu.models import loader as JL, smpl as JS
from mhmocap_tpu.models.synthetic import make_synthetic_smpl as jax_synth
from mhmocap_tpu_torch.models import loader as TL, smpl as TS
from mhmocap_tpu_torch.models.synthetic import (make_synthetic_smpl,
                                                 synthetic_smpl_arrays)


@pytest.mark.parametrize("num_vertices", [512, 6890])
def test_synthetic_builder_identical(num_vertices):
    """Same seed and size -> exactly the JAX builder's arrays (both draw
    from one numpy RandomState in the same order)."""
    ref = jax_model_arrays(jax_synth(num_vertices=num_vertices, seed=3))
    got = synthetic_smpl_arrays(num_vertices, seed=3)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    model = make_synthetic_smpl(num_vertices, seed=3)
    assert model.num_faces == ref["faces"].shape[0]
    assert model.parents == tuple(int(p) for p in ref["parents"])


def test_synthetic_builder_face_count_option():
    ref = jax_model_arrays(jax_synth(num_vertices=512, num_faces=2000,
                                     seed=0, with_aux_regressors=False))
    got = synthetic_smpl_arrays(512, num_faces=2000, seed=0,
                                with_aux_regressors=False)
    np.testing.assert_array_equal(got["faces"], ref["faces"])
    assert got["j_reg_mupots"] is None and ref["j_reg_mupots"] is None


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synth(num_vertices=512, seed=1)
    rng = np.random.RandomState(5)
    return dict(jm=jm, tm=torch_model_of(jm),
                betas=(0.5 * rng.randn(4, 10)).astype(np.float32),
                poses=(0.3 * rng.randn(4, 72)).astype(np.float32),
                transl=rng.randn(4, 3).astype(np.float32))


def test_smpl_forward_matches(bodies):
    """Every output key to 1e-5 abs: float32 contractions (TF32 off)
    whose summation order differs from XLA's."""
    b = bodies
    ref = JS.smpl_forward(b["jm"], jnp.asarray(b["betas"]),
                          jnp.asarray(b["poses"]), jnp.asarray(b["transl"]))
    got = TS.smpl_forward(b["tm"], t(b["betas"]), t(b["poses"]),
                          t(b["transl"]))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_rodrigues_and_rigid_transform_match(bodies):
    """Level-parallel forward kinematics: posed joints and the relative
    transforms to 1e-5 abs (float32, ~8 composed 4x4 products)."""
    rng = np.random.RandomState(2)
    rv = (0.7 * rng.randn(3, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(n(TS.rodrigues(t(rv))),
                               np.asarray(JS.rodrigues(jnp.asarray(rv))),
                               atol=1e-6)
    joints = rng.randn(3, 24, 3).astype(np.float32)
    rots = np.asarray(JS.rodrigues(jnp.asarray(rv)))
    pj, tf = JS.rigid_transform(jnp.asarray(rots), jnp.asarray(joints),
                                JS.SMPL_PARENTS)
    qj, tq = TS.rigid_transform(t(rots), t(joints), TS.SMPL_PARENTS)
    np.testing.assert_allclose(n(qj), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(n(tq), np.asarray(tf), atol=1e-5)


def test_smpl_gradients_match(bodies):
    """d(sum of squared verts)/d(poses, betas) by autograd vs jax.grad:
    relative 1e-4 (float32 reductions over 512 vertices)."""
    import jax
    b = bodies

    def jloss(betas, poses):
        return jnp.sum(JS.smpl_forward(b["jm"], betas, poses)["verts"] ** 2)

    gb, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(b["betas"]),
                                             jnp.asarray(b["poses"]))
    betas = t(b["betas"]).requires_grad_(True)
    poses = t(b["poses"]).requires_grad_(True)
    torch.sum(TS.smpl_forward(b["tm"], betas, poses)["verts"] ** 2).backward()
    np.testing.assert_allclose(n(betas.grad), np.asarray(gb), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(n(poses.grad), np.asarray(gp), rtol=1e-4,
                               atol=1e-4)


def test_load_smpl_model_matches(tmp_path):
    """A chumpy-free SMPL_NEUTRAL.pkl plus auxiliary regressors load to
    identical arrays in both packages."""
    a = synthetic_smpl_arrays(512, seed=2)
    V = a["v_template"].shape[0]
    kintree = np.stack([np.asarray(a["parents"], np.int64),
                        np.arange(24)]).astype(np.int64)
    kintree[0, 0] = 4294967295
    data = {"v_template": a["v_template"],
            "shapedirs": np.concatenate(
                [a["shapedirs"], np.zeros((V, 3, 290), np.float32)], -1),
            "posedirs": a["posedirs"].T.reshape(V, 3, 207),
            "J_regressor": a["j_regressor"], "weights": a["lbs_weights"],
            "f": a["faces"].astype(np.uint32), "kintree_table": kintree}
    with open(tmp_path / "SMPL_NEUTRAL.pkl", "wb") as f:
        pickle.dump(data, f)
    rng = np.random.RandomState(0)
    np.save(tmp_path / "J_regressor_h36m.npy",
            rng.rand(17, V).astype(np.float32))
    np.save(tmp_path / "SMPL_MuPoTs_Regressor_v1.npy",
            rng.rand(V, 17).astype(np.float32))
    ref = jax_model_arrays(JS.load_smpl_model(str(tmp_path),
                                              parameters_path=str(tmp_path)))
    got = TS.load_smpl_model(str(tmp_path), parameters_path=str(tmp_path))
    for k, v in ref.items():
        if k == "parents":
            assert got.parents == tuple(int(p) for p in v)
        elif v is None:
            assert getattr(got, k) is None, k
        else:
            np.testing.assert_array_equal(n(getattr(got, k)), v, err_msg=k)


@pytest.mark.parametrize("env, num_vertices", [("512", 512), ("1", 6890)])
def test_resolve_smpl_model_synthetic_fallback(tmp_path, monkeypatch, env,
                                               num_vertices):
    """Without SMPL_NEUTRAL.pkl both packages fall back to the same
    synthetic body; MHMOCAP_SYNTHETIC_SMPL carries a vertex count, any
    other value means full size. Without the fallback both raise."""
    monkeypatch.setenv("MHMOCAP_SYNTHETIC_SMPL", env)
    ref = jax_model_arrays(JL.resolve_smpl_model(str(tmp_path),
                                                 allow_synthetic=False))
    got = TL.resolve_smpl_model(str(tmp_path), allow_synthetic=False)
    assert got.num_vertices == num_vertices
    for k in ("v_template", "faces", "lbs_weights"):
        np.testing.assert_array_equal(n(getattr(got, k)), ref[k], err_msg=k)
    monkeypatch.delenv("MHMOCAP_SYNTHETIC_SMPL")
    for resolve in (JL.resolve_smpl_model, TL.resolve_smpl_model):
        with pytest.raises(FileNotFoundError):
            resolve(str(tmp_path), allow_synthetic=False)

"""Parity of the port's FHSOG module (engine/fhsog.py) with mhmocap_tpu:
the exact EDT (against scipy and JAX), the Gaussian distance fields,
over-compositing, the occupancy grid, the inside test, carving and the
SMPL-conditioned FHSOG through the plain raster, on seeded numpy
inputs at small sizes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import distance_transform_edt as scipy_edt

from torch_parity import n, t, torch_model_of

from mhmocap_tpu.engine import fhsog as JF
from mhmocap_tpu.models.smpl import smpl_forward as jax_smpl
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops.cameras import intrinsics_from_fov
from mhmocap_tpu_torch.engine import fhsog as TF


def _mask(shape, seed, p=0.9):
    m = (np.random.RandomState(seed).rand(*shape) > p).astype(np.float32)
    m.flat[0] = 0
    return m


@pytest.mark.parametrize("shape,sampling", [
    ((40, 56), None), ((20, 20), (0.5, 2.0)), ((33, 17), (1 / 33, 1 / 17)),
    ((30,), None), ((128,), (1 / 128,)), ((45,), (0.3,))])
def test_edt_matches_scipy_and_jax(shape, sampling):
    """The EDT of random binary masks: to scipy's distance_transform_edt
    within 1e-4 and to the JAX package's within 1e-5 (equal where the
    spacing is a power of two: the squared distances are then exact in
    float32 in both)."""
    for p in (0.9, 0.5):
        mask = _mask(shape, len(shape) * 7 + int(10 * p), p)
        got = n(TF.distance_transform_edt(t(mask), sampling))
        np.testing.assert_allclose(got, scipy_edt(mask, sampling=sampling),
                                   atol=1e-4, rtol=0)
        ref = np.asarray(JF.distance_transform_edt(jnp.asarray(mask),
                                                   sampling))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)
        if sampling is None or all(np.log2(s) % 1 == 0 for s in sampling):
            np.testing.assert_array_equal(got, ref)


def test_edt_without_zero_is_inf():
    """A line with no zero is +inf in both packages."""
    mask = np.ones((4, 6), np.float32)
    mask[2, 3] = 0
    ref = np.asarray(JF.distance_transform_edt(jnp.asarray(mask[0])))
    got = n(TF.distance_transform_edt(t(mask[0])))
    assert np.isinf(got).all() and np.isinf(ref).all()
    np.testing.assert_array_equal(n(TF.distance_transform_edt(t(mask))),
                                  np.asarray(JF.distance_transform_edt(
                                      jnp.asarray(mask))))


@pytest.mark.parametrize("sigma", [0.25, 5.0])
def test_gaussian_distance_fields_match(sigma):
    """Both GDFs on default spacings (1/n; 1/H, 1/W): to 1e-6 relative,
    zero at the feature cells; the port's batched 2-D field equals its
    per-map one."""
    v = np.ones(16, np.float32)
    v[[3, 11]] = 0
    ref1 = np.asarray(JF.gaussian_distance_field_1d(jnp.asarray(v),
                                                    sigma=sigma))
    got1 = n(TF.gaussian_distance_field_1d(t(v), sigma=sigma))
    np.testing.assert_allclose(got1, ref1, rtol=1e-6, atol=0)
    maps = np.stack([_mask((24, 20), s, 0.3) for s in range(2)])
    got2 = n(TF.gaussian_distance_field_2d(t(maps), sigma=sigma))
    for k in range(2):
        ref2 = np.asarray(JF.gaussian_distance_field_2d(
            jnp.asarray(maps[k]), sigma=sigma))
        np.testing.assert_allclose(got2[k], ref2, rtol=1e-6, atol=0)
        assert (got2[k][maps[k] == 0] == 0).all()
        np.testing.assert_array_equal(
            n(TF.gaussian_distance_field_2d(t(maps[k]), sigma=sigma)),
            got2[k])


def test_over_composite_from_fog_matches():
    rng = np.random.RandomState(1)
    fog = (rng.rand(12, 6, 7) > 0.7).astype(np.float32) * rng.rand(12, 6, 7)
    fog = fog.astype(np.float32)
    ref = np.asarray(JF.over_composite_from_fog(jnp.asarray(fog), 1.5, 40.0))
    got = n(TF.over_composite_from_fog(t(fog), 1.5, 40.0))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("T", [4, 5])
def test_build_fhs_occupancy_grid_matches(T):
    """Fog and back mask exact, texture within 1 level, near/far exact
    (the median of an even count is the mean of the two middle values,
    as jnp.median's)."""
    rng = np.random.RandomState(T)
    H, W, D = 16, 12, 8
    depths = rng.rand(T, H, W).astype(np.float32)
    images = (255 * rng.rand(T, H, W, 3)).astype(np.float32)
    back = (rng.rand(T, H, W) > 0.2).astype(np.float32)
    min_z = (2.0 + 0.1 * rng.rand(T, 1, 1)).astype(np.float32)
    max_z = (8.0 + rng.rand(T, 1, 1)).astype(np.float32)
    ref = JF.build_fhs_occupancy_grid(*map(jnp.asarray, (
        depths, images, back, min_z, max_z)), num_depth_bins=D)
    got = TF.build_fhs_occupancy_grid(*map(t, (
        depths, images, back, min_z, max_z)), num_depth_bins=D)
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
    assert got[2].dtype == torch.uint8
    d = np.abs(n(got[2]).astype(int) - np.asarray(ref[2]).astype(int))
    assert d.max() <= 1, d.max()
    assert float(got[3]) == float(ref[3]) and float(got[4]) == float(ref[4])


def _sphere():
    from scipy.spatial import ConvexHull
    k = 200
    i = np.arange(k)
    phi = np.arccos(1 - 2 * (i + 0.5) / k)
    theta = np.pi * (1 + 5 ** 0.5) * i
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                    np.cos(phi)], axis=1).astype(np.float32)
    faces = ConvexHull(pts).simplices.astype(np.int64)
    tri = pts[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.sum(nrm * tri.mean(1), axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return pts, faces


def test_points_inside_mesh_sphere_matches(monkeypatch):
    """The sphere of tests/test_fhsog.py: the reference's four queries,
    and 3000 random points (no closest-centre ties among them): equal to
    the JAX package's answer, also when the port takes them in blocks
    of 7."""
    pts, faces = _sphere()
    q4 = np.array([[0, 0, 0], [0.5, 0, 0], [1.5, 0, 0], [0, 0, -2.0]],
                  np.float32)
    assert n(TF.points_inside_mesh(t(pts), torch.as_tensor(faces),
                                   t(q4))).tolist() == [True, True, False,
                                                        False]
    q = np.random.RandomState(0).uniform(-1.6, 1.6, (3000, 3)).astype(
        np.float32)
    ref = np.asarray(JF.points_inside_mesh(jnp.asarray(pts),
                                           jnp.asarray(faces),
                                           jnp.asarray(q)))
    got = n(TF.points_inside_mesh(t(pts), torch.as_tensor(faces), t(q)))
    np.testing.assert_array_equal(got, ref)
    r = np.linalg.norm(q, axis=1)
    assert got[r < 0.9].all() and not got[r > 1.05].any()
    monkeypatch.setattr(TF, "_BLOCK_ELEMS", 7 * faces.shape[0])
    np.testing.assert_array_equal(
        n(TF.points_inside_mesh(t(pts), torch.as_tensor(faces), t(q))), ref)


@pytest.fixture(scope="module")
def scene():
    """Two frames of two 384-vertex bodies in a 40x56 (H x W) frame:
    the rectangular case, whose longer side (56) is an odd multiple of
    8, so the JAX package rasters at 56 and the port at 64."""
    jm = make_synthetic_smpl(num_vertices=384, seed=4)
    T, N, H, W = 2, 2, 40, 56
    rng = np.random.RandomState(2)
    transl = np.array([[[-0.35, 0.25, 3.0], [0.4, 0.3, 3.6]],
                       [[-0.3, 0.25, 3.1], [0.35, 0.3, 3.5]]], np.float32)
    poses = (0.1 * rng.randn(T * N, 72)).astype(np.float32)
    v = jax_smpl(jm, jnp.zeros((T * N, 10)), jnp.asarray(poses),
                 jnp.asarray(transl.reshape(-1, 3)))["verts"]
    depths = (4.0 + 2.0 * rng.rand(T, H, W)).astype(np.float32)
    images = (255 * rng.rand(T, H, W, 3)).astype(np.float32)
    back = (rng.rand(T, H, W) > 0.1).astype(np.float32)
    return dict(jm=jm, tm=torch_model_of(jm),
                verts=np.asarray(v).reshape(T, N, -1, 3), depths=depths,
                images=images, back=back,
                K=intrinsics_from_fov((W, H), 60.0))


def _fhsog_both(s, H=None, W=None):
    H = H or s["depths"].shape[1]
    W = W or s["depths"].shape[2]
    K = s["K"] if (H, W) == s["depths"].shape[1:] \
        else intrinsics_from_fov((W, H), 60.0)
    args = (s["depths"][:, :H, :W], s["images"][:, :H, :W],
            s["back"][:, :H, :W])
    ref = JF.build_fhsog_from_smpl(*map(jnp.asarray, args),
                                   jnp.asarray(s["verts"]), s["jm"].faces,
                                   jnp.asarray(K), near_z=1.0, far_z=16.0,
                                   num_depth_bins=16)
    got = TF.build_fhsog_from_smpl(*map(t, args), t(s["verts"]),
                                   s["tm"].faces, t(K), near_z=1.0,
                                   far_z=16.0, num_depth_bins=16)
    return [np.asarray(x) for x in ref], [n(x) for x in got]


@pytest.mark.parametrize("size", [(40, 56), (40, 40)])
def test_build_fhsog_from_smpl_matches(scene, size):
    """The SMPL-conditioned FHSOG through the plain raster, rectangular
    (the port's window rounded up to 64) and square: smpl_masks equal,
    the GDFs to 1e-6, fog, out-mask and texture to rtol 1e-4 (the
    per-person mean depth sums in another order)."""
    ref, got = _fhsog_both(scene, *size)
    names = ("fhsog_alpha", "texture", "outmask", "smpl_masks", "gdfs")
    for k, name in enumerate(names):
        assert got[k].shape == ref[k].shape, name
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[3].any() and not got[3].all()
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-6, atol=1e-7)
    for k in (0, 1, 2):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=names[k])
    assert got[0].sum() > 0
    assert got[0][:, got[3].all(axis=0)].sum() == 0


def test_build_fhsog_frames_per_call_is_exact(scene, monkeypatch):
    """Rastering 1, 2 or 3 frames per call (the last call padded) gives
    the same arrays bit for bit."""
    outs = []
    for k in (1, 2, 3):
        monkeypatch.setattr(TF, "FRAMES_PER_CALL", k)
        outs.append(_fhsog_both(scene)[1])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_carve_fog_with_meshes_matches(scene):
    """Carving a 16 x 40 x 56 fog with frame 0's two bodies: the carved
    voxels differ from the JAX package's on at most 0.1% of the voxels
    (the voxel centres come from jnp.linspace, which is off by an ulp
    where torch.linspace is exact), and some are carved."""
    rng = np.random.RandomState(3)
    D, H, W = 16, 40, 56
    fog = (rng.rand(D, H, W) > 0.3).astype(np.float32)
    ref = np.asarray(JF.carve_fog_with_meshes(
        jnp.asarray(fog), jnp.asarray(scene["verts"][0]), scene["jm"].faces,
        2.0, 6.0, jnp.asarray(scene["K"])))
    got = n(TF.carve_fog_with_meshes(t(fog), t(scene["verts"][0]),
                                     scene["tm"].faces, 2.0, 6.0,
                                     t(scene["K"])))
    assert got.shape == (D, H, W) and got.dtype == bool
    assert got.sum() > 50 and not (got & (fog == 0)).any()
    assert np.mean(got != ref) <= 1e-3, np.mean(got != ref)

"""Parity of the port's cameras, morphology, image ops, One-Euro filter
and scene kNN with mhmocap_tpu."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torch_parity import n, t

from mhmocap_tpu.engine import scene as JSc
from mhmocap_tpu.ops import cameras as JC, image as JI, morphology as JM
from mhmocap_tpu.ops import one_euro as JO
from mhmocap_tpu_torch.engine import scene as TSc
from mhmocap_tpu_torch.ops import cameras as TC, image as TI
from mhmocap_tpu_torch.ops import morphology as TM, one_euro as TO


@pytest.mark.parametrize("dist", [None, (0.1, -0.05, 0.002, -0.003, 0.01)])
def test_project_unproject_match(dist):
    """Pinhole projection with and without distortion, and the UVD
    inverse: float32 elementwise math, 1e-4 px / 1e-6 m."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-1, 1, (5, 7, 2)),
                          rng.uniform(2, 6, (5, 7, 1))], -1).astype(np.float32)
    K = JC.intrinsics_from_fov((320, 240), 55.0)
    np.testing.assert_array_equal(TC.intrinsics_from_fov((320, 240), 55.0),
                                  K)
    dj = None if dist is None else jnp.asarray(dist, jnp.float32)
    dt = None if dist is None else t(dist)
    ref = JC.project_points(jnp.asarray(pts), jnp.asarray(K), dist_coef=dj,
                            return_depth=True)
    got = TC.project_points(t(pts), t(K), dist_coef=dt, return_depth=True)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-4, rtol=0)
    back = TC.unproject_points(got, t(K))
    np.testing.assert_allclose(
        n(back), np.asarray(JC.unproject_points(ref, jnp.asarray(K))),
        atol=1e-6, rtol=1e-6)


def test_softplus_matches():
    x = np.linspace(-30, 30, 101).astype(np.float32)
    np.testing.assert_allclose(n(TC.softplus(t(x))),
                               np.asarray(JC.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k,iters", [(3, 2), (5, 1)])
def test_erode_dilate_match(k, iters):
    """Binary ops: exact."""
    rng = np.random.RandomState(k)
    x = (rng.rand(3, 2, 20, 23) > 0.35).astype(np.float32)
    np.testing.assert_array_equal(
        n(TM.erode(t(x), k, iters)),
        np.asarray(JM.erode(jnp.asarray(x), k, iters)))
    np.testing.assert_array_equal(
        n(TM.dilate(t(x), k, iters)),
        np.asarray(JM.dilate(jnp.asarray(x), k, iters)))


def test_masked_medians_match():
    """Median = mean of sorted elements (n-1)//2 and n//2 (not
    torch.median's lower element): exact on the same floats."""
    rng = np.random.RandomState(1)
    x = rng.randn(16, 18).astype(np.float32)
    m = (rng.rand(16, 18) > 0.5).astype(np.float32)
    for k in (3, 5):
        rm, rok = JI.masked_window_median(jnp.asarray(x), jnp.asarray(m), k)
        gm, gok = TI.masked_window_median(t(x), t(m), k)
        np.testing.assert_array_equal(n(gok), np.asarray(rok))
        np.testing.assert_allclose(n(gm), np.asarray(rm), atol=1e-7)
    v = rng.randn(9, 6, 7).astype(np.float32)
    ok = rng.rand(9, 6, 7) > 0.4
    ok[:, 0, 0] = False
    for vals in (v, np.stack([v, 2 * v], -1)):
        rm, rok = JI.masked_temporal_median(jnp.asarray(vals),
                                            jnp.asarray(ok))
        gm, gok = TI.masked_temporal_median(t(vals), t(ok, dtype=bool))
        np.testing.assert_array_equal(n(gok), np.asarray(rok))
        np.testing.assert_allclose(n(gm), np.asarray(rm), atol=1e-7)


def test_fillin_masked_matches():
    """Fixed 64 rounds vs the JAX while-loop: identical (rounds after
    the mask fills change nothing)."""
    rng = np.random.RandomState(2)
    x = rng.rand(24, 24).astype(np.float32)
    m = np.ones((24, 24), np.float32)
    m[5:15, 6:20] = 0
    m[20:, :3] = 0
    rx, rm = JI.fillin_masked(jnp.asarray(x), jnp.asarray(m), 5)
    gx, gm = TI.fillin_masked(t(x), t(m), 5)
    np.testing.assert_array_equal(n(gm), np.asarray(rm))
    np.testing.assert_allclose(n(gx), np.asarray(rx), atol=1e-7)


def test_sobel_bilateral_match():
    """3x3 Sobel with reflect padding and the 9x9 bilateral filter:
    float32 sums in another order, 1e-5 relative."""
    rng = np.random.RandomState(3)
    x = (2.0 + rng.rand(20, 22)).astype(np.float32)
    np.testing.assert_allclose(n(TI.sobel_magnitude(t(x))),
                               np.asarray(JI.sobel_magnitude(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        n(TI.bilateral_filter(t(x), 9, 0.05, 25.0)),
        np.asarray(JI.bilateral_filter(jnp.asarray(x), 9, 0.05, 25.0)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bilateral", [False, True])
def test_postprocess_depthmap_matches(bilateral):
    """Sobel outlier mask (population std) + erosion + fill-in: the
    masks agree exactly, depths to 1e-4 relative."""
    rng = np.random.RandomState(4)
    d = (3.0 + 0.3 * rng.rand(32, 32)).astype(np.float32)
    d[10:14, 10:20] = 9.0           # a flying-pixel step
    mask = np.ones((32, 32), np.float32)
    mask[20:26, 3:9] = 0
    ref = JI.postprocess_depthmap(jnp.asarray(d), jnp.asarray(mask),
                                  use_bilateral_filter=bilateral)
    got = TI.postprocess_depthmap(t(d), t(mask),
                                  use_bilateral_filter=bilateral)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["ramp", "uniform"])
def test_one_euro_filter_matches(mode):
    """Filter with a hold mask: float32 recurrences over 30 steps, 1e-5
    relative."""
    rng = np.random.RandomState(5)
    x = np.cumsum(rng.randn(30, 4, 3), 0).astype(np.float32)
    mask = (rng.rand(30, 4, 3) > 0.2).astype(np.float32)
    ref = JO.one_euro_filter(jnp.asarray(x), 0.004, 0.7, dt_mode=mode,
                             mask=jnp.asarray(mask))
    got = TO.one_euro_filter(t(x), 0.004, 0.7, dt_mode=mode, mask=t(mask))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_one_euro_step_matches():
    rng = np.random.RandomState(6)
    x0, x1 = rng.randn(2, 5, 3).astype(np.float32)
    rs, rx = JO.one_euro_step(JO.one_euro_init(jnp.asarray(x0)),
                              jnp.asarray(x1), 0.08, 0.001, 0.5)
    gs, gx = TO.one_euro_step(TO.one_euro_init(t(x0)), t(x1), 0.08, 0.001,
                              0.5)
    np.testing.assert_allclose(n(gx), np.asarray(rx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(gs[1]), np.asarray(rs[1]), rtol=1e-6,
                               atol=1e-6)


def test_mean_knn_point_is_exact():
    """JAX's approx_min_k lowers to an exact top-k on the CPU, so both
    packages are held to an exact numpy kNN (1e-5 m: means of 32
    float32 points)."""
    rng = np.random.RandomState(7)
    pts = rng.randn(3000, 3).astype(np.float32)
    valid = rng.rand(3000) > 0.3
    q = rng.randn(4, 2, 1, 3).astype(np.float32)
    d2 = ((q.reshape(-1, 1, 3) - pts[None]) ** 2).sum(-1)
    d2[:, ~valid] = np.inf
    exact = np.stack([pts[np.argsort(r, kind="stable")[:32]].mean(0)
                      for r in d2]).reshape(q.shape)

    def pcd(mod, conv, dev_bool):
        return mod.ScenePointCloud(points=conv(pts), valid=dev_bool(valid),
                                   depth=None, depth_valid=None)

    ref = JSc.mean_knn_point(jnp.asarray(q),
                             pcd(JSc, jnp.asarray, jnp.asarray), k=32)
    got = TSc.mean_knn_point(t(q), pcd(TSc, t, lambda v: t(v, bool)), k=32)
    np.testing.assert_allclose(np.asarray(ref), exact, atol=1e-5)
    np.testing.assert_allclose(n(got), exact, atol=1e-5)


def test_scene_pointcloud_and_contact_match():
    """Median aggregation -> postprocess -> unprojection -> contact
    targets, end to end on a small scene."""
    rng = np.random.RandomState(8)
    T, H, W = 5, 24, 24
    disp = np.clip(0.5 + 0.1 * rng.randn(T, H, W), 0, 1).astype(np.float32)
    back = (rng.rand(T, H, W) > 0.3).astype(np.float32)
    min_z = np.full((T, 1, 1), 1.3, np.float32)
    max_z = np.full((T, 1, 1), 7.0, np.float32)
    K = JC.intrinsics_from_fov((W, H), 60.0)
    rmed, rok = JSc.aggregate_scene_depth(jnp.asarray(disp),
                                          jnp.asarray(back),
                                          jnp.asarray(min_z),
                                          jnp.asarray(max_z))
    gmed, gok = TSc.aggregate_scene_depth(t(disp), t(back), t(min_z),
                                          t(max_z))
    np.testing.assert_array_equal(n(gok), np.asarray(rok))
    np.testing.assert_allclose(n(gmed), np.asarray(rmed), rtol=1e-6)
    rp = JSc.build_scene_pointcloud(rmed, rok, jnp.asarray(K))
    gp = TSc.build_scene_pointcloud(gmed, gok, t(K))
    np.testing.assert_array_equal(n(gp.valid), np.asarray(rp.valid))
    np.testing.assert_allclose(n(gp.points), np.asarray(rp.points),
                               rtol=1e-4, atol=1e-5)
    verts = (rng.randn(2, 3, 50, 3) * 0.3
             + np.array([0, 0.5, 3.0])).astype(np.float32)
    pT = verts.mean(2, keepdims=True)
    r = JSc.contact_targets(jnp.asarray(verts), jnp.asarray(pT), rp, k=8)
    g = TSc.contact_targets(t(verts), t(pT), gp, k=8)
    for a, b in zip(g, r):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-4, atol=1e-4)

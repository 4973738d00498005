"""Parity of the port's rasterizer and raster kernel pair with
mhmocap_tpu: face planes, window placement, the brute edge_lines
backend, the table pack and schedule (exact), and the kernels' plain
version against the Pallas kernels run as tests/test_raster_pallas.py
runs them on the CPU (interpret mode)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import n, rel_err, t, torch_model_of

from mhmocap_tpu.models.smpl import smpl_forward as jax_smpl
from mhmocap_tpu.models.synthetic import make_synthetic_smpl
from mhmocap_tpu.ops import raster_pallas as JP, rasterizer as JR
from mhmocap_tpu.ops.cameras import intrinsics_from_fov, project_points
from mhmocap_tpu_torch.ops import raster_cuda as TC, rasterizer as TR

K32 = np.array([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]], np.float32)


def _tri_mesh():
    verts = np.array([
        [-0.2, -0.2, 2.0], [0.3, -0.1, 2.0], [0.0, 0.35, 2.0],
        [-0.1, -0.3, 4.0], [0.5, -0.2, 4.0], [0.1, 0.5, 4.0],
    ], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return verts, faces


@pytest.fixture(scope="module")
def body():
    """Three posed 384-vertex bodies in front of a 64x64 camera."""
    jm = make_synthetic_smpl(num_vertices=384, seed=1)
    rng = np.random.RandomState(3)
    poses = (0.15 * rng.randn(3, 72)).astype(np.float32)
    transl = np.array([[0.0, 0.3, 3.0], [0.1, 0.2, 3.4], [-0.1, 0.3, 2.8]],
                      np.float32)
    v = jax_smpl(jm, jnp.zeros((3, 10)), jnp.asarray(poses),
                 jnp.asarray(transl))["verts"]
    K = intrinsics_from_fov((64, 64), 60.0)
    return dict(jm=jm, tm=torch_model_of(jm), verts=np.asarray(v), K=K)


def _planes_inputs(body, win):
    """Window-local face inputs of the fixture's bodies (numpy)."""
    st = JR.RasterSettings(image_size=(64, 64), window=win)
    uvz = np.asarray(project_points(jnp.asarray(body["verts"]),
                                    jnp.asarray(body["K"]),
                                    return_depth=True))
    f = np.asarray(body["jm"].faces)
    out = []
    for b in range(uvz.shape[0]):
        o = np.asarray(JR.window_origin(jnp.asarray(uvz[b, :, :2]),
                                        jnp.asarray(uvz[b, :, 2]), st))
        fuv = (uvz[b][f][..., :2] - o.astype(np.float32)).astype(np.float32)
        out.append((fuv, uvz[b][f][..., 2]))
    return st, out


def test_face_planes_match():
    """Plane coefficients to 1e-5 relative (float32 rsqrt and inverse
    area); bbox and validity exact, incl. a degenerate and a
    behind-camera face."""
    rng = np.random.RandomState(0)
    fuv = rng.uniform(0, 40, (60, 3, 2)).astype(np.float32)
    fz = rng.uniform(1.5, 6, (60, 3)).astype(np.float32)
    fuv[0, 2] = fuv[0, 0]                 # zero area
    fz[1, 0] = 0.5                        # behind the near plane
    rp, rb, rs, rd = JR.face_planes(jnp.asarray(fuv), jnp.asarray(fz), 1.0)
    gp, gb, gs, gd = TR.face_planes(t(fuv), t(fz), 1.0)
    np.testing.assert_allclose(n(gp), np.asarray(rp), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(gb), np.asarray(rb))
    np.testing.assert_array_equal(n(gs), np.asarray(rs))
    np.testing.assert_array_equal(n(gd), np.asarray(rd))
    assert not n(gd)[0] and not n(gs)[1]


def test_window_origin_matches():
    """Half-integer centres round half to even in both packages; verts
    behind the near plane are ignored; clamped to the image."""
    st = JR.RasterSettings(image_size=(64, 48), window=32)
    ts = TR.RasterSettings(image_size=(64, 48), window=32)
    rng = np.random.RandomState(1)
    for shift in (0.5, 1.5, 2.5, 10.0, -30.0, 60.0):
        uv = rng.uniform(10, 30, (20, 2)).astype(np.float32)
        uv[0] = [10.0, 10.0]
        uv[1] = [30.0 + 2 * shift, 30.0 + 2 * shift]
        z = np.full((20,), 3.0, np.float32)
        z[2] = 0.5
        uv[2] = [-500.0, 900.0]
        ref = JR.window_origin(jnp.asarray(uv), jnp.asarray(z), st)
        got = TR.window_origin(t(uv), t(z), ts)
        np.testing.assert_array_equal(n(got), np.asarray(ref))


def test_brute_backend_matches(body):
    """Brute edge_lines raster of 3 bodies: no coverage mismatch, z to
    1e-5 m, silhouette to 1e-4 (log-sums over ~700 faces in another
    order); the main-path backend gives the same."""
    b = body
    st = JR.RasterSettings(image_size=(64, 64), window=48, backend="brute",
                           face_chunk=128)
    ref = jax.vmap(lambda v: JR.rasterize_body(v, b["jm"].faces,
                                               jnp.asarray(b["K"]), st))(
        jnp.asarray(b["verts"]))
    for backend in ("brute", "auto"):
        ts = TR.RasterSettings(image_size=(64, 64), window=48,
                               backend=backend)
        got = TR.rasterize_bodies(t(b["verts"]), b["tm"].faces, t(b["K"]),
                                  ts)
        np.testing.assert_array_equal(n(got["origin"]),
                                      np.asarray(ref["origin"]))
        zr, zg = np.asarray(ref["zbuf"]), n(got["zbuf"])
        assert (np.isfinite(zr) == np.isfinite(zg)).all(), backend
        cov = np.isfinite(zr)
        assert cov.sum() > 20
        np.testing.assert_allclose(zg[cov], zr[cov], atol=1e-5)
        np.testing.assert_allclose(n(got["sil"]), np.asarray(ref["sil"]),
                                   atol=1e-4)


def _jax_tables(fuv, fz, st):
    planes, bbox, oks, okd = JR.face_planes(jnp.asarray(fuv),
                                            jnp.asarray(fz), st.znear)
    reach = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
    inv_blur = 1.0 / st.sil_blur_px2
    args = (planes, bbox, oks, okd, bbox[:, 2] - reach, bbox[:, 3] + reach)
    return args, 3.0 / np.sqrt(inv_blur) + 1.0


def test_fold_pack_exact(body):
    """The folded table and chunk aggregates equal the JAX package's
    bit for bit (the JAX matmul layout read back as (F_pad, 12))."""
    st, items = _planes_inputs(body, 48)
    for fuv, fz in items:
        args, reach = _jax_tables(fuv, fz, st)
        mat, meta, agg, _ = JP._fold_pack(*args, reach)
        tab, tagg = TC._fold_pack(*[t(np.asarray(a), a.dtype == jnp.bool_
                                      and torch.bool or torch.float32)[None]
                                    for a in args], reach)
        F_pad = meta.shape[1]
        nc = F_pad // JP.FACE_CHUNK
        dense = np.asarray(mat)[:3].reshape(3, nc, 4, JP.FACE_CHUNK).transpose(
            1, 3, 2, 0).reshape(F_pad, 12)
        np.testing.assert_array_equal(n(tab[0, :12]).T, dense)
        np.testing.assert_array_equal(n(tab[0, 12:]), np.asarray(meta))
        np.testing.assert_array_equal(n(tagg[0]), np.asarray(agg))


def test_strip_chunk_lists_exact(body):
    """Per-strip lists and per-cell bounds equal the JAX schedule
    exactly (stable argsort), on body tables and on random aggregates
    with empty-chunk sentinels, batched."""
    st, items = _planes_inputs(body, 48)
    aggs = []
    for fuv, fz in items:
        args, reach = _jax_tables(fuv, fz, st)
        aggs.append(np.asarray(JP._fold_pack(*args, reach)[2]))
    rng = np.random.RandomState(7)
    nc = aggs[0].shape[0]
    for _ in range(4):
        lo = rng.uniform(-40, 68, (nc, 2))
        ext = rng.uniform(1, 50, (nc, 2))
        a = np.stack([lo[:, 0], lo[:, 0] + ext[:, 0], lo[:, 1],
                      lo[:, 1] + ext[:, 1]], 1).astype(np.float32)
        a[rng.rand(nc) < 0.3] = [JP.BIG, -JP.BIG, JP.BIG, -JP.BIG]
        a[1] = a[0]                       # exact ties keep their order
        aggs.append(a)
    for win in (48, 32):
        lists, bounds = TC._strip_chunk_lists(t(np.stack(aggs)), win)
        for i, a in enumerate(aggs):
            rl, rb = JP._strip_chunk_lists(jnp.asarray(a), win)
            np.testing.assert_array_equal(n(lists[i]), np.asarray(rl))
            np.testing.assert_array_equal(n(bounds[i]), np.asarray(rb))


def _tri_planes():
    """Window-local plane inputs of the 2-triangle mesh at 32 px."""
    verts, faces = _tri_mesh()
    st = JR.RasterSettings(image_size=(32, 32), window=32)
    uvz = np.asarray(project_points(jnp.asarray(verts), jnp.asarray(K32),
                                    return_depth=True))
    o = np.asarray(JR.window_origin(jnp.asarray(uvz[:, :2]),
                                    jnp.asarray(uvz[:, 2]), st))
    fuv = (uvz[faces][..., :2] - o.astype(np.float32)).astype(np.float32)
    planes, bbox, oks, okd = JR.face_planes(jnp.asarray(fuv),
                                            jnp.asarray(uvz[faces][..., 2]),
                                            st.znear)
    reach = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
    ext = (bbox, bbox[:, 2] - reach, bbox[:, 3] + reach, oks, okd)
    return st, planes, ext


def _torch_ext(ext):
    return tuple(t(np.asarray(e), torch.bool if e.dtype == jnp.bool_
                   else torch.float32)[None] for e in ext)


def test_plain_kernels_match_pallas_forward():
    """zbuf and sil of the 2-triangle mesh: the kernels' plain version
    against the Pallas forward kernel (interpret mode). Zero coverage
    mismatches; z to 1e-6 m, sil to 1e-5 (the log-sum runs over the
    faces in another order)."""
    st, planes, ext = _tri_planes()
    inv_blur = 1.0 / st.sil_blur_px2
    zr, sr = JP.raster_planes_pallas(planes, ext, 32, inv_blur, st.znear,
                                     True)
    zg, sg = TC.raster_planes(t(np.asarray(planes))[None], _torch_ext(ext),
                              32, inv_blur, st.znear)
    zr, zg = np.asarray(zr), n(zg[0])
    assert (np.isfinite(zr) == np.isfinite(zg)).all()
    cov = np.isfinite(zr)
    assert cov.sum() > 20
    np.testing.assert_allclose(zg[cov], zr[cov], atol=1e-6)
    np.testing.assert_allclose(n(sg[0]), np.asarray(sr), atol=1e-5)


def test_plain_kernels_match_pallas_plane_gradients():
    """d(loss)/d(planes) of the backward kernels' plain version against
    the Pallas custom VJP: relative norm 1e-5 (f32 pixel sums in
    another order)."""
    st, planes, ext = _tri_planes()
    inv_blur = 1.0 / st.sil_blur_px2
    rng = np.random.RandomState(2)
    w_sil = rng.randn(32, 32).astype(np.float32)
    w_z = rng.randn(32, 32).astype(np.float32)

    def jloss(p):
        z, s = JP.raster_planes_pallas(p, ext, 32, inv_blur, st.znear, True)
        zb = jnp.where(jnp.isfinite(z), z, 0.0)
        return jnp.sum(w_sil * s) + jnp.sum(w_z * zb)

    g_ref = np.asarray(jax.grad(jloss)(planes))
    p = t(np.asarray(planes))[None].requires_grad_(True)
    z, s = TC.raster_planes(p, _torch_ext(ext), 32, inv_blur, st.znear)
    zb = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    (torch.sum(t(w_sil) * s) + torch.sum(t(w_z) * zb)).backward()
    assert np.abs(g_ref).max() > 0
    assert rel_err(n(p.grad[0]), g_ref) < 1e-5


def test_vertex_gradients_match_brute(body):
    """Vertex gradients through face_planes and the kernel pair's plain
    version against JAX autodiff through its brute backend: relative
    norm 1e-3 (hard z-buffer winners at ulp-level ties)."""
    b = body
    st = JR.RasterSettings(image_size=(64, 64), window=48, backend="brute")
    ts = TR.RasterSettings(image_size=(64, 64), window=48)
    rng = np.random.RandomState(4)
    target = (rng.rand(3, 48, 48) > 0.5).astype(np.float32)

    def jloss(v):
        o = jax.vmap(lambda x: JR.rasterize_body(x, b["jm"].faces,
                                                 jnp.asarray(b["K"]), st))(v)
        zb = jnp.where(jnp.isfinite(o["zbuf"]), o["zbuf"], 0.0)
        return jnp.sum((o["sil"] - target) ** 2) + 0.1 * jnp.sum(zb)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(b["verts"])))
    v = t(b["verts"]).requires_grad_(True)
    o = TR.rasterize_bodies(v, b["tm"].faces, t(b["K"]), ts)
    zb = torch.where(torch.isfinite(o["zbuf"]), o["zbuf"],
                     torch.zeros_like(o["zbuf"]))
    (torch.sum((o["sil"] - t(target)) ** 2) + 0.1 * torch.sum(zb)).backward()
    assert rel_err(n(v.grad), g_ref) < 1e-3


def test_wrapper_routes_by_device():
    """A CPU tensor runs the plain version and launches nothing; the
    launchers refuse CPU tensors; a window off the 8-px grid raises."""
    st, planes, ext = _tri_planes()
    before = dict(TC.RasterPlanes.launches)
    TC.raster_planes(t(np.asarray(planes))[None], _torch_ext(ext), 32,
                     1.0 / st.sil_blur_px2, st.znear)
    assert TC.RasterPlanes.launches == before
    tab = torch.zeros((1, 16, 128))
    agg = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError):
        TC.raster_fwd_cuda(tab, agg, torch.zeros((1, 4, 1), dtype=torch.int32),
                           torch.zeros((1, 8, 2), dtype=torch.int32), 32, 1.0,
                           1.0)
    with pytest.raises(ValueError):
        TC.raster_planes(t(np.asarray(planes))[None], _torch_ext(ext), 36,
                         1.0, 1.0)

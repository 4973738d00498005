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


def test_wrapper_routes_by_device(monkeypatch):
    """A CPU tensor runs the plain version, forward and backward, and
    launches nothing; the launchers refuse CPU tensors; a window off the
    8-px grid raises."""
    st, planes, ext = _tri_planes()
    before = dict(TC.RasterPlanes.launches)
    plain_bwd, orig = [], TC.raster_bwd_plain

    def counted_bwd(*a, **k):
        plain_bwd.append(a[0].device)
        return orig(*a, **k)

    monkeypatch.setattr(TC, "raster_bwd_plain", counted_bwd)
    p = t(np.asarray(planes))[None].requires_grad_(True)
    z, s = TC.raster_planes(p, _torch_ext(ext), 32, 1.0 / st.sil_blur_px2,
                            st.znear)
    s.sum().backward()
    assert plain_bwd == [torch.device("cpu")]
    assert torch.isfinite(p.grad).all() and bool((p.grad != 0).any())
    assert TC.RasterPlanes.launches == before
    tab = torch.zeros((1, 16, 128))
    agg = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError):
        TC.raster_fwd_cuda(tab, agg, torch.zeros((1, 4, 1), dtype=torch.int32),
                           torch.zeros((1, 8, 2), dtype=torch.int32), 32, 1.0,
                           1.0)
    img = torch.zeros((1, 32, 32))
    with pytest.raises(ValueError):
        TC.raster_bwd_cuda(tab, agg, img, img, img.to(torch.int32), 32, 1.0)
    with pytest.raises(ValueError):
        TC.raster_planes(t(np.asarray(planes))[None], _torch_ext(ext), 36,
                         1.0, 1.0)


def _full_body_agg(win, invalid_chunk=1):
    """Chunk aggregates of 3 posed full-size bodies (faces preordered, as
    the Predictor orders them) in a 256x256 image at the depth that
    fills `win`; body 0 has every face of chunk `invalid_chunk` marked
    invalid, so that chunk carries the +-3e38 empty aggregate."""
    from mhmocap_tpu_torch.models.smpl import smpl_forward
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl as tm
    model = TR.preorder_faces(tm())
    rng = np.random.RandomState(win)
    transl = np.zeros((3, 3), np.float32)
    transl[:, 2] = 3.4 * 160 / win
    transl[:, :2] = 0.05 * rng.randn(3, 2)
    st = TR.RasterSettings(image_size=(256, 256), window=win)
    with torch.no_grad():
        v = smpl_forward(model, torch.zeros((3, 10)),
                         t(0.1 * rng.randn(3, 72)), t(transl))["verts"]
        uvz = TR.project_points(v, t(intrinsics_from_fov((256, 256), 60.0)),
                                return_depth=True)
        origin = TR.window_origin(uvz[..., :2], uvz[..., 2], st)
        fuvz = uvz[:, model.faces]
        planes, bbox, oks, okd = TR.face_planes(
            fuvz[..., :2] - origin[:, None, None].float(), fuvz[..., 2],
            st.znear)
    c = TC.FACE_CHUNK
    oks[0, invalid_chunk * c:(invalid_chunk + 1) * c] = False
    reach = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
    _, agg = TC._tables(planes, bbox, bbox[..., 2] - reach,
                        bbox[..., 3] + reach, oks, okd,
                        1.0 / st.sil_blur_px2)
    return agg


def _rect_mask(cells, win):
    """(B, nc, 4) cell ranges of _chunk_cells -> bool (B, n_cells, nc)."""
    n_xb = TC._n_xb(win)
    cell = torch.arange((win // TC.STRIP_H) * n_xb)
    s, xb = (cell // n_xb)[None, :, None], (cell % n_xb)[None, :, None]
    r = cells[:, None].long()
    return ((s >= r[..., 0]) & (s <= r[..., 1]) & (xb >= r[..., 2])
            & (xb <= r[..., 3]))


@pytest.mark.parametrize("win", [32, 48])
def test_pair_work_counts_the_live_pairs(body, win):
    """_pair_work against a brute-force count over every pixel-face pair
    of the fixture's bodies, in numpy: the pairs of active (cell, chunk)
    pairs (the 4-scalar chunk_active test written out) whose coverage
    term d|d| inv_blur lies below X_LIVE, those with d <= 0, and the
    (body, row, face) triples with a live pair. The live pairs are a
    strict part of the active cells' pairs."""
    st, items = _planes_inputs(body, win)
    args = [_jax_tables(fuv, fz, st) for fuv, fz in items]
    reach = args[0][1]
    tab, agg = TC._fold_pack(*[
        t(np.stack([np.asarray(a[0][i]) for a in args]),
          torch.bool if args[0][0][i].dtype == jnp.bool_ else torch.float32)
        for i in range(6)], reach)
    inv_blur = 1.0 / st.sil_blur_px2
    lists, bounds = TC._strip_chunk_lists(agg, win)
    got = TC._pair_work(tab, agg, lists, bounds, win, inv_blur)

    tb, ag = n(tab), n(agg)
    p = np.arange(win * win)
    px = (p % win).astype(np.float32) + np.float32(0.5)
    py = (p // win).astype(np.float32) + np.float32(0.5)
    xw = win // TC._n_xb(win)
    x_lo = ((p % win) // xw * xw).astype(np.float32)[None, :, None]
    y_lo = ((p // win) // 8 * 8).astype(np.float32)[None, :, None]
    a = np.repeat(ag, TC.FACE_CHUNK, axis=1)[:, None]     # (B, 1, F_pad, 4)
    act = ((a[..., 0] < x_lo + xw) & (a[..., 1] >= x_lo)
           & (a[..., 2] < y_lo + 8) & (a[..., 3] >= y_lo))
    x, y = px[None, :, None], py[None, :, None]

    def row(r):
        return tb[:, r][:, None, :]

    d0, d1, d2 = (row(3 * k) * x + row(3 * k + 1) * y + row(3 * k + 2)
                  for k in range(3))
    bb = np.maximum(np.maximum(row(12) - x, x - row(13)),
                    np.maximum(row(14) - y, y - row(15)))
    d = np.maximum(np.maximum(d0, np.maximum(d1, d2)), bb)
    live = act & ((d * np.abs(d)) * np.float32(inv_blur) < TC.X_LIVE)
    B, F_pad = tb.shape[0], tb.shape[2]
    ref = (int(live.sum()), int((act & (d <= 0)).sum()),
           int(live.reshape(B, win, win, F_pad).any(2).sum()))
    assert got == ref
    assert 0 < ref[1] < ref[0] < int(act.sum()) and ref[2] > 0


@pytest.mark.parametrize("win", [80, 112, 120, 128, 160])
def test_chunk_cells_match_cell_major_schedule(win):
    """The backward kernel's chunk-major cells (_chunk_cells, from the
    aggregates alone) are exactly the (cell, chunk) pairs the forward's
    cell-major schedule visits (_strip_chunk_lists + chunk_active): on
    full-size preordered bodies with an all-invalid chunk, at the main
    path's windows and at 120 px (20-px cells), and on random
    aggregates whose edges sit on and one ulp beside cell borders."""
    agg = _full_body_agg(win)
    rng = np.random.RandomState(win)
    nc = agg.shape[1]
    xw = win // TC._n_xb(win)
    edges = np.concatenate([np.arange(-1, win + 2) * w for w in (xw, 8)])
    a = rng.choice(edges, (2, nc, 4)).astype(np.float32)
    a = np.where(rng.rand(2, nc, 4) < 0.5, a,
                 np.nextafter(a, np.where(rng.rand(2, nc, 4) < 0.5,
                                          np.float32(-np.inf),
                                          np.float32(np.inf))))
    a[0, :3] = [TC.BIG, -TC.BIG, TC.BIG, -TC.BIG]
    agg = torch.cat([agg, t(a)])
    lists, bounds = TC._strip_chunk_lists(agg, win)
    ref = TC._active_pairs(agg, lists, bounds, win)
    cells = TC._chunk_cells(agg, win)
    got = _rect_mask(cells, win)
    assert torch.equal(got, ref)
    assert int(ref[:3].sum()) > 3 * nc                 # the bodies' pairs
    assert not ref[0, :, 1].any() and not got[0, :, 1].any()
    assert bool((cells[0, 1, 0] > cells[0, 1, 1])
                | (cells[0, 1, 2] > cells[0, 1, 3]))

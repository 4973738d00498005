"""The raster's face set-up (ops/face_setup.py) on the CPU: the plain
versions of its two kernels against the torch chain, its incidence CSR,
and the raster Function's CPU stages against the chain's path.

The forward's plain version is the chain itself
(`face_setup.face_tables`: the face gather and `face_planes` in
`face_extents`, then `_tables`); its tables are held bit for bit to the
fold written column by column, as the kernel computes it. The
backward's plain version (the analytic derivative summed per vertex
over the CSR) must give the chain's autograd gradient, to rounding.
Cases: windows 160/128 on the full body, a padded last chunk (a
656-face body), and faces with a zero-length edge, a zero area, all
corners behind znear or one of them.
"""

import functools

import numpy as np
import pytest
import torch

from torch_parity import degenerate_faces, rel_err

from mhmocap_tpu_torch.models.smpl import smpl_forward
from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch.ops import face_setup as FS
from mhmocap_tpu_torch.ops import raster_cuda as RC
from mhmocap_tpu_torch.ops import rasterizer as TR
from mhmocap_tpu_torch.ops.cameras import intrinsics_from_fov
from mhmocap_tpu_torch.workload import posed_uvz

CASES = ("posed", "zero_edge", "zero_area", "behind", "straddle")
# (vertices of the synthetic body, window): the full body at the fit's
# two windows, and a body whose 656 faces leave a padded last chunk
BODIES = ((6890, 160), (6890, 128), (512, 160))


@functools.lru_cache(maxsize=None)
def _body(n_vertices):
    return TR.preorder_faces(make_synthetic_smpl(
        **({} if n_vertices == 6890 else {"num_vertices": n_vertices,
                                          "seed": 1})))


def _inputs(n_vertices, win, case, dtype=torch.float32):
    """(uvz (3, V, 3), origin, faces, settings): three posed bodies at
    the depth that fills `win` in a 256x256 image, with the case on
    three faces (one in the last chunk)."""
    model = _body(n_vertices)
    uvz, _, st = posed_uvz(model, win, 3, win + n_vertices, "cpu")
    uvz = degenerate_faces(uvz.to(dtype), model.faces, case)
    origin = TR.window_origin(uvz[..., :2], uvz[..., 2], st)
    return uvz, origin, model.faces, st


def _reach_y(st):
    return 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0


def _chain_tables(uvz, origin, faces, st):
    """The chain the kernels replace on the card, up to the tables."""
    return FS.face_tables(uvz, origin, faces, st.znear,
                          1.0 / st.sil_blur_px2, _reach_y(st))


def _column_fold(uvz, origin, faces, st):
    """The tables as the forward kernel writes them, column by column:
    each column keeps face_planes' value where its face's flag holds
    (silhouette: edges and bbox; depth: z plane) and takes the fold's
    constant elsewhere and on the padding faces; agg reduces each
    chunk's silhouette-valid bboxes, x extents shifted by the reach,
    y extents by reach_y."""
    planes, (bbox, _, _, oks, okd) = FS.face_extents(uvz, origin, faces,
                                                     st.znear, _reach_y(st))
    B, Fn = planes.shape[:2]
    pad = -(-Fn // RC.FACE_CHUNK) * RC.FACE_CHUNK - Fn
    cols = torch.cat([planes, bbox], -1)
    cols = torch.cat([cols, cols.new_zeros((B, pad, 16))], 1)
    oks = torch.cat([oks, oks.new_zeros((B, pad))], 1)
    okd = torch.cat([okd, okd.new_zeros((B, pad))], 1)
    ok = torch.stack([oks] * 9 + [okd] * 3 + [oks] * 4, -1)
    big = RC.BIG
    fold = torch.tensor([0, 0, RC.D_INVALID, 0, 0, 0, 0, 0, 0, 0, 0,
                         -RC.D_INVALID, -big, big, -big, big],
                        dtype=uvz.dtype)
    tab = torch.where(ok, cols, fold).transpose(1, 2)

    def chunks(v, empty, red):
        v = torch.where(oks, v, torch.full((), empty, dtype=uvz.dtype))
        return red(v.reshape(B, -1, RC.FACE_CHUNK), dim=-1)
    bb, reach_x, reach_y = cols[..., 12:], RC._reach(1.0 / st.sil_blur_px2), \
        _reach_y(st)
    agg = torch.stack([chunks(bb[..., 0], big, torch.amin) - reach_x,
                       chunks(bb[..., 1], -big, torch.amax) + reach_x,
                       chunks(bb[..., 2] - reach_y, big, torch.amin),
                       chunks(bb[..., 3] + reach_y, -big, torch.amax)], -1)
    return tab, agg


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_vertices,win", BODIES)
def test_fwd_plain_equals_chain(n_vertices, win, case):
    """The forward's plain version, the chain's tables, equals the fold
    written column by column bit for bit, padding faces and folded faces
    included."""
    uvz, origin, faces, st = _inputs(n_vertices, win, case)
    tab, agg = _chain_tables(uvz, origin, faces, st)
    ref_tab, ref_agg = _column_fold(uvz, origin, faces, st)
    assert torch.equal(tab, ref_tab) and torch.equal(agg, ref_agg)
    F_pad = tab.shape[2]
    assert F_pad % RC.FACE_CHUNK == 0 and F_pad >= faces.shape[0]
    assert (F_pad > faces.shape[0]) == (n_vertices == 512)
    if case in ("behind", "straddle"):
        # some face folded to the invalid marks
        assert bool((tab[:, 2, :faces.shape[0]] == RC.D_INVALID).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_vertices,win", BODIES)
def test_bwd_plain_matches_chain_autograd(n_vertices, win, case, dtype):
    """The backward's plain version against autograd through the chain
    (the gather, face_planes and the fold) at random table cotangents:
    to 1e-12 relative norm in float64 and 1e-6 in float32 (the analytic
    derivative rounds in another order than autograd's graph; the gaps
    measured at most 5e-16 and 1.9e-7)."""
    uvz, origin, faces, st = _inputs(n_vertices, win, case, dtype)
    rng = np.random.RandomState(win + len(case))
    F_pad = -(-faces.shape[0] // RC.FACE_CHUNK) * RC.FACE_CHUNK
    dtab = torch.as_tensor(rng.randn(uvz.shape[0], F_pad, 12), dtype=dtype)
    x = uvz.clone().requires_grad_(True)
    tab, _ = _chain_tables(x, origin, faces, st)
    ref, = torch.autograd.grad(tab[:, :12], x, dtab.transpose(1, 2))
    got = FS.face_setup_bwd_plain(dtab, uvz, origin, faces, st.znear)
    assert got.dtype == dtype and got.shape == uvz.shape
    assert rel_err(got, ref) < (1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.parametrize("n_vertices", [6890, 512])
def test_incidence_lists_each_corner_once_ascending(n_vertices):
    """The CSR holds every (face, corner) once, each vertex's in
    ascending 3 f + corner order, and the faces as int32; a face index
    outside the vertices raises."""
    faces = _body(n_vertices).faces
    f32, ptr, inc = FS.incidence(faces, n_vertices, torch.device("cpu"))
    assert f32.dtype == ptr.dtype == inc.dtype == torch.int32
    assert torch.equal(f32.long(), faces)
    assert int(ptr[0]) == 0 and int(ptr[-1]) == 3 * faces.shape[0]
    assert torch.equal(torch.sort(inc.long()).values,
                       torch.arange(3 * faces.shape[0]))
    flat = faces.reshape(-1)
    for v in range(n_vertices):
        own = inc[ptr[v]:ptr[v + 1]].long()
        assert bool((flat[own] == v).all())
        assert bool((own[1:] > own[:-1]).all())
    assert FS.incidence(faces, n_vertices, torch.device("cpu"))[2] is inc
    with pytest.raises(ValueError, match="outside"):
        FS.incidence(faces.clone(), int(faces.max()), torch.device("cpu"))


@pytest.mark.parametrize("win", [160, 128])
def test_rasterize_bodies_cpu_keeps_the_chain(win):
    """On CPU tensors rasterize_bodies launches nothing of the set-up,
    and its zbuf, sil and vertex gradient equal bit for bit those of the
    chain's path built from its parts: face_extents with autograd, the
    fold and the plain forward without, the plain backward, then
    autograd through the planes."""
    model = _body(512)
    faces = model.faces
    st = TR.RasterSettings(image_size=(256, 256), window=win)
    rng = np.random.RandomState(win)
    with torch.no_grad():
        v = smpl_forward(model, torch.zeros((3, 10)),
                         torch.as_tensor(0.1 * rng.randn(3, 72),
                                         dtype=torch.float32),
                         transl=torch.as_tensor([[0, 0, 3.4 * 160 / win]] * 3,
                                                dtype=torch.float32))["verts"]
    K = torch.as_tensor(intrinsics_from_fov((256, 256), 60.0))
    w_s, w_z = (torch.as_tensor(rng.randn(3, win, win), dtype=torch.float32)
                for _ in range(2))

    def loss(z, s):
        return (torch.sum(w_s * s)
                + torch.sum(w_z * torch.where(torch.isfinite(z), z, 0.0)))

    before = dict(FS.launches)
    x = v.clone().requires_grad_(True)
    got = TR.rasterize_bodies(x, faces, K, st)
    loss(got["zbuf"], got["sil"]).backward()
    assert dict(FS.launches) == before

    y = v.clone().requires_grad_(True)
    inv_blur = 1.0 / st.sil_blur_px2
    uvz = TR.project_points(y, K, return_depth=True)
    origin = TR.window_origin(uvz[..., :2], uvz[..., 2], st)
    planes, ext = FS.face_extents(uvz, origin, faces, st.znear, _reach_y(st))
    with torch.no_grad():
        tab, _ = RC._tables(planes, *ext, inv_blur)
        zmin, logkeep, amin = RC.raster_fwd_plain(tab, win, inv_blur,
                                                  st.znear)
        z, s = RC._window_outputs(zmin, logkeep)
    z, s = z.requires_grad_(True), s.requires_grad_(True)
    d_z, d_lk = RC._cotangents(*torch.autograd.grad(loss(z, s), (z, s)),
                               logkeep, amin)
    dtab = RC.raster_bwd_plain(tab, d_z, d_lk, amin, win, inv_blur)
    planes.backward(dtab[:, :faces.shape[0]])
    assert torch.equal(got["zbuf"], z) and torch.equal(got["sil"], s)
    assert torch.equal(got["origin"], origin)
    assert bool((x.grad != 0).any()) and torch.equal(x.grad, y.grad)

"""GPU tests of the port's raster kernels (marked `cuda`; they skip
without an NVIDIA GPU).

This file imports torch and the port only, so it also runs where JAX is
not installed. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from torch_parity import n, rel_err, t

from mhmocap_tpu_torch.models.smpl import smpl_forward
from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch.ops import raster_cuda as TC, rasterizer as TR
from mhmocap_tpu_torch.ops.cameras import intrinsics_from_fov


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tables(dev, win, seed):
    model = make_synthetic_smpl(device=dev)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        v = smpl_forward(model, torch.zeros((3, 10), device=dev),
                         t(0.1 * rng.randn(3, 72)).to(dev),
                         t([[0, 0.3, 3.0]] * 3).to(dev))["verts"]
        st = TR.RasterSettings(image_size=(96, 96), window=win)
        K = t(intrinsics_from_fov((96, 96), 60.0)).to(dev)
        uvz = TR.project_points(v, K, return_depth=True)
        origin = TR.window_origin(uvz[..., :2], uvz[..., 2], st)
        fuvz = uvz[:, model.faces]
        planes, bbox, oks, okd = TR.face_planes(
            fuvz[..., :2] - origin[:, None, None].float(), fuvz[..., 2],
            st.znear)
        reach = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
        inv_blur = 1.0 / st.sil_blur_px2
        tab, agg = TC._tables(planes, bbox, bbox[..., 2] - reach,
                              bbox[..., 3] + reach, oks, okd, inv_blur)
        lists, bounds = TC._strip_chunk_lists(agg, win)
    return tab, agg, lists, bounds, inv_blur, rng


@pytest.mark.cuda
@pytest.mark.parametrize("win", [48, 64, 96])
def test_cuda_kernels_match_plain(cuda_device, win):
    """Both kernels against their plain version on the same tables of 3
    full-size bodies: z-buffer and winners exact (same operation order,
    no FMA contraction), log-coverage to 1e-5 relative (sums of up to
    hundreds over the faces, in another order), d_planes to 1e-5
    relative norm (the atomics sum in another order)."""
    tab, agg, lists, bounds, inv_blur, rng = _tables(cuda_device, win, win)
    before = dict(TC.RasterPlanes.launches)
    zk, lk, ak = TC.raster_fwd_cuda(tab, agg, lists, bounds, win, inv_blur,
                                    1.0)
    zp, lp, ap = TC.raster_fwd_plain(tab, win, inv_blur, 1.0)
    assert bool((zk < TC.BIG).any())
    assert torch.equal(zk, zp) and torch.equal(ak, ap)
    assert torch.allclose(lk, lp, rtol=1e-5, atol=1e-5)
    dz = t(rng.randn(3, win, win)).to(cuda_device)
    dlk = t(rng.randn(3, win, win)).to(cuda_device)
    gk = TC.raster_bwd_cuda(tab, agg, lists, bounds, dz, dlk, ak, win,
                            inv_blur)
    gp = TC.raster_bwd_plain(tab, dz, dlk, ak, win, inv_blur)
    assert rel_err(n(gk), n(gp)) < 1e-5
    assert TC.RasterPlanes.launches["fwd"] == before["fwd"] + 1
    assert TC.RasterPlanes.launches["bwd"] == before["bwd"] + 1


@pytest.mark.cuda
def test_cuda_autograd_function_matches_cpu(cuda_device):
    """rasterize_bodies on the card (kernels) against the same call on
    the CPU (plain version), on the same vertices: sil to 1e-5, vertex
    gradients to 1e-4 relative norm (rsqrt and the plane and pixel sums
    round differently on the two devices)."""
    rng = np.random.RandomState(1)
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    st = TR.RasterSettings(image_size=(96, 96), window=64)
    v = smpl_forward(model, torch.zeros((2, 10)),
                     t(0.1 * rng.randn(2, 72)), t([[0, 0.3, 3.0]] * 2))["verts"]
    K = t(intrinsics_from_fov((96, 96), 60.0))
    grads, outs = {}, {}
    for dev in ("cpu", "cuda"):
        vv = v.detach().to(dev).requires_grad_(True)
        o = TR.rasterize_bodies(vv, model.faces.to(dev), K.to(dev), st)
        zb = torch.where(torch.isfinite(o["zbuf"]), o["zbuf"],
                         torch.zeros_like(o["zbuf"]))
        (torch.sum(o["sil"] ** 2) + 0.1 * torch.sum(zb)).backward()
        grads[dev], outs[dev] = n(vv.grad), n(o["sil"])
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-5)
    assert rel_err(grads["cuda"], grads["cpu"]) < 1e-4

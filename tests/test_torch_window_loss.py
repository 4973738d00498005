"""The chunk's window losses (`ops/window_loss.py`) on the CPU.

`WindowLosses` on CPU tensors runs the plain chain, which must be the
former inline block of `_chunk_loss_core` (kept as
`window_loss_cases.former_chain`) bit for bit: both scalars and the
gradients of every group's zbuf and sil and of min_z_c and max_z_c.
`window_loss_bwd_plain`,
the backward kernel's reference in its own order, is held to that
chain's autograd: each pixel's d_zbuf and d_sil bit for bit (the same
operations in autograd's order), d_min_z and d_max_z to 1e-5 relative
norm (the frame's window sums run in slot order, not over the scattered
frame). At ts1- and ts11-like shapes with C reduced, two people in one
group, and the edges `workload.window_loss_inputs` builds.
"""

import pytest
import torch

from torch_parity import n, rel_err
from window_loss_cases import SHAPES, former_chain, leaves, saved_of

from mhmocap_tpu_torch.ops import window_loss as WL
from mhmocap_tpu_torch.workload import window_loss_inputs as make_case

CASES = [("ts1", {}), ("ts11", {}), ("pair", {}),
         ("ts11", {"edges": False}), ("pair", {"no_dmask": True})]
IDS = ["ts1", "ts11", "pair", "ts11-plain", "pair-no-dmask"]
COTANGENTS = (0.75, -1.5)   # of loss_depth and loss_sil


def _grads(fn, groups, rasters, inputs, eps):
    losses = fn(groups, rasters, *inputs, eps)
    grads = torch.autograd.grad(
        losses, leaves(rasters, inputs),
        [torch.tensor(g) for g in COTANGENTS])
    return [x.detach() for x in losses], grads


def _function(groups, rasters, *inputs_eps):
    return WL.window_losses(groups, rasters, *inputs_eps)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_function_is_the_former_chain(name, kw):
    """The Function's CPU path: loss_depth, loss_sil and every gradient
    bit for bit the former inline block's (signed zeros included)."""
    case = make_case(SHAPES[name], seed=len(name), **kw)
    got, g_got = _grads(_function, *case)
    ref, g_ref = _grads(former_chain, *case)
    assert all(_same_bits(a, b) for a, b in zip(got, ref))
    assert all(_same_bits(a, b) for a, b in zip(g_got, g_ref))
    assert torch.isfinite(torch.stack(got)).all()
    if kw.get("no_dmask"):
        assert got[0].item() == 0.0
        assert not g_got[0].any() and not g_got[1].any()


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_bwd_plain_matches_autograd(name, kw):
    """`window_loss_bwd_plain` from the chain's saved rows against
    autograd through the chain: d_zbuf and d_sil bit for bit, d_min_z
    and d_max_z to 1e-5 relative norm."""
    groups, rasters, inputs, eps = make_case(SHAPES[name], seed=7, **kw)
    rows = []
    with torch.no_grad():
        former_chain(groups, rasters, *inputs, eps, rows=rows)
    _, ref = _grads(former_chain, groups, rasters, inputs, eps)
    d_zbufs, d_sils, d_min, d_max = WL.window_loss_bwd_plain(
        groups, [tuple(x.detach() for x in r) for r in rasters],
        *[x.detach() for x in inputs], eps, saved_of(rows),
        *[torch.tensor(g) for g in COTANGENTS])
    G = len(groups)
    assert all(_same_bits(a, b) for a, b in zip(d_zbufs, ref[2:2 + G]))
    assert all(_same_bits(a, b) for a, b in zip(d_sils, ref[2 + G:]))
    for got, want in ((d_min, ref[0]), (d_max, ref[1])):
        assert got.shape == want.shape
        if want.any():
            assert rel_err(n(got), n(want)) < 1e-5
        else:
            assert not got.any()


def test_clamps_pass_the_gradient_at_eps():
    """The two clamps pass the gradient at x == eps (torch's clamp
    backward is x >= min): a zbuf disparity of exactly eps, whose
    reciprocal clamp sits at 1 / eps, keeps its d_zbuf."""
    groups, rasters, inputs, eps = make_case(SHAPES["pair"], seed=3)
    zb = rasters[0][0].detach().clone()
    # zbuf + 0.2 == 1 / eps in float32: disparity eps exactly
    x = torch.tensor(1.0 / eps, dtype=torch.float32) - 0.2
    assert (x + 0.2).item() == torch.tensor(1.0 / eps).float().item()
    zb[0, 5, 5:40] = x
    rasters[0] = (zb.requires_grad_(), *rasters[0][1:])
    _, g_got = _grads(_function, groups, rasters, inputs, eps)
    _, g_ref = _grads(former_chain, groups, rasters, inputs, eps)
    assert all(_same_bits(a, b) for a, b in zip(g_got, g_ref))


def test_launchers_refuse_cpu_tensors():
    groups, rasters, inputs, eps = make_case(SHAPES["pair"], seed=1)
    rasters = [tuple(x.detach() for x in r) for r in rasters]
    inputs = [x.detach() for x in inputs]
    with pytest.raises(ValueError, match="CUDA tensors"):
        WL.window_loss_fwd_cuda(groups, rasters, *inputs, eps)
    with pytest.raises(ValueError, match="CUDA tensors"):
        WL.window_loss_bwd_cuda(groups, rasters, *inputs, eps, None,
                                None, None)


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version: the kernels' counters stay
    empty (no CUDA counter is made)."""
    case = make_case(SHAPES["ts11"], seed=2)
    _grads(_function, *case)
    assert dict(WL.launches) == {"fwd": 0, "bwd": 0}

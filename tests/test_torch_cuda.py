"""GPU tests of the port's raster kernels, its face set-up kernels, its
window-loss kernels, its fill-in kernel and its phase marks (marked
`cuda`; they skip without an NVIDIA GPU).

This file imports torch and the port only, so it also runs where JAX is
not installed. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from torch_parity import degenerate_faces, n, rel_err, t

from mhmocap_tpu_torch.models.smpl import smpl_forward
from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
from mhmocap_tpu_torch.ops import face_setup as FS
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
        inv_blur = 1.0 / st.sil_blur_px2
        tab, agg = FS.face_tables(uvz, origin, model.faces, st.znear,
                                  inv_blur,
                                  3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0)
    return tab, agg, inv_blur, rng


@pytest.mark.cuda
@pytest.mark.parametrize("win", [48, 64, 96])
def test_cuda_kernels_match_plain(cuda_device, win):
    """Both kernels against their plain version on the same tables of 3
    full-size bodies: z-buffer and winners exact (same operation order,
    no FMA contraction), log-coverage to 1e-5 relative (sums of up to
    hundreds over the faces, in another order), d_planes to 1e-5
    relative norm (the pixel sums run in another order); each kernel
    bit-identical from one launch to the next."""
    tab, agg, inv_blur, rng = _tables(cuda_device, win, win)
    before = dict(TC.launches)
    zk, lk, ak = TC.raster_fwd_cuda(tab, agg, win, inv_blur, 1.0)
    zp, lp, ap = TC.raster_fwd_plain(tab, win, inv_blur, 1.0)
    assert bool((zk < TC.BIG).any())
    assert torch.equal(zk, zp) and torch.equal(ak, ap)
    assert torch.allclose(lk, lp, rtol=1e-5, atol=1e-5)
    for a, b in zip(TC.raster_fwd_cuda(tab, agg, win, inv_blur, 1.0),
                    (zk, lk, ak)):
        assert torch.equal(a, b)
    dz = t(rng.randn(3, win, win)).to(cuda_device)
    dlk = t(rng.randn(3, win, win)).to(cuda_device)
    gk = TC.raster_bwd_cuda(tab, agg, dz, dlk, ak, win, inv_blur)
    gp = TC.raster_bwd_plain(tab, dz, dlk, ak, win, inv_blur)
    assert rel_err(n(gk), n(gp)) < 1e-5
    assert torch.equal(TC.raster_bwd_cuda(tab, agg, dz, dlk, ak, win,
                                          inv_blur), gk)
    assert TC.launches["fwd"] == before["fwd"] + 2
    assert TC.launches["bwd"] == before["bwd"] + 2


@pytest.mark.cuda
def test_cuda_log1p_shortcut_is_exact(cuda_device):
    """log1pf(e) == e bit for bit for every float e in [0, expf(-19)],
    so the forward kernel's -expf(-x) for x >= 20 is its log-sigmoid."""
    assert TC.log1p_shortcut_mismatches(cuda_device) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["Predictor", "load_sequence"])
def test_python_entry_points_default_to_the_card(cuda_device, tmp_path,
                                                 monkeypatch, entry):
    """Called without `device`, the Predictor fits on the card (its
    device, its body's tensors and the raster kernels' launches) and
    load_sequence decodes into card tensors."""
    from mhmocap_tpu_torch.data import ingestion
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.models.smpl import joints_function
    from mhmocap_tpu_torch.workload import bench_args, make_ts1_like_seq
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    if entry == "Predictor":
        seq, _ = make_ts1_like_seq(T=8, N=2, side=128, model=model)
        pred = Predictor(seq, model, str(tmp_path), bench_args(1, None, 64))
        assert pred.device.type == "cuda"
        assert pred.model.faces.device.type == "cuda"
        before = dict(TC.launches)
        pred.run(verbose=False)
        assert all(TC.launches[k] > before[k] for k in before)
        return
    generate_sequence(str(tmp_path / "TS1"), num_frames=4, num_people=2,
                      image_size=(96, 96), model=model, seed=3)
    seen, orig = [], ingestion.load_images

    def load_images(*a, **k):
        seen.append(torch.device(k["device"]))
        return orig(*a, **k)

    monkeypatch.setattr(ingestion, "load_images", load_images)
    seq = ingestion.load_sequence(str(tmp_path / "TS1"),
                                  joints_function(model, "joints_alphapose"),
                                  verbose=False)
    assert [d.type for d in seen] == ["cuda"]
    assert seq.num_frames == 4 and np.isfinite(seq.pose2d).all()


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


def _set_up_inputs(dev, win, edited):
    """The face set-up's inputs at the fit's call shape: 29 posed
    full-size bodies (faces preordered) at `win`; `edited` puts each of
    the degenerate cases on faces of its own, one in the last chunk."""
    from mhmocap_tpu_torch.workload import posed_uvz
    model = TR.preorder_faces(make_synthetic_smpl(device=dev))
    uvz, _, st = posed_uvz(model, win, 29, seed=win, device=dev)
    if edited:
        for k, case in enumerate(("zero_edge", "zero_area", "behind",
                                  "straddle")):
            uvz = degenerate_faces(uvz, model.faces, case,
                                   ids=(5 + k, 3000 + k, -1 - k))
    origin = TR.window_origin(uvz[..., :2], uvz[..., 2], st)
    reach_y = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
    return model.faces, uvz.contiguous(), origin, st, reach_y


@pytest.mark.cuda
@pytest.mark.parametrize("edited", [False, True])
@pytest.mark.parametrize("win", [160, 128])
def test_cuda_face_setup_matches_plain(cuda_device, win, edited):
    """Both set-up kernels against their plain version at B=29: tab and
    agg bit for bit (the same IEEE single operations in the same order,
    which are the torch chain's); d_uvz to 1e-6 relative norm (the same
    operations and sum order, but torch's rsqrt and the kernel's rsqrtf
    may round apart) and bit-identical from one launch to the next; one
    launch counted a call."""
    faces, uvz, origin, st, reach_y = _set_up_inputs(cuda_device, win,
                                                     edited)
    args = (uvz, origin, faces, st.znear, 1.0 / st.sil_blur_px2, reach_y)
    before = dict(FS.launches)
    tab, agg = FS.face_setup_fwd_cuda(*args)
    ptab, pagg = FS.face_tables(*args)
    assert torch.equal(tab, ptab) and torch.equal(agg, pagg)
    rng = np.random.RandomState(win)
    dtab = t(rng.randn(*tab.shape[::2], 12)).to(cuda_device)
    gk = FS.face_setup_bwd_cuda(dtab, uvz, origin, faces, st.znear)
    gp = FS.face_setup_bwd_plain(dtab, uvz, origin, faces, st.znear)
    assert torch.equal(FS.face_setup_bwd_cuda(dtab, uvz, origin, faces,
                                              st.znear), gk)
    assert rel_err(n(gk), n(gp)) < 1e-6
    assert dict(FS.launches) == {"fwd": before["fwd"] + 1,
                                 "bwd": before["bwd"] + 2}


@pytest.mark.cuda
def test_cuda_face_setup_graph_equals_eager(cuda_device):
    """rasterize_bodies' CUDA path (RasterFaces' kernels: the set-up pair
    and the raster pair) forward and backward at B=29, window 160, captured
    in a CUDA graph: a replay equals the eager call bit for bit (zbuf,
    sil, the vertex gradient) and counts one launch of each kernel."""
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    faces, uvz, origin, st, reach_y = _set_up_inputs(cuda_device, 160, True)

    def run(x):
        z, s = TR.RasterFaces.apply(x, origin, faces, st.window,
                                    1.0 / st.sil_blur_px2, st.znear, reach_y)
        loss = (torch.sum(s * s)
                + 0.1 * torch.sum(torch.where(torch.isfinite(z), z, 0.0)))
        return (z, s) + torch.autograd.grad(loss, x)

    # the graph's input is a leaf first used in the capture's warm-up, on
    # its side stream (as the fit's parameters are)
    x = uvz.clone().requires_grad_(True)
    out = []
    graph = capture_graph(lambda: out.append(run(x)), cuda_device)
    for v in out[-1]:
        v.fill_(-7)
    FS.launches.reset()
    TC.launches.reset()
    graph.replay()
    torch.cuda.synchronize()
    assert dict(FS.launches) == {"fwd": 1, "bwd": 1}
    assert dict(TC.launches) == {"fwd": 1, "bwd": 1}
    ref = run(uvz.clone().requires_grad_(True))
    assert all(torch.equal(a, b) for a, b in zip(out[-1], ref))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(40, 56), (72, 104)])
def test_cuda_fhsog_full_frame_window(cuda_device, monkeypatch, size):
    """build_fhsog_from_smpl on the card rasters each frame's bodies with
    the forward kernel at a full-frame window (56 -> 64, 104 -> 112:
    longer sides that are odd multiples of 8) and matches the same call
    on CPU tensors (the plain raster): smpl_masks equal, fog, GDFs and
    texture to rtol 1e-4."""
    from mhmocap_tpu_torch.engine import fhsog
    monkeypatch.setattr(fhsog, "FRAMES_PER_CALL", 2)
    H, W = size
    rng = np.random.RandomState(H)
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    T, N = 3, 2
    with torch.no_grad():
        v = smpl_forward(model, torch.zeros((T * N, 10)),
                         t(0.1 * rng.randn(T * N, 72)),
                         t([[-0.3, 0.3, 3.0], [0.35, 0.3, 3.5]] * T))["verts"]
    args = [t(4.0 + 2.0 * rng.rand(T, H, W)), t(255 * rng.rand(T, H, W, 3)),
            t((rng.rand(T, H, W) > 0.1).astype(np.float32)),
            v.reshape(T, N, -1, 3), model.faces,
            t(intrinsics_from_fov((W, H), 60.0))]
    before = TC.launches["fwd"]
    got = fhsog.build_fhsog_from_smpl(*[a.to(cuda_device) for a in args],
                                      1.0, 16.0, num_depth_bins=16)
    assert TC.launches["fwd"] == before + 2
    ref = fhsog.build_fhsog_from_smpl(*args, 1.0, 16.0, num_depth_bins=16)
    assert torch.equal(got[3].cpu(), ref[3]) and bool(ref[3].any())
    for k in (0, 1, 2, 4):
        np.testing.assert_allclose(n(got[k]), n(ref[k]), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager(cuda_device):
    """A CycleGraph on the card (one captured graph per variant, the
    cadence shrunk to warmup 2 / filter refresh every 3, so cycles 0-6
    run every variant, all captured by `prepare` before cycle 0 on a
    snapshot of the state) against the eager stage1_cycle_eager loop
    from the same init: every cycle's loss and parts, the final params
    and RMSprop state bit-identical; every cycle, a replay, launches
    each raster and face set-up kernel once a chunk a window group
    (counted by the kernels); the init solve's graph equals its eager
    loop."""
    import dataclasses
    import tempfile
    from mhmocap_tpu_torch.engine import cycle_graph as CG
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.workload import bench_args, make_ts1_like_seq
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    seq, _ = make_ts1_like_seq(T=8, N=2, side=128, model=model)
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, 64),
                         device=cuda_device)
    cfg = dataclasses.replace(pred.cfg, warmup_cycles=2,
                              update_filters_every=3)
    m, coefs = pred.model, pred.coefs
    params, _, _ = E.init_params(m, seq.pose2d, seq.poses_smpl,
                                 seq.betas_smpl, seq.cam["K"], cfg)
    data = E.prepare_seq_data(seq, cfg, cuda_device)
    aux = E.init_aux(cfg, m.num_vertices, params.betas.clone())
    p, st, a, losses = params, E.rmsprop_init(params), aux, []
    for c in range(7):
        p, st, a, loss, parts = E.stage1_cycle_eager(p, st, a, c, m, data,
                                                     coefs, cfg)
        losses.append(torch.cat([loss[None], parts]))
    g = CG.CycleGraph(params, E.rmsprop_init(params), aux, m, data, coefs,
                      cfg, num_cycles=7)
    per_replay = len(cfg.window_groups) * cfg.num_chunks
    g.prepare(0, 7)
    assert len(g.graphs) == 4
    for c in range(7):
        TC.launches.reset()
        FS.launches.reset()
        g.replay(c)
        assert dict(TC.launches) == {"fwd": per_replay,
                                                  "bwd": per_replay}, c
        assert dict(FS.launches) == {"fwd": per_replay,
                                     "bwd": per_replay}, c
    assert len(g.graphs) == 4
    assert torch.equal(torch.cat([g.state.losses[:, None], g.state.parts],
                                 1), torch.stack(losses))
    for x, y in zip(CG.tree_leaves((g.state.params, g.state.nu,
                                    g.state.trace)),
                    CG.tree_leaves((p, st.nu, st.trace))):
        assert torch.equal(x, y)
    args = [torch.as_tensor(np.asarray(x, np.float32), device=cuda_device)
            for x in (seq.pose2d, seq.poses_smpl, seq.betas_smpl,
                      seq.cam["K"])] + [torch.zeros((1, 2, 1, 1),
                                                    device=cuda_device)]
    for x, y in zip(CG.init_global_poses_fused(m, *args),
                    E.init_global_poses(m, *args)):
        assert torch.equal(x, y)


def _device_ops(fn):
    """The device operations (start us, end us, name) `fn` runs, in time
    order, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA), key=lambda r: r[0])


@pytest.mark.cuda
def test_cuda_phase_marks_in_graphs(cuda_device):
    """Two CycleGraphs from one init on the card, phase marks off and on,
    every variant captured before cycle 0 (the cadence shrunk to warmup
    2 / filter refresh every 3): the same losses, parts, params and
    RMSprop state bit for bit; each replay fills its own ring row, every
    slot stamped and non-decreasing, and no other row; a profiled replay
    of each variant launches the unmarked graph's device operations plus
    one mark a stamped slot, and `phase_marks.split` cuts it into the
    slot table's phases, whose launches add up to the unmarked ones."""
    import dataclasses
    import tempfile
    from mhmocap_tpu_torch.engine import cycle_graph as CG
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.ops import phase_marks as PM
    from mhmocap_tpu_torch.workload import bench_args, make_ts1_like_seq
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    seq, _ = make_ts1_like_seq(T=8, N=2, side=128, model=model)
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, 64),
                         device=cuda_device)
    cfg = dataclasses.replace(pred.cfg, warmup_cycles=2,
                              update_filters_every=3)
    m, coefs = pred.model, pred.coefs
    params, _, _ = E.init_params(m, seq.pose2d, seq.poses_smpl,
                                 seq.betas_smpl, seq.cam["K"], cfg)
    data = E.prepare_seq_data(seq, cfg, cuda_device)
    aux = E.init_aux(cfg, m.num_vertices, params.betas.clone())
    n = 11
    off, on = (CG.CycleGraph(params, E.rmsprop_init(params), aux, m, data,
                             coefs, cfg, num_cycles=n, phase_marks=marks)
               for marks in (False, True))
    for g in (off, on):
        g.prepare(0, n)
    assert len(on.graphs) == len(off.graphs) == 4
    slots = len(PM.slot_names(cfg.num_chunks))
    for c in range(7):
        assert off.replay(c) == on.replay(c)
        ring = on.state.ring.cpu()
        assert (ring[c] > 0).all() and (ring[c].diff() >= 0).all(), c
        assert (ring[c + 1:] == -1).all(), c
        assert ring.shape == (n, slots)
    assert torch.equal(on.state.losses, off.state.losses)
    assert torch.equal(on.state.parts, off.state.parts)
    for x, y in zip(CG.tree_leaves((on.state.params, on.state.nu,
                                    on.state.trace, on.state.count)),
                    CG.tree_leaves((off.state.params, off.state.nu,
                                    off.state.trace, off.state.count))):
        assert torch.equal(x, y)
    for c in range(7, n):
        v = off.variants(c, c + 1)[0]
        ops_off = _device_ops(lambda: off.replay(c))
        ops_on = _device_ops(lambda: on.replay(c))
        order = on.mark_order[v]
        marks = [o for o in ops_on if PM.KERNEL in o[2]]
        assert len(marks) == len(order) and order[0] == "start"
        assert ([o[2] for o in ops_on if PM.KERNEL not in o[2]]
                == [o[2] for o in ops_off]), v
        cut, = PM.split(ops_on, [order])
        assert set(cut) == set(order[1:]), v
        assert sum(p.launches for p in cut.values()) == len(ops_off)
        assert all(cut[f"forward{i}"].launches > 0
                   and cut[f"backward{i}"].launches > 0
                   for i in range(cfg.num_chunks))


def _fillin_case(case):
    """(x, mask, k) on the CPU: holes at k = 7 over a batch, the k = 11
    scene channels, the cap binding at k = 3, and special values."""
    rng = np.random.RandomState(len(case))
    if case == "batch_k7":
        x = rng.rand(5, 96, 80).astype(np.float32)
        m = (rng.rand(5, 96, 80) > 0.3).astype(np.float32)
        m[1, 20:60, 10:70] = 0
        m[2] = 0
        m[3] = 1
        m[4, 0, 0] = np.nan
        return x, m, 7
    if case == "channels_k11":
        x = (255 * rng.rand(3, 64, 72)).astype(np.float32)
        m = np.ones((3, 64, 72), np.float32)
        m[:, 10:50, 20:60] = 0
        return x, m, 11
    if case == "cap_k3":
        x = rng.rand(150, 150).astype(np.float32)
        m = np.zeros((150, 150), np.float32)
        m[:3] = 1
        return x, m, 3
    pool = np.array([0.0, -0.0, 1.0, np.inf, -np.inf, np.nan, 3.4e38],
                    np.float32)
    x = pool[rng.randint(0, len(pool), (40, 40))]
    m = (rng.rand(40, 40) > 0.4).astype(np.float32)
    m[rng.rand(40, 40) < 0.05] = 0.5
    return x, m, 5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["batch_k7", "channels_k11", "cap_k3",
                                  "special"])
def test_cuda_fillin_matches_plain(cuda_device, case):
    """The fill-in kernel against its plain version on the card: x and
    m bit for bit (int32 views), the pixels each round filled equal to
    the plain version's counts (0 from its stop on), one call and
    max_iters round launches counted, and a CUDA graph replay of the
    call bit-identical to the eager launch."""
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    from mhmocap_tpu_torch.ops.image import fillin_masked, fillin_plain
    x, m, k = (t(a).to(cuda_device) if isinstance(a, np.ndarray) else a
               for a in _fillin_case(case))
    px, pm, filled = fillin_plain(x, m, k)
    FC.launches.reset()
    kx, km, per_round = FC.fillin_cuda(x, m, k)
    counts = dict(FC.launches)
    assert counts["calls"] == 1 and counts["rounds"] == 64
    assert counts["live"] == min(len(filled), 64)
    for a, b in ((kx, px), (km, pm)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = filled + [0] * (64 - len(filled))
    assert per_round.cpu().tolist() == want
    wx, wm = fillin_masked(x, m, k)
    assert torch.equal(wx.view(torch.int32), kx.view(torch.int32))
    out = {}

    def body():
        out["r"] = FC.fillin_cuda(x, m, k)

    graph = capture_graph(body, cuda_device)
    for a in out["r"]:
        a.fill_(-7)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out["r"], (kx, km, per_round)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _window_loss_case(device, cell, seed):
    from mhmocap_tpu_torch.workload import (WINDOW_LOSS_SHAPES,
                                            window_loss_inputs)
    return window_loss_inputs(WINDOW_LOSS_SHAPES[cell], seed, device)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ts1-fit", "ts11-fit"])
def test_cuda_window_loss_matches_plain(cuda_device, cell):
    """The window-loss kernel pair against its plain version at the
    benchmark cells' chunk shapes (29 frames, 2 people, 256x256, windows
    160/128; 39 frames, 3 people, 240x135, windows 112/80/64), on the
    edges `make_case` builds. Forward: the saved n_pix and n_keep exact
    (sums of 0/1), the saved diffs to 1e-5 relative norm and the two
    scalars to 1e-5 relative (the window sums run in another order).
    Backward, from the kernel's own saved rows: each pixel's d_zbuf and
    d_sil bit for bit `window_loss_bwd_plain`'s (the same IEEE
    operations in autograd's order), d_min_z and d_max_z to 1e-5
    relative norm (block sums against torch's). Two launches of each
    kernel bit-identical; two launches counted a call each way."""
    from window_loss_cases import former_chain, saved_of
    from mhmocap_tpu_torch.ops import window_loss as WL
    groups, rasters, inputs, eps = _window_loss_case(cuda_device, cell, 11)
    rasters = [tuple(x.detach() for x in r) for r in rasters]
    inputs = [x.detach() for x in inputs]
    before = dict(WL.launches)
    ld, ls, saved = WL.window_loss_fwd_cuda(groups, rasters, *inputs, eps)
    rows = []
    pd, ps = former_chain(groups, rasters, *inputs, eps, rows=rows)
    ref = saved_of(rows)
    assert torch.equal(saved[:, 0], ref[:, 0])
    assert torch.equal(saved[:, 2], ref[:, 2])
    assert rel_err(n(saved[:, 1]), n(ref[:, 1])) < 1e-5
    assert torch.allclose(ld, pd, rtol=1e-5, atol=0)
    assert torch.allclose(ls, ps, rtol=1e-5, atol=0)
    again = WL.window_loss_fwd_cuda(groups, rasters, *inputs, eps)
    assert all(torch.equal(a, b) for a, b in zip(again, (ld, ls, saved)))
    cot = [torch.tensor(g, device=cuda_device) for g in (0.75, -1.5)]
    kz, ks, kmin, kmax = WL.window_loss_bwd_cuda(groups, rasters, *inputs,
                                                 eps, saved, *cot)
    pz, ps_, pmin, pmax = WL.window_loss_bwd_plain(groups, rasters, *inputs,
                                                   eps, saved, *cot)
    for a, b in zip(kz + ks, pz + ps_):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert rel_err(n(kmin), n(pmin)) < 1e-5
    assert rel_err(n(kmax), n(pmax)) < 1e-5
    again = WL.window_loss_bwd_cuda(groups, rasters, *inputs, eps, saved,
                                    *cot)
    for a, b in zip(again[0] + again[1] + [again[2], again[3]],
                    kz + ks + [kmin, kmax]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert dict(WL.launches) == {"fwd": before["fwd"] + 4,
                                 "bwd": before["bwd"] + 4}


@pytest.mark.cuda
def test_cuda_window_loss_graph_equals_eager(cuda_device):
    """`WindowLosses` forward and backward at ts11-fit's chunk shape
    captured in a CUDA graph: a replay equals the eager call bit for bit
    (both scalars and every gradient) and counts two launches each way;
    the Function's gradients are `window_loss_bwd_cuda`'s."""
    from window_loss_cases import leaves
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    from mhmocap_tpu_torch.ops import window_loss as WL
    groups, rasters, inputs, eps = _window_loss_case(cuda_device,
                                                     "ts11-fit", 5)

    def run():
        ld, ls = WL.window_losses(groups, rasters, *inputs, eps)
        grads = torch.autograd.grad(0.75 * ld - 1.5 * ls,
                                    leaves(rasters, inputs))
        return (ld, ls) + grads

    out = []
    graph = capture_graph(lambda: out.append(run()), cuda_device)
    for v in out[-1]:
        v.fill_(-7)
    WL.launches.reset()
    graph.replay()
    torch.cuda.synchronize()
    assert dict(WL.launches) == {"fwd": 2, "bwd": 2}
    ref = run()
    assert all(torch.equal(a, b) for a, b in zip(out[-1], ref))
    plain = [tuple(x.detach() for x in r) for r in rasters]
    _, _, saved = WL.window_loss_fwd_cuda(groups, plain,
                                          *[x.detach() for x in inputs], eps)
    cot = [torch.tensor(g, device=cuda_device) for g in (0.75, -1.5)]
    kz, ks, kmin, kmax = WL.window_loss_bwd_cuda(
        groups, plain, *[x.detach() for x in inputs], eps, saved, *cot)
    for a, b in zip(ref[2:], [kmin, kmax] + kz + ks):
        assert torch.equal(a, b)

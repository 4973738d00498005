"""A chunk's window losses: the depth and silhouette terms of the fit,
from each window group's raster outputs (zbuf, sil) to two scalars and
back, as a hand-written CUDA kernel pair and its plain torch version.

`WindowLosses` is the one autograd Function of the main path
(`engine/optimizer.py:_chunk_loss_core` calls it through
`window_losses`): on CUDA tensors its forward and backward launch the
kernels of `csrc/window_loss.cu` (its header says what each computes,
what bounds it and how the design answers), on CPU tensors it runs
`window_losses_plain` and autograd through it. Nothing falls back: the
launchers refuse CPU tensors. This module also holds:

  * `window_loss_bwd_plain`, the backward kernel's reference in the
    kernel's own order (per-pixel cotangents from the forward's saved
    per-body rows, then per-frame sums), which the CPU tests hold to
    the chain's autograd and the card to the kernel;
  * the launchers and `launches` (`cuda_lib.LaunchCounts`: each kernel
    counts its own launches on the device, two a forward and two a
    backward);
  * the load of the library (`cuda_lib.load_library`: nvcc for sm_90a
    into build/ at first use), bound with ctypes.

Inputs, as `_chunk_loss_core` builds them: `groups` is
`EngineConfig.window_groups` ((window, people), ...), `rasters` one
(zbuf, sil, origin) per group from `rasterize_bodies` (zbuf and sil
(C ng, win, win), origin (C ng, 2) int64 (x0, y0), frame-major);
depths_c (C, H, W); min_z_c, max_z_c (C, 1, 1); seg_c, seg_er_c
(C, N, H, W) float 0/1 masks; z (C, N) the detached root depths that
order the occlusion; dw and sil_gate (C, N). Gradients go to each
group's zbuf and sil and to min_z_c and max_z_c.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from .cuda_lib import LaunchCounts, build_library, load_library, stream_ptr

_SOURCES = ("window_loss.cu",)
_HEADERS = ("raster_common.cuh",)
MAX_GROUPS = 16     # window_loss.cu's limits
MAX_PEOPLE = 32
FRAME_PART = 16384  # pixels of a frame-count block
SAVED = 5           # a slot's saved row: n_pix, diff, n_keep, two terms

launches = LaunchCounts(("fwd", "bwd"))


# never evicted: a captured CUDA graph reads it at its address
@functools.cache
def _people(group: Tuple[int, ...], device) -> torch.Tensor:
    return torch.tensor(group, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Plain torch version (the chain autograd differentiates on the CPU)
# ---------------------------------------------------------------------------

def _window_index(origins, win):
    ar = torch.arange(win, device=origins.device)
    rows = origins[..., 1, None] + ar             # (C, N, win)
    cols = origins[..., 0, None] + ar
    return rows[..., :, None], cols[..., None, :]


def _gather_windows(imgs, origins, win):
    """imgs (C, N, H, W), origins (C, N, 2) -> (C, N, win, win)."""
    C, N = origins.shape[:2]
    rows, cols = _window_index(origins, win)
    c = torch.arange(C, device=imgs.device)[:, None, None, None]
    n = torch.arange(N, device=imgs.device)[None, :, None, None]
    return imgs[c, n, rows, cols]


def _gather_windows_shared(img_c, origins, win):
    """One image per frame shared by all people: img_c (C, H, W),
    origins (C, N, 2) -> (C, N, win, win)."""
    C = origins.shape[0]
    rows, cols = _window_index(origins, win)
    c = torch.arange(C, device=img_c.device)[:, None, None, None]
    return img_c[c, rows, cols]


def _keep(seg_c, z):
    """Occlusion keep masks (C, N, H, W): 0 where a person in front of
    p (nearer root, then lower index) covers the pixel."""
    C, N, H, W = seg_c.shape
    idx = torch.arange(N, device=seg_c.device)
    in_front = ((z[:, None, :] < z[:, :, None])
                | ((z[:, None, :] == z[:, :, None])
                   & (idx[None, None, :] < idx[None, :, None])))
    closer = torch.einsum("cpq,cqx->cpx", in_front.to(torch.float32),
                          seg_c.reshape(C, N, -1)).reshape(C, N, H, W)
    return 1.0 - (closer > 0).to(torch.float32)


def window_losses_plain(groups, rasters, depths_c, min_z_c, max_z_c, seg_c,
                        seg_er_c, z, dw, sil_gate, eps: float):
    """(loss_depth, loss_sil): the window depth term (log disparity
    means of the rendered and the target depth over each body's eroded
    mask) and the occlusion-ordered silhouette term, summed over the
    chunk's bodies group by group. The kernels' plain version."""
    C, N, H, W = seg_c.shape
    dev = seg_c.device
    f32 = torch.float32

    target_disp = (depths_c * (1.0 / min_z_c - 1.0 / max_z_c)
                   + 1.0 / max_z_c)

    keep = _keep(seg_c, z)
    n_keep = torch.sum(keep, dim=(2, 3)) + 1.0
    seg_keep_total = torch.sum(keep * seg_c, dim=(2, 3))

    loss_depth = torch.zeros((), device=dev)
    loss_sil = torch.zeros((), device=dev)
    for (win, group), (zbuf, sil, origin) in zip(groups, rasters):
        g = _people(group, dev)
        ng = len(group)
        zbuf = zbuf.reshape(C, ng, win, win)
        sil = sil.reshape(C, ng, win, win)
        origins = origin.reshape(C, ng, 2)

        target_win = _gather_windows_shared(target_disp, origins, win)
        seg_er_win = _gather_windows(seg_er_c[:, g], origins, win)
        zbuf_valid = torch.isfinite(zbuf)
        zbuf_safe = torch.where(zbuf_valid, zbuf, torch.ones_like(zbuf))
        zbuf_disp = 1.0 / torch.clamp(zbuf_safe + 0.2, min=eps)
        dmask = (zbuf_valid.to(f32) * seg_er_win
                 * dw[:, g][..., None, None])
        n_pix = torch.sum(dmask, dim=(2, 3)) + 1.0
        mean_pred = torch.sum(
            dmask * torch.log(torch.clamp(zbuf_disp, min=eps)),
            dim=(2, 3)) / n_pix
        mean_true = torch.sum(
            dmask * torch.log(torch.clamp(target_win, min=eps)),
            dim=(2, 3)) / n_pix
        loss_depth = loss_depth + torch.sum(
            torch.square(mean_pred - mean_true))

        keep_win = _gather_windows(keep[:, g], origins, win)
        seg_win = _gather_windows(seg_c[:, g], origins, win)
        in_win = torch.sum(torch.square(keep_win * (sil - seg_win)),
                           dim=(2, 3))
        seg_keep_win = torch.sum(keep_win * seg_win, dim=(2, 3))
        outside = seg_keep_total[:, g] - seg_keep_win
        loss_sil = loss_sil + torch.sum(
            sil_gate[:, g] * (in_win + outside) / n_keep[:, g])
    return loss_depth, loss_sil


def window_loss_bwd_plain(groups, rasters, depths_c, min_z_c, max_z_c,
                          seg_c, seg_er_c, z, dw, sil_gate, eps: float,
                          saved, g_depth, g_sil):
    """Plain version of the backward kernel: the cotangents g_depth,
    g_sil of (loss_depth, loss_sil) -> (d_zbufs, d_sils, d_min_z,
    d_max_z), a d_zbuf and a d_sil per group (C ng, win, win). `saved`
    (slots, 5) holds each body's (n_pix, diff, n_keep, ...) in slot
    order (group by group, frame by frame, person by person). Each
    pixel's cotangents take autograd's operations in its order; each
    frame sums its bodies' window sums in slot order."""
    C = seg_c.shape[0]
    dev = seg_c.device
    keep = _keep(seg_c, z)
    rmin, rmax = 1.0 / min_z_c, 1.0 / max_z_c
    d_zbufs, d_sils, sums = [], [], []
    slot = 0
    for (win, group), (zbuf, sil, origin) in zip(groups, rasters):
        g = _people(group, dev)
        ng = len(group)
        rows = saved[slot:slot + C * ng].reshape(C, ng, SAVED)
        slot += C * ng
        n_pix, diff, n_keep = rows[..., 0], rows[..., 1], rows[..., 2]
        kd = g_depth * (2.0 * diff)
        k_pred = (kd / n_pix)[..., None, None]
        k_true = (-kd / n_pix)[..., None, None]
        k_sil = (g_sil / n_keep * sil_gate[:, g])[..., None, None]
        zbuf = zbuf.reshape(C, ng, win, win)
        origins = origin.reshape(C, ng, 2)

        valid = torch.isfinite(zbuf)
        dmask = (valid.to(torch.float32)
                 * _gather_windows(seg_er_c[:, g], origins, win)
                 * dw[:, g][..., None, None])
        x2 = torch.where(valid, zbuf, torch.ones_like(zbuf)) + 0.2
        r = torch.reciprocal(torch.clamp(x2, min=eps))
        d_disp = torch.where(
            r >= eps, k_pred * dmask / torch.clamp(r, min=eps), 0.0)
        d_x2 = torch.where(x2 >= eps, -d_disp * (r * r), 0.0)
        d_zbufs.append(torch.where(valid, d_x2, 0.0).reshape(-1, win, win))

        keep_win = _gather_windows(keep[:, g], origins, win)
        e = keep_win * (sil.reshape(C, ng, win, win)
                        - _gather_windows(seg_c[:, g], origins, win))
        d_sils.append((k_sil * (2.0 * e) * keep_win).reshape(-1, win, win))

        depth_win = _gather_windows_shared(depths_c, origins, win)
        t = depth_win * (rmin - rmax)[..., None] + rmax[..., None]
        d_t = torch.where(t >= eps,
                          k_true * dmask / torch.clamp(t, min=eps), 0.0)
        sums.append(torch.stack([torch.sum(d_t * depth_win, dim=(2, 3)),
                                 torch.sum(d_t, dim=(2, 3))], -1))
    td = torch.zeros((C,), device=dev)
    tt = torch.zeros((C,), device=dev)
    for s in sums:
        for k in range(s.shape[1]):
            td = td + s[:, k, 0]
            tt = tt + s[:, k, 1]
    rmin, rmax = rmin.reshape(C), rmax.reshape(C)
    rr = rmax * rmax
    d_min_z = -td * (rmin * rmin)
    d_max_z = td * rr + -tt * rr
    return d_zbufs, d_sils, d_min_z.reshape(C, 1, 1), d_max_z.reshape(C, 1, 1)


# ---------------------------------------------------------------------------
# Build, load and launch
# ---------------------------------------------------------------------------

def build_kernels() -> Tuple[Path, str]:
    """Compile csrc/window_loss.cu into build/ unless it is built.
    Returns (path, nvcc's output); raises with the compiler's output if
    it fails."""
    return build_library("window_loss", _SOURCES, _HEADERS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("window_loss", _SOURCES, _HEADERS)
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.mhmocap_window_loss_fwd.argtypes = [
        i, p, p, p, p, p, p, p, p, p, p, p, p, q, q, p, p, i, i, i, i, f,
        p, p, p, p, p, p, p]
    lib.mhmocap_window_loss_fwd.restype = i
    lib.mhmocap_window_loss_bwd.argtypes = [
        i, p, p, p, p, p, p, p, p, p, p, p, p, p, p, q, q, p, p, i, i, i, i,
        f, p, p, p, p, p, p, p, p]
    lib.mhmocap_window_loss_bwd.restype = i
    return lib


def _check(name, x, shape, device, dtype=torch.float32, contiguous=True):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _args(groups, rasters, depths_c, min_z_c, max_z_c, seg_c, seg_er_c, z,
          dw, sil_gate, eps):
    """The launchers' shared arguments, checked: (the group arrays,
    then the frames' inputs, shapes and eps)."""
    dev = seg_c.device
    if dev.type != "cuda":
        raise ValueError("the window-loss kernels need CUDA tensors")
    C, N, H, W = seg_c.shape
    people = [n for _, group in groups for n in group]
    if len(groups) > MAX_GROUPS or len(people) > MAX_PEOPLE \
            or N > MAX_PEOPLE:
        raise ValueError(f"window losses: {len(groups)} groups of "
                         f"{len(people)} people ({N} a frame) exceed the "
                         f"kernels' {MAX_GROUPS} and {MAX_PEOPLE}")
    if not all(0 <= n < N for n in people):
        raise ValueError(f"window groups {groups} name people outside {N}")
    for (win, group), (zbuf, sil, origin) in zip(groups, rasters, strict=True):
        if win > min(H, W):
            raise ValueError(f"window {win} exceeds the {W}x{H} frame")
        B = C * len(group)
        for name, x in (("zbuf", zbuf), ("sil", sil)):
            _check(name, x, (B, win, win), dev)
        _check("origin", origin, (B, 2), dev, torch.int64)
    for name, x, shape in (
            ("depths_c", depths_c, (C, H, W)),
            ("min_z_c", min_z_c, (C, 1, 1)), ("max_z_c", max_z_c, (C, 1, 1)),
            ("seg_er_c", seg_er_c, seg_c.shape), ("dw", dw, (C, N)),
            ("sil_gate", sil_gate, (C, N))):
        _check(name, x, shape, dev)
    _check("z", z, (C, N), dev, contiguous=False)     # read at its strides
    ints = ctypes.c_int * len(groups)

    def ptrs(xs):
        return (ctypes.c_void_p * len(groups))(
            *[x.data_ptr() for x in xs])

    group_args = (len(groups), ints(*[w for w, _ in groups]),
                  ints(*[len(g) for _, g in groups]),
                  (ctypes.c_int * len(people))(*people),
                  ptrs([r[0] for r in rasters]), ptrs([r[1] for r in rasters]),
                  ptrs([r[2] for r in rasters]))
    frame_args = tuple(x.data_ptr() for x in (
        depths_c, min_z_c, max_z_c, seg_c, seg_er_c)) + (
        z.data_ptr(), z.stride(0), z.stride(1), dw.data_ptr(),
        sil_gate.data_ptr(), C, N, H, W, float(eps))
    return group_args, frame_args


def _slots(groups, C):
    return C * sum(len(g) for _, g in groups)


def window_loss_fwd_cuda(groups, rasters, depths_c, min_z_c, max_z_c, seg_c,
                         seg_er_c, z, dw, sil_gate, eps: float):
    """Launch the forward kernels -> (loss_depth, loss_sil, saved
    (slots, 5)), as `window_losses_plain`; counts two launches in
    `launches`."""
    group_args, frame_args = _args(groups, rasters, depths_c, min_z_c,
                                   max_z_c, seg_c, seg_er_c, z, dw, sil_gate,
                                   eps)
    dev = seg_c.device
    C, N, H, W = seg_c.shape
    S = _slots(groups, C)
    parts = -(-H * W // FRAME_PART)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    wsum, fcount, saved = new(S, 5), new(C * N * parts, 2), new(S, SAVED)
    loss_depth, loss_sil = new(), new()
    err = _library().mhmocap_window_loss_fwd(
        *group_args, *frame_args, wsum.data_ptr(), fcount.data_ptr(),
        saved.data_ptr(), loss_depth.data_ptr(), loss_sil.data_ptr(),
        launches.pointer("fwd", dev), stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"window-loss forward kernel launch failed: CUDA "
                           f"error {err}")
    return loss_depth, loss_sil, saved


def window_loss_bwd_cuda(groups, rasters, depths_c, min_z_c, max_z_c, seg_c,
                         seg_er_c, z, dw, sil_gate, eps: float, saved,
                         g_depth, g_sil):
    """Launch the backward kernels -> (d_zbufs, d_sils, d_min_z,
    d_max_z), as `window_loss_bwd_plain`; every entry written once, no
    atomics. Counts two launches in `launches`."""
    group_args, frame_args = _args(groups, rasters, depths_c, min_z_c,
                                   max_z_c, seg_c, seg_er_c, z, dw, sil_gate,
                                   eps)
    dev = seg_c.device
    C = seg_c.shape[0]
    S = _slots(groups, C)
    _check("saved", saved, (S, SAVED), dev)
    for name, g in (("g_depth", g_depth), ("g_sil", g_sil)):
        _check(name, g, (), dev)
    d_zbufs = [torch.empty_like(r[0]) for r in rasters]
    d_sils = [torch.empty_like(r[1]) for r in rasters]
    partial = torch.empty((S, 2), dtype=torch.float32, device=dev)
    d_min_z = torch.empty((C, 1, 1), dtype=torch.float32, device=dev)
    d_max_z = torch.empty((C, 1, 1), dtype=torch.float32, device=dev)
    grads = ctypes.c_void_p * len(groups)
    err = _library().mhmocap_window_loss_bwd(
        *group_args, grads(*[d.data_ptr() for d in d_zbufs]),
        grads(*[d.data_ptr() for d in d_sils]), *frame_args,
        saved.data_ptr(), g_depth.data_ptr(), g_sil.data_ptr(),
        partial.data_ptr(), d_min_z.data_ptr(),
        d_max_z.data_ptr(), launches.pointer("bwd", dev), stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"window-loss backward kernel launch failed: CUDA "
                           f"error {err}")
    return d_zbufs, d_sils, d_min_z, d_max_z


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

_INPUTS = 8   # depths_c, min_z_c, max_z_c, seg_c, seg_er_c, z, dw, sil_gate


class WindowLosses(torch.autograd.Function):
    """(loss_depth, loss_sil) of a chunk from its window groups' raster
    outputs; `apply(groups, eps, depths_c, min_z_c, max_z_c, seg_c,
    seg_er_c, z, dw, sil_gate, zbuf_0, sil_0, origin_0, zbuf_1, ...)`.

    On CUDA tensors the forward launches `window_loss_fwd_cuda` and the
    backward `window_loss_bwd_cuda`; on CPU tensors the forward runs
    `window_losses_plain` and the backward autograd through it, run
    again on the saved inputs. `window_loss_bwd_plain`, in the kernel's
    order, is that kernel's reference only: its per-frame sums round
    apart from the chain's autograd."""

    @staticmethod
    def forward(ctx, groups, eps, *tensors):
        ctx.groups, ctx.eps = groups, eps
        inputs, rasters = tensors[:_INPUTS], _triples(tensors[_INPUTS:])
        if inputs[3].is_cuda:
            loss_depth, loss_sil, saved = window_loss_fwd_cuda(
                groups, rasters, *inputs, eps)
            ctx.save_for_backward(saved, *tensors)
        else:
            loss_depth, loss_sil = window_losses_plain(groups, rasters,
                                                       *inputs, eps)
            ctx.save_for_backward(None, *tensors)
        return loss_depth, loss_sil

    @staticmethod
    def backward(ctx, g_depth, g_sil):
        saved, *tensors = ctx.saved_tensors
        inputs, rasters = tensors[:_INPUTS], _triples(tensors[_INPUTS:])
        if saved is not None:
            d_zbufs, d_sils, d_min_z, d_max_z = window_loss_bwd_cuda(
                ctx.groups, rasters, *inputs, ctx.eps, saved, g_depth, g_sil)
        else:
            with torch.enable_grad():
                depths_c, min_z_c, max_z_c, *rest = inputs
                min_z_c, max_z_c = (x.detach().requires_grad_()
                                    for x in (min_z_c, max_z_c))
                rasters = [(zb.detach().requires_grad_(),
                            sil.detach().requires_grad_(), origin)
                           for zb, sil, origin in rasters]
                losses = window_losses_plain(ctx.groups, rasters, depths_c,
                                             min_z_c, max_z_c, *rest, ctx.eps)
                G = len(rasters)
                grads = torch.autograd.grad(
                    losses, [min_z_c, max_z_c] + [r[0] for r in rasters]
                    + [r[1] for r in rasters], (g_depth, g_sil))
            d_min_z, d_max_z = grads[:2]
            d_zbufs, d_sils = grads[2:2 + G], grads[2 + G:]
        per_group = [x for d in zip(d_zbufs, d_sils) for x in (*d, None)]
        return (None, None, None, d_min_z, d_max_z, None, None, None, None,
                None, *per_group)


def _triples(xs):
    return [tuple(xs[i:i + 3]) for i in range(0, len(xs), 3)]


def window_losses(groups, rasters, depths_c, min_z_c, max_z_c, seg_c,
                  seg_er_c, z, dw, sil_gate, eps: float):
    """The chunk's (loss_depth, loss_sil) through `WindowLosses`:
    `rasters` holds one (zbuf, sil, origin) per (window, people) of
    `groups`."""
    return WindowLosses.apply(groups, eps, depths_c, min_z_c, max_z_c, seg_c,
                              seg_er_c, z, dw, sil_gate,
                              *[x for r in rasters for x in r])

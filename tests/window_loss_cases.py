"""Inputs of the window-loss tests and their oracle (torch only, so the
card's tests can import it where JAX is not installed).

`former_chain` is the window-loss block as `_chunk_loss_core` wrote it
inline before it became `ops.window_loss.WindowLosses`, kept here as
the oracle that the Function's plain path is held to bit for bit.
`workload.window_loss_inputs` builds a chunk's inputs with the edges
the kernels meet; SHAPES are ts1- and ts11-like chunks with C reduced
and a group of two people (the benchmark cells' chunks are
`workload.WINDOW_LOSS_SHAPES`).
"""

import torch

# name: (C, N, (W, H), window groups)
SHAPES = {
    "ts1": (3, 2, (256, 256), ((160, (0,)), (128, (1,)))),
    "ts11": (3, 3, (240, 135), ((112, (0,)), (80, (1,)), (64, (2,)))),
    "pair": (4, 3, (120, 72), ((64, (0, 2)), (48, (1,)))),
}


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


def former_chain(groups, rasters, depths_c, min_z_c, max_z_c, seg_c,
                 seg_er_c, z, dw, sil_gate, eps, rows=None):
    """(loss_depth, loss_sil) as the inline block computed them; with
    `rows` a list, appends each group's (n_pix, diff, n_keep) (C, ng)."""
    C, N, H, W = seg_c.shape
    dev = seg_c.device
    f32 = torch.float32
    target_disp = (depths_c * (1.0 / min_z_c - 1.0 / max_z_c)
                   + 1.0 / max_z_c)
    idx = torch.arange(N, device=dev)
    in_front = ((z[:, None, :] < z[:, :, None])
                | ((z[:, None, :] == z[:, :, None])
                   & (idx[None, None, :] < idx[None, :, None])))
    closer = torch.einsum("cpq,cqx->cpx", in_front.to(f32),
                          seg_c.reshape(C, N, -1)).reshape(C, N, H, W)
    keep = 1.0 - (closer > 0).to(f32)
    n_keep = torch.sum(keep, dim=(2, 3)) + 1.0
    seg_keep_total = torch.sum(keep * seg_c, dim=(2, 3))
    loss_depth = torch.zeros((), device=dev)
    loss_sil = torch.zeros((), device=dev)
    for (win, group), (zbuf, sil, origin) in zip(groups, rasters):
        g = torch.tensor(group, device=dev)
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
        if rows is not None:
            rows.append((n_pix, mean_pred - mean_true, n_keep[:, g]))
    return loss_depth, loss_sil


def saved_of(rows):
    """The kernel's saved rows (slots, 5) from `former_chain`'s rows (the
    two term columns, which the backward does not read, left 0)."""
    out = [torch.stack([n_pix, diff, n_keep, 0 * diff, 0 * diff], -1)
           .reshape(-1, 5) for n_pix, diff, n_keep in rows]
    return torch.cat(out)


def leaves(rasters, inputs):
    """The differentiated inputs: min_z_c, max_z_c, the zbufs, the sils."""
    return ([inputs[1], inputs[2]] + [r[0] for r in rasters]
            + [r[1] for r in rasters])

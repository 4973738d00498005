"""The comparison that decides `correct`.

Two stages, each judged against the plain reference (`reference/`):

  * the start, from the benchmark's inputs on both sides: the init
    solve, and the first `steps` cycles that set-up replays through the
    window's own graphs. As for a training step: each cycle's loss
    (the worst), the first gradient's norm (read from the RMSprop state
    after one step, nu = g^2 / 2; by the median leaf, since each side
    starts from its own init solve, whose 100 Adam steps end on
    rounding-driven steps of ~1 mm that can move one leaf's first
    gradient by 20%) and the norm of the parameters' change after
    `steps` cycles (the worst leaf). The init's root translations are
    read and logged, not compared: they differ by 2-3e-4 in sound runs
    and under TF32 alike;
  * one cycle after the window from the program's own state: the first
    cycle that refreshes the One-Euro targets after the window (so it
    also rebuilds the scene and runs contact). The reference works the
    cycle out again from the program's params and RMSprop state before
    it; compared are the loss, the gradient (read back from the RMSprop
    state: g = -(trace' - 0.9 trace) sqrt(nu' + 1e-8) / lr), the
    parameters' update, the scene depth and the filtered targets of the
    real frames (the padded frames' targets jump to the origin, are
    never read by the loss, and round differently).

A leaf whose reference gradient is under a thousandth of the median
leaf's would move by rounding alone: it is left out of the change and
update numbers. Norm gaps and differences are taken against the larger
of the leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

QUIET_LEAF = 1e-3


class Start(NamedTuple):
    """One side's start: init root translations (T, N, 1, 3) over the
    real frames, the first cycles' losses, the first gradient's norm
    per leaf, the parameters' change norm per leaf after the cycles."""

    init_poses: torch.Tensor
    losses: Sequence[float]
    grad_norms: Sequence[float]
    change_norms: Sequence[float]


class Step(NamedTuple):
    """One side's cycle after the window: loss, gradient and update per
    leaf, scene depth (H, W), filtered targets (Tp, N, V, 3)."""

    loss: float
    grads: Sequence[torch.Tensor]
    updates: Sequence[torch.Tensor]
    scene: torch.Tensor
    filtered: torch.Tensor


def norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def _floor(ref_norms) -> List[float]:
    med = float(np.median(ref_norms))
    return [max(n, med) for n in ref_norms]


def _kept(ref_grad_norms) -> List[bool]:
    med = float(np.median(ref_grad_norms))
    return [n >= QUIET_LEAF * med for n in ref_grad_norms]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a.double() - b.double()))
                 / torch.clamp(torch.linalg.vector_norm(b.double()),
                               min=1e-30))


def start_numbers(prog: Start, ref: Start) -> Dict[str, float]:
    floor_g = _floor(ref.grad_norms)
    floor_c = _floor(ref.change_norms)
    kept = _kept(ref.grad_norms)
    return {
        "init_poses": _rel(prog.init_poses, ref.init_poses),
        "loss_first": max(abs(p - r) / abs(r)
                          for p, r in zip(prog.losses, ref.losses)),
        "grad_first": float(np.median([
            abs(p - r) / f for p, r, f in
            zip(prog.grad_norms, ref.grad_norms, floor_g)])),
        "change_first": max([abs(p - r) / f for p, r, f, k in
                             zip(prog.change_norms, ref.change_norms,
                                 floor_c, kept) if k] or [0.0]),
    }


def step_numbers(prog: Step, ref: Step) -> Dict[str, float]:
    ref_g = norms(ref.grads)
    floor_g = _floor(ref_g)
    kept = _kept(ref_g)
    ref_u = norms(ref.updates)
    floor_u = _floor(ref_u)
    return {
        "loss_cycle": abs(prog.loss - ref.loss) / abs(ref.loss),
        "grad_cycle": max(float(torch.linalg.vector_norm(
            p.double() - r.double())) / f
            for p, r, f in zip(prog.grads, ref.grads, floor_g)),
        "update_cycle": max([float(torch.linalg.vector_norm(
            p.double() - r.double())) / f
            for p, r, f, k in zip(prog.updates, ref.updates, floor_u, kept)
            if k] or [0.0]),
        "scene_cycle": _rel(prog.scene, ref.scene),
        "filter_cycle": _rel(prog.filtered.float(), ref.filtered.float()),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, none missing or not finite."""
    rows = [(k, float(numbers.get(k, float("nan"))), float(v))
            for k, v in limits.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def leaf_lines(prog_start: Start, ref_start: Start, prog: Step,
               ref: Step) -> List[str]:
    """Each number's reading leaf by leaf, for the run's log."""
    def fmt(xs):
        return " ".join(f"{x:.3g}" for x in xs)
    ref_g, ref_u = norms(ref.grads), norms(ref.updates)
    gd = [(p.double() - r.double()).flatten() for p, r in
          zip(prog.grads, ref.grads)]
    k = max(range(len(gd)), key=lambda i: float(gd[i].norm()))
    sq = torch.sort(gd[k] ** 2, descending=True).values
    top = torch.topk(gd[k].abs(), min(5, len(gd[k])))
    d = (prog.filtered.float() - ref.filtered.float()).abs()
    worst = int(d.flatten().argmax())
    per_frame = d.shape[1] * d.shape[2] * d.shape[3]
    return [
        "# grad_first leaf norms prog " + fmt(prog_start.grad_norms)
        + " | ref " + fmt(ref_start.grad_norms),
        "# change_first leaf norms prog " + fmt(prog_start.change_norms)
        + " | ref " + fmt(ref_start.change_norms),
        "# grad_cycle leaf diff " + fmt(norms(
            [p - r for p, r in zip(prog.grads, ref.grads)]))
        + " | ref " + fmt(ref_g),
        f"# grad_cycle leaf {k}: the 20 largest entries hold "
        f"{float(sq[:20].sum() / sq.sum().clamp(min=1e-300)):.3g} of its "
        f"squared difference; largest at flat index "
        f"{top.indices.tolist()} of {ref.grads[k].shape}",
        "# update_cycle leaf diff " + fmt(norms(
            [p - r for p, r in zip(prog.updates, ref.updates)]))
        + " | ref " + fmt(ref_u),
        f"# filter_cycle: {int((d > 0).sum())} of {d.numel()} differ, "
        f"max {float(d.max()):.3g} at frame {worst // per_frame}",
    ]

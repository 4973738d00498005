"""Phase marks of a stage-1 cycle: the device clock at each phase's end.

A cycle on the card is one CUDA graph replay (`engine/cycle_graph.py`),
so no host code runs while it runs and host ranges cannot split it.
With marks on (`CycleGraph(..., phase_marks=True)`), `cycle_body`
launches the one-thread kernel of `csrc/phase_mark.cu` at each phase
boundary; a capture records each launch as a graph node. The kernel
writes the device's clock (%globaltimer, ns) into row `cycle` of an
(L, M) int64 ring that lives in the static state beside the loss log,
at the boundary's slot. The host reads nothing and nothing synchronizes.
On CPU tensors the same call writes `time.perf_counter_ns()` into a CPU
ring, with tensor operations only (the row is the cycle counter, a
tensor), so the CPU tests cover the slots' order.

The slot table (`slot_names`), one row a cycle:

    start, scene, filter, forward0, backward0, ..., forward{K-1},
    backward{K-1}, scale_reg, update

Slot 0 is the cycle's start; every other slot is the end of the phase
it names, which lasts from the slot before it: `update_scene`,
`update_filtered_targets`, chunk i's `_chunk_loss_core` (with its
slicing and the previous chunk's sums) and its `loss.backward()`,
`_scale_reg` with its backward, and the RMSprop update with the log row
and the counter's step. A phase the cycle's variant skips takes its
predecessor's value: it reads 0 ns. M = 5 + 2 K for K chunks.

Readers: `phase_ms` (each phase's ms a row), `group_ms` (the forward,
backward and update groups, the scene and the filter), and `split`,
which cuts a profiled replay's device operations at the mark kernels
and refuses a trace that lost marks (`total` sums its cycles). The
mark kernels are device operations of such a trace, so they delimit
the phases on the trace's own clock. The kernel counts its own
launches on the card (`launches`, a `cuda_lib.LaunchCounts`).
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .cuda_lib import LaunchCounts, load_library, stream_ptr

KERNEL = "phase_mark_kernel"
# the mark kernel's launches, counted by the kernel (CUDA tensors only)
launches = LaunchCounts(("marks",))
GROUPS = ("scene", "filter", "forward", "backward", "update")


def slot_names(num_chunks: int) -> Tuple[str, ...]:
    """The ring's slots in cycle order (module docstring)."""
    chunks = [f"{kind}{i}" for i in range(num_chunks)
              for kind in ("forward", "backward")]
    return ("start", "scene", "filter", *chunks, "scale_reg", "update")


def group_of(phase: str) -> str:
    """The group a phase (slot name but "start") counts in: a chunk's
    forward in "forward", its backward and `_scale_reg` in "backward"."""
    if phase == "scale_reg":
        return "backward"
    return phase.rstrip("0123456789")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("phase_mark", ("phase_mark.cu",))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mhmocap_phase_mark.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.mhmocap_phase_mark.restype = i
    return lib


def make_ring(rows: int, num_chunks: int, device) -> torch.Tensor:
    """An (rows, M) int64 ring of -1 (no mark yet)."""
    return torch.full((rows, len(slot_names(num_chunks))), -1,
                      dtype=torch.int64, device=device)


class PhaseMarks:
    """Writes marks into `ring` at the row `cycle` (a () int64 tensor,
    read where the mark runs; a row outside the ring is left alone). `mark(name)` stamps slot `name`; the
    slots between the previous mark of the cycle and it (phases the
    variant skips) take the previous mark's value. `order` holds the
    slots the marks of the last body stamped, in order."""

    def __init__(self, ring: torch.Tensor, cycle: torch.Tensor,
                 num_chunks: int):
        self.ring, self.cycle = ring, cycle
        self.names = slot_names(num_chunks)
        if ring.shape[1] != len(self.names) or ring.dtype != torch.int64:
            raise ValueError(f"ring {tuple(ring.shape)} {ring.dtype} is not "
                             f"(L, {len(self.names)}) int64")
        self.order: List[str] = []
        self._last = -1

    def __call__(self, name: str, row_offset: int = 0):
        own = self.names.index(name)
        first = 0 if own == 0 else self._last + 1
        if own and not 0 < first <= own:
            raise ValueError(f"mark {name!r} after slot "
                             f"{self.names[self._last]!r}")
        if own == 0:
            self.order = []
        ring = self.ring
        if ring.is_cuda:
            err = _library().mhmocap_phase_mark(
                ring.data_ptr(), self.cycle.data_ptr(), row_offset,
                ring.shape[0], ring.shape[1], first, own,
                launches.pointer("marks", ring.device),
                stream_ptr(ring.device))
            if err != 0:
                raise RuntimeError(f"phase mark launch failed: CUDA error "
                                   f"{err}")
        else:
            # as the kernel: a row outside the ring is left alone (tensor
            # operations only, the row is not read on the host)
            now = time.perf_counter_ns()
            row = (self.cycle + row_offset).reshape(1)
            inside = (row >= 0) & (row < ring.shape[0])
            row = row.clamp(0, ring.shape[0] - 1)
            old = ring.index_select(0, row)
            r = old.clone()
            if first < own:
                r[:, first:own] = r[:, first - 1:first]
            r[:, own] = now
            ring.index_copy_(0, row, torch.where(inside[:, None], r, old))
        self.order.append(name)
        self._last = own


def phase_ms(rows, num_chunks: int) -> Dict[str, np.ndarray]:
    """{phase: ms a row} from ring rows (n, M) (a tensor or an array),
    one entry a slot but "start", in slot order."""
    a = np.asarray(torch.as_tensor(rows).cpu(), dtype=np.int64)
    d = np.diff(a, axis=1) * 1e-6
    return {name: d[:, k] for k, name in enumerate(slot_names(num_chunks)[1:])}


def group_ms(rows, num_chunks: int) -> Dict[str, np.ndarray]:
    """{group: ms a row}, GROUPS' order: the phases of each group
    summed."""
    out = {g: 0.0 for g in GROUPS}
    for name, ms in phase_ms(rows, num_chunks).items():
        out[group_of(name)] = out[group_of(name)] + ms
    return out


class Phase(NamedTuple):
    busy_s: float     # device operations' durations, marks excluded
    launches: int     # device operations, marks excluded
    idle_s: float     # the phase's span less its busy time


def split(ops: Iterable[Tuple[float, float, str]],
          orders: Sequence[Sequence[str]]) -> List[Dict[str, Phase]]:
    """Cut a profiled run of replays at its mark kernels.

    `ops`: the device operations (start us, end us, name) of one stream,
    in time order (a torch.profiler trace's device rows); `orders`: for
    each replayed cycle in turn, the slots its marks stamp
    (`CycleGraph.mark_order` of its variant). Returns one {phase: Phase}
    a cycle: the operations between two marks belong to the phase the
    second one ends; its idle time is the span from the end of the mark
    before it to the start of its own mark, less their durations.
    Operations before the first mark count under the first cycle's
    "before", those from a cycle's last mark to the next cycle's "start"
    under its "between". A trace that holds another number of marks
    than the cycles stamp has lost some (a profiler may drop a run's
    tail), and its operations cannot be put down to phases: ValueError.
    """
    ops = list(ops)
    stamps = [(c, k) for c, order in enumerate(orders)
              for k in range(len(order))]
    marks = sum(KERNEL in name for _, _, name in ops)
    if marks != len(stamps):
        raise ValueError(f"the trace holds {marks} marks where its "
                         f"{len(orders)} cycles stamp {len(stamps)}")
    out: List[Dict[str, List[float]]] = [{} for _ in orders]
    cycle, phase, j = 0, "before", 0
    busy, n, opened = 0.0, 0, None

    def close(at):
        if opened is None and not n:
            return
        row = out[cycle].setdefault(phase, [0.0, 0, 0.0])
        row[0] += busy * 1e-6
        row[1] += n
        if opened is not None and at is not None:
            row[2] += max(at - opened - busy, 0.0) * 1e-6

    for a, b, name in ops:
        if KERNEL not in name:
            busy, n = busy + (b - a), n + 1
            continue
        close(a)
        cycle, k = stamps[j]
        j += 1
        order = orders[cycle]
        phase = order[k + 1] if k + 1 < len(order) else "between"
        busy, n, opened = 0.0, 0, b
    if n:
        close(None)
    return [{p: Phase(row[0], int(row[1]), row[2]) for p, row in c.items()}
            for c in out]


def total(cuts: Iterable[Dict[str, Phase]]) -> Dict[str, Phase]:
    """{phase: Phase} summed over cycles (`split`'s list, or part of
    it)."""
    out: Dict[str, Phase] = {}
    for cut in cuts:
        for p, x in cut.items():
            y = out.get(p, Phase(0.0, 0, 0.0))
            out[p] = Phase(y.busy_s + x.busy_s, y.launches + x.launches,
                           y.idle_s + x.idle_s)
    return out

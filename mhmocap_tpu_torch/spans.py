"""Named host spans of the port, and a recorder that keeps them.

`span(name)` marks a stretch of host code. It always enters
`torch.profiler.record_function(name)`, so the span shows on the
profiler's clock in any trace taken around it (the operator's
`profile_dir` trace included). While one or more `Spans` recorders are
active (`with Spans() as rec:`), each also keeps the span as a `Record`
(name, the enclosing span's name, start and end in ns of
`time.perf_counter_ns`), in memory; nothing is written until the caller
asks. The recorders and the open spans are per thread (context
variables), so a span on a worker thread sees none of the caller's.

Spans mark set-up: the Predictor's layout, the init solve, the data and
aux, each graph variant's warm-up and capture, the kernel libraries'
build and load, and ingestion. `CycleGraph.capture_seconds` and
`load_sequence`'s `timings` are read from recorders. Nothing on the
replay path opens a span: a replayed cycle runs no host code, and the
device marks of `ops/phase_marks.py` time its phases.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import List, NamedTuple, Optional

import torch

_RECORDERS: contextvars.ContextVar = contextvars.ContextVar(
    "mhmocap_span_recorders", default=())
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "mhmocap_open_spans", default=())


class Record(NamedTuple):
    name: str
    parent: Optional[str]     # the enclosing span's name, None at the top
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Spans:
    """A recorder: while active, it keeps every span that ends, in the
    order they end (a child before its parent). Entering it again while
    it is active (nested) keeps each span once."""

    def __init__(self):
        self.records: List[Record] = []
        self._tokens = []

    def __enter__(self) -> "Spans":
        active = _RECORDERS.get()
        self._tokens.append(_RECORDERS.set(
            active if self in active else active + (self,)))
        return self

    def __exit__(self, *exc):
        _RECORDERS.reset(self._tokens.pop())

    def seconds(self, name: str) -> float:
        """Seconds of the spans named `name`, summed."""
        return sum(r.seconds for r in self.records if r.name == name)

    def roots(self) -> List[Record]:
        """The records that no record of this recorder encloses, in the
        order they started: their seconds add up without counting a
        child twice."""
        def enclosed(r):
            return any(p.name == r.parent and p.start_ns <= r.start_ns
                       and r.end_ns <= p.end_ns for p in self.records)
        return sorted((r for r in self.records if not enclosed(r)),
                      key=lambda r: r.start_ns)


@contextlib.contextmanager
def span(name: str):
    """A named span: a profiler range, and a Record in each active
    recorder."""
    with torch.profiler.record_function(name):
        recorders = _RECORDERS.get()
        stack = _OPEN.get()
        token = _OPEN.set(stack + (name,))
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            _OPEN.reset(token)
            rec = Record(name, stack[-1] if stack else None, start, end)
            for r in recorders:
                r.records.append(rec)

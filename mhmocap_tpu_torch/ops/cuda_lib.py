"""What the port's hand-written CUDA kernel libraries share.

Each library (the raster pair, `raster_cuda.py`; the fill-in,
`fillin_cuda.py`; the phase marks, `phase_marks.py`) is a set of
sources under csrc/ with a plain C interface, built by nvcc for sm_90a
at first use into build/mhmocap_tpu_torch/ and bound with ctypes. This
module holds the build (`build_library`, `NVCC_FLAGS`, `nvcc`) and the
load (`load_library`, under the span "build <stem>"), the current stream a
launch goes on (`stream_ptr`, so that a CUDA graph capture records it)
and `LaunchCounts`, the per-device counters the kernels count their own
launches in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..native import build_dir
from ..spans import span

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc (CUDA_HOME or PATH)")


def build_library(stem: str, sources, headers=()) -> Tuple[Path, str]:
    """nvcc (NVCC_FLAGS) of csrc/`sources` into
    build/mhmocap_tpu_torch/libmhmocap_<stem>_<hash of the sources,
    headers and flags>.so unless it is already there. Returns (path,
    nvcc's output); raises with the compiler's output if it fails.
    Concurrent builds each write a temporary file of their own."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*headers, *sources):
        h.update((CSRC / name).read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"libmhmocap_{stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def load_library(stem: str, sources, headers=()) -> ctypes.CDLL:
    """`build_library` and the ctypes load, under the span
    "build <stem>"."""
    with span(f"build {stem}"):
        return ctypes.CDLL(str(build_library(stem, sources, headers)[0]))


def stream_ptr(device) -> int:
    """The current stream of `device`, as the C launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream


class LaunchCounts(Mapping):
    """{name: n}: kernel launches, counted by the kernels themselves: the
    first thread of a launch atomically adds one to its word of a
    per-device int64 counter whose address the launcher is given
    (`pointer`), so a launch recorded in a CUDA graph counts at each
    replay, when it runs, and the capture counts nothing. Reading
    synchronizes with the counters' devices; `reset` zeroes them on
    their current streams."""

    def __init__(self, names: Tuple[str, ...]):
        self.names = tuple(names)
        self._counters: Dict[torch.device, torch.Tensor] = {}

    def pointer(self, name: str, device) -> int:
        """The device address of `name`'s counter on `device`, made at
        the first eager launch there (a capture may not allocate it)."""
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        c = self._counters.get(device)
        if c is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a launch counter is made by an eager "
                                   "launch, not inside a capture")
            c = self._counters[device] = torch.zeros(
                len(self.names), dtype=torch.int64, device=device)
        return c.data_ptr() + c.element_size() * self.names.index(name)

    def reset(self):
        for c in self._counters.values():
            c.zero_()

    def __getitem__(self, name: str) -> int:
        i = self.names.index(name)
        return sum(int(c[i]) for c in self._counters.values())

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    def __repr__(self) -> str:
        return repr(dict(self))

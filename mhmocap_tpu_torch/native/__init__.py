"""The port's host C++ (`codecs.cpp`): build, load and call.

Counterpart of the JAX package's `native/`, which holds that package's
own host C++. `codecs.cpp` holds the JPEG entropy decode and the PNG
unfilter of `mhmocap_tpu_torch.io`, whose plain Python versions
(`io._decode_scan`, `io._png_unfilter`) the tests hold it to.

The library is compiled with the host C++ compiler (g++ on PATH, which
nvcc also needs) at first use, into
build/mhmocap_tpu_torch/libmhmocap_codecs_<hash of the source and the
flags>.so, and bound with `ctypes.CDLL`, which releases the GIL during
each call, so that frames decode in parallel on threads. Nothing falls
back: a missing compiler or a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from ..spans import span

_SRC = Path(__file__).resolve().parent / "codecs.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_dir() -> Path:
    """Where the port's native libraries (these codecs, the raster
    kernels) are built: build/mhmocap_tpu_torch/ in the checkout."""
    return _SRC.parents[2] / "build" / "mhmocap_tpu_torch"


def compiler() -> str:
    """The host C++ compiler the codecs are built with."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host codecs "
                           "(mhmocap_tpu_torch/native/codecs.cpp) are built "
                           "with it")
    return cxx


def build_library() -> Tuple[Path, str]:
    """Compile codecs.cpp unless a library of the same source and flags
    is already built. Returns (path, the compiler's output); raises with
    the compiler's output if it fails. Concurrent builds (processes,
    threads) each write a temporary file of their own and rename it."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"libmhmocap_codecs_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


_LOCK = threading.Lock()
_LIB = []


def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built and
    loaded once a process; the pool's threads may ask at once)."""
    with _LOCK:
        if not _LIB:
            with span("build codecs"):
                lib = ctypes.CDLL(str(build_library()[0]))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.mhmocap_jpeg_decode_scan.argtypes = [
                ctypes.c_char_p, p, p, i64, i32, p, p, p, p, i32, i64, i64,
                i64, p]
            lib.mhmocap_jpeg_decode_scan.restype = ctypes.c_int
            lib.mhmocap_png_unfilter.argtypes = [p, i64, i64, i64, p]
            lib.mhmocap_png_unfilter.restype = ctypes.c_int
            _LIB.append(lib)
        return _LIB[0]


_SCAN_ERRORS = {
    1: "bad JPEG Huffman code",
    2: "JPEG AC run past coefficient 63",
    3: "JPEG scan ends before its last MCU",
    4: "JPEG entropy data overrun",
    6: "negative shift count",
    8: "range() arg 3 must not be zero",
}
_PAD = b"\x00\x00\x00\x00"


def jpeg_decode_scan(segments: Sequence[bytes], comps, tables: Dict,
                     interleaved: bool, grid: Tuple[int, int],
                     restart_interval: int):
    """Entropy-decode one scan, as `io._decode_scan` does, into each
    component's coefficients in place.

    segments: the unstuffed restart segments. comps: per scan component
    (coefs, h, v, DC table id, AC table id), coefs the (rows, cols, 64)
    int32 C-contiguous array the blocks are written to (or None).
    tables: (class, id) -> (2, 65536) int32 (symbol, code length) per
    16-bit peek, class 0 for DC and 1 for AC. interleaved: MCUs of h x v
    blocks of every component on a grid of (MCU columns, MCU rows);
    otherwise one block an MCU on a grid of (block columns, block rows).
    Raises what `_decode_scan` raises on the same input."""
    n = len(comps)
    if n > 256:
        raise ValueError(f"jpeg_decode_scan: {n} components in one scan")
    gw, gh = grid
    geom = np.zeros((max(n, 1), 4), np.int32)
    ptrs = (ctypes.c_void_p * max(n, 1))()
    dc, ac = (ctypes.c_void_p * max(n, 1))(), (ctypes.c_void_p * max(n, 1))()
    for ci, (coefs, h, v, dct, act) in enumerate(comps):
        geom[ci, :2] = (h, v)
        if coefs is not None:
            if (not isinstance(coefs, np.ndarray) or coefs.dtype != np.int32
                    or coefs.ndim != 3 or coefs.shape[2] != 64
                    or not coefs.flags.c_contiguous
                    or not coefs.flags.writeable):
                raise ValueError("jpeg_decode_scan: coefficients must be "
                                 "writeable C-contiguous int32 (rows, cols, "
                                 "64)")
            geom[ci, 2:] = coefs.shape[:2]
            ptrs[ci] = coefs.ctypes.data
        for arr, key in ((dc, (0, dct)), (ac, (1, act))):
            t = tables.get(key)
            if t is not None:
                if (t.dtype != np.int32 or t.shape != (2, 65536)
                        or not t.flags.c_contiguous):
                    raise ValueError("jpeg_decode_scan: a table must be "
                                     "C-contiguous int32 (2, 65536)")
                arr[ci] = t.ctypes.data
    data = _PAD.join(segments) + _PAD
    lens = np.asarray([len(s) for s in segments], np.int64)
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1] + len(_PAD))
    info = np.zeros(3, np.int64)
    rc = _library().mhmocap_jpeg_decode_scan(
        data, starts.ctypes.data, lens.ctypes.data, len(segments), n,
        geom.ctypes.data, ptrs, dc, ac, int(interleaved), gw, gh,
        restart_interval, info.ctypes.data)
    if rc == 0:
        return
    if rc in _SCAN_ERRORS:
        raise ValueError(_SCAN_ERRORS[rc])
    index, axis, size = info.tolist()
    if rc == 5:
        ci, is_ac = divmod(index, 2)
        raise KeyError(comps[ci][4 if is_ac else 3])
    if rc == 7:
        raise OverflowError(f"Python integer {index} out of bounds for int32")
    if rc == 9:
        raise TypeError("'NoneType' object is not subscriptable")
    if rc == 10:
        raise IndexError(f"index {index} is out of bounds for axis {axis} "
                         f"with size {size}")
    raise RuntimeError(f"mhmocap_jpeg_decode_scan returned {rc}")


def png_unfilter(raw: np.ndarray, rows: int, rowbytes: int,
                 bpp: int) -> np.ndarray:
    """Undo the PNG row filters, as `io._png_unfilter`: raw holds rows
    lines of a filter byte and rowbytes bytes; returns (rows, rowbytes)
    uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != rows * (rowbytes + 1):
        raise ValueError(f"png_unfilter: {raw.size} bytes for {rows} rows "
                         f"of {rowbytes}")
    out = np.empty((rows, rowbytes), np.uint8)
    worst = _library().mhmocap_png_unfilter(raw.ctypes.data, rows, rowbytes,
                                            bpp, out.ctypes.data)
    if worst:
        raise ValueError(f"bad PNG filter type {worst}")
    return out

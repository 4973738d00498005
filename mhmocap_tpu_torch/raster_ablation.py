"""Ablation of the forward raster kernel on the card.

    python -m mhmocap_tpu_torch.raster_ablation [--out FILE]

Builds the forward kernel (`ops/csrc/raster_fwd.cu`) as it is and with
parts of its design taken out, each from an edited copy of the source
under build/, and times every build at the timed raster call shapes
(`workload.TIMED_SHAPES`) on the same posed tables. Each
variant's z-buffer and winners must equal the kernel's; its log-sums
differ only where the groups' sums meet in another order. Variants:

  kernel     the source as it is;
  no_cull    the warp's bbox cull off: every face of an active chunk is
             walked (the terms stay exact, so the output does not change);
  one_group  one chunk group a block: a cell's chunks run in sequence;
  neither    both of the above;
  no_tiny    the -expf(-x) shortcut off: log1pf wherever a term is live.

Prints one line per shape and variant, then nvidia-smi's name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from .config import gpu_name_and_power
from .models.synthetic import make_synthetic_smpl
from .native import build_dir
from .ops import cuda_lib
from .ops import raster_cuda as RC
from .ops.rasterizer import preorder_faces
from .workload import (KERNEL_SHAPES, TIMED_SHAPES, cuda_ms,
                       posed_raster_tables)

# (pattern, replacement) edits of raster_fwd.cu; each must match once
EDITS = {
    "no_cull": [(r"__ballot_sync\(0xffffffffu, !dead\)",
                 "__ballot_sync(0xffffffffu, dead || true)")],
    "one_group": [(r"FWD_MAX_GROUPS = \d+;", "FWD_MAX_GROUPS = 1;")],
    "no_tiny": [(r"if \(__any_sync\(0xffffffffu, slow\)\)", "if (true)")],
}
EDITS["neither"] = EDITS["no_cull"] + EDITS["one_group"]


def variant_source(name: str) -> str:
    """raster_fwd.cu with the variant's edits."""
    src = (cuda_lib.CSRC / "raster_fwd.cu").read_text()
    for pat, rep in EDITS.get(name, []):
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"{name}: {pat!r} matched {n} times")
    return src


def build(name: str):
    """Start nvcc on the variant (and the backward, so that the library
    has the C interface of csrc/); returns the library path and the
    process."""
    out = build_dir() / "ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in RC._HEADERS + RC._SOURCES:
        (out / f).write_bytes((cuda_lib.CSRC / f).read_bytes())
    (out / "raster_fwd.cu").write_text(variant_source(name))
    lib = out / "libmhmocap_raster.so"
    cmd = [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib),
           *[str(out / f) for f in RC._SOURCES]]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_ablation needs a CUDA card")
    names = ["kernel", "no_cull", "one_group", "neither", "no_tiny"]
    built = {n: build(n) for n in names}       # the nvcc runs in parallel
    dlls = {}
    for n, (lib, proc) in built.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        dlls[n] = RC._bind(ctypes.CDLL(str(lib)))
    dev = torch.device("cuda")
    model = preorder_faces(make_synthetic_smpl(device=dev))
    lines = []
    for B, win in ((b, w) for b, wins in KERNEL_SHAPES for w in wins
                   if (b, w) in TIMED_SHAPES):
        tab, agg, _, _, inv_blur, znear = posed_raster_tables(
            model, win, B, seed=win, device=dev)
        ref = RC._launch_fwd(tab, agg, win, inv_blur, znear, dlls["kernel"])
        ms = {n: [] for n in names}
        for order in (names, names[::-1]):      # in turns, best of two
            for n in order:
                ms[n].append(cuda_ms(lambda: RC._launch_fwd(
                    tab, agg, win, inv_blur, znear, dlls[n]), 20))
        for n in names:
            z, lk, a = RC._launch_fwd(tab, agg, win, inv_blur, znear,
                                      dlls[n])
            if not (torch.equal(z, ref[0]) and torch.equal(a, ref[2])):
                raise AssertionError(f"{n}: z-buffer or winners differ from "
                                     f"the kernel's at B={B}, window {win}")
            lines.append(f"B={B} win {win} {n:9s} {min(ms[n]):.3f} ms "
                         f"(log-sum max diff "
                         f"{float((lk - ref[1]).abs().max()):.2e})")
            print(lines[-1], flush=True)
    smi = gpu_name_and_power()
    lines.append(smi)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())

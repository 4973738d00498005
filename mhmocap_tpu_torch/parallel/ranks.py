"""Run one job on D rank processes of this host and collect the results.

    results = run_ranks("package.module:function", world=2, payload=...,
                        device="cpu", timeout=300)

Each rank is a fresh `python -m mhmocap_tpu_torch.parallel.ranks` process.
It joins the default process group over a file rendezvous in a
temporary directory (no port to collide with), builds its `TimeMesh`,
calls `function(mesh, payload)` and pickles what it returns. The parent
waits for every rank under one deadline; when a rank fails or the
deadline passes it kills the ranks still running and raises with the
ranks' output, so a hung rank cannot hang its caller. Used by the
sharded tests and by `chip_smoke.py`'s sharded phase; a CUDA job's
kernels should be built before the ranks start (`raster_cuda.
build_kernels`), so that the ranks load one library instead of racing
on the compiler's output.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(fn: str, world: int, payload: Any = None, device="cpu",
              backend: Optional[str] = None, timeout: float = 600.0,
              path: Sequence[str] = (),
              threads: Optional[int] = None) -> List[Any]:
    """`fn` ("module:function") on `world` ranks, every rank's tensors on
    `device` (one device string for all of them; backend as in
    `spmd.init_time_mesh`). `path` entries are put in front of the
    ranks' sys.path to import `fn`'s module; `threads` caps each rank's
    torch threads. Returns the ranks' results in rank order."""
    with tempfile.TemporaryDirectory(prefix="mhmocap_ranks_") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"fn": fn, "world": world, "payload": payload,
                         "device": str(device), "backend": backend,
                         "init": "file://" + os.path.join(tmp, "rendezvous"),
                         "path": list(path), "threads": threads}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "wb")
                for r in range(world)]
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mhmocap_tpu_torch.parallel.ranks",
                     job, str(r)], env=env, stdout=logs[r],
                    stderr=subprocess.STDOUT))
            failure = _wait(procs, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if failure:
            raise RuntimeError(f"{fn} on {world} ranks: {failure}\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n"
                + _tail(os.path.join(tmp, f"rank{r}.log"))
                for r, p in enumerate(procs)))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _wait(procs, deadline: float) -> str:
    """'' once every rank exited with 0; else what went wrong (a rank's
    exit code, or the deadline)."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return f"rank {bad[0][0]} exited with {bad[0][1]}"
        if all(c == 0 for c in codes):
            return ""
        if time.monotonic() > deadline:
            return "timed out; the ranks still running were killed"
        time.sleep(0.05)


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        return f.read()[-n:].decode(errors="replace")


def _rank_main(job_path: str, rank: int):
    import torch
    import torch.distributed as dist
    from .spmd import init_time_mesh

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if job["threads"]:
        torch.set_num_threads(job["threads"])
    sys.path[:0] = job["path"]
    module, name = job["fn"].split(":")
    fn = getattr(importlib.import_module(module), name)
    mesh = init_time_mesh(job["backend"], job["device"], job["init"], rank,
                          job["world"])
    try:
        result = fn(mesh, job["payload"])
        mesh.barrier()
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(job_path), f"result{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))

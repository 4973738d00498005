"""One run of one cell: set-up, the timed window, the check, the metrics.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration
is the JSON file that entry's config names, its traffic mix is
`workloads/<traffic>.json`, the limits of its check are
`limits/<cell>.json`, and each per-layer metric is read by
`metrics/<name>.py` (dots and dashes of the name as underscores), whose
`read(facts)` returns a number or None. Adding a cell, a mix or a
metric adds files and entries; nothing here names one.

The run, in order:
  1. the generator's inputs from the seed (`generate.py`), on frames of
     the configuration's `image_size` (W, H);
  2. set-up, as `Predictor.fit` runs it (`program.py`): layout and
     windows, the init solve, data, aux and RMSprop state, every
     variant captured, then cycles [0, window_from_cycle) replayed;
  3. the window: replays from `window_from_cycle` on, at most two in
     flight (an event recorded after each replay is waited on two
     cycles later, so the host never synchronizes the device inside
     it), until `seconds` have passed; one synchronize ends it;
  4. replays up to c, the first One-Euro refresh cycle at least
     PLAIN_PROFILED cycles after the window, whose state before and
     after is kept (with `--trace 1` the PLAIN_PROFILED plain cycles
     before c are profiled back to back, and c alone);
  5. the device's peak memory is read, the program's state freed, and
     the plain reference works out the start and cycle c (`check.py`).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import check as CK
from .generate import generate, to_device
from .reference import fit as RF
from .reference.body import body_tensors

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mhmocap_tpu")
CONTROLS = ("tf32", "halfbatch", "altered", "frozen")
# plain cycles profiled back to back before the refresh cycle
PLAIN_PROFILED = 3


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(name, int(w["chips"]), load_json(root / entry["file"]),
                load_json(PKG / "workloads" / f"{w['traffic']}.json"),
                load_json(PKG / "limits" / f"{name}.json"),
                bench["end_to_end"], bench["per_layer"])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_reader(name: str):
    return importlib.import_module(
        f"{__package__}.metrics.{name.replace('.', '_').replace('-', '_')}")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls and convolutions on or off inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Clocks:
    """nvidia-smi's SM clock, power draw and limit, memory clock and
    temperature, sampled every `period` seconds on a thread while the
    window runs."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
             "clocks.mem,temperature.gpu", "--format=csv,noheader,nounits"]

    def __init__(self, period: float = 2.0):
        self.period, self.rows = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while True:
            try:
                out = subprocess.run(self.QUERY, capture_output=True,
                                     text=True, timeout=10).stdout
                self.rows.append([float(x) for x in
                                  out.splitlines()[0].split(",")])
            except (OSError, subprocess.SubprocessError, ValueError,
                    IndexError):
                return
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def line(self) -> str:
        if not self.rows:
            return "# clocks: nvidia-smi gave no reading"
        a = np.asarray(self.rows)
        return (f"# clocks over the window ({len(a)} samples): SM MHz "
                f"min {a[:, 0].min():.0f} median {np.median(a[:, 0]):.0f} "
                f"max {a[:, 0].max():.0f}; power W median "
                f"{np.median(a[:, 1]):.2f} max {a[:, 1].max():.2f}; "
                f"limit {a[0, 2]:.2f} W; memory MHz {a[:, 3].min():.0f}-"
                f"{a[:, 3].max():.0f}; {a[:, 4].min():.0f}-{a[:, 4].max():.0f} C")


class Facts(NamedTuple):
    """What the per-layer readers read."""

    layout: RF.Layout
    window_cycles: int
    window_s: float
    capture_s: float
    init_solve_s: float
    spans: Dict              # "plain" (PLAIN_PROFILED cycles), "refresh"
    plain_cycles: int
    raster_calls: List       # [(window, bodies, reference.raster.Work)]
    num_vertices: int
    num_faces: int


def _layout(cell: Cell, inputs) -> RF.Layout:
    cfg = cell.config
    T, size = cfg["frames"], tuple(cfg["image_size"])
    return RF.Layout(
        T=T, N=cfg["people"], size=size, chunk=RF.time_chunk(T),
        windows=RF.person_windows(inputs["pose2d"], size,
                                  cfg["raster_window"],
                                  cfg["joint_confidence_thr"]),
        coefs=tuple(sorted(cfg["coefs"].items())),
        joint_thr=cfg["joint_confidence_thr"],
        filter_every=cfg["update_filters_every"],
        warmup=cfg["warmup_cycles"], batch_size=cfg["batch_size"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _alter(params, frame: int):
    """An answer altered where it is produced: one frame's root
    translations moved by 1 cm."""
    pT = params[0].clone()
    pT[frame] += 0.01
    return (pT,) + tuple(params[1:])


def reference_start(body, rin, data, lay, steps: int,
                    variant: Optional[str] = None) -> CK.Start:
    """The reference's init solve and first cycles; `variant` "tf32"
    or "halfbatch" runs a control in its place."""
    half = variant == "halfbatch"
    with tf32(variant == "tf32"):
        p0 = RF.init_solve(body, rin, lay)
        st = RF.start_state(p0)
        losses, g1 = [], None
        for c in range(steps):
            st, loss, _, grads = RF.cycle(
                st, c, body, data, lay,
                chunks=range(0, lay.num_chunks, 2) if half else None,
                loss_scale=2.0 if half else 1.0)
            if c == 0:
                g1 = CK.norms(grads)
            losses.append(float(loss))
    change = CK.norms([a - b for a, b in zip(st.params, p0)])
    return CK.Start(p0[0][:lay.T], losses, g1, change)


def reference_step(pre, c: int, body, data, lay, work=None,
                   variant: Optional[str] = None) -> CK.Step:
    """Cycle c from the program's state before it, by the reference (or
    the control `variant`, as in reference_start)."""
    half = variant == "halfbatch"
    st = RF.State(tuple(pre.params), tuple(pre.nu), tuple(pre.trace), c)
    with tf32(variant == "tf32"):
        st2, loss, _, grads = RF.cycle(
            st, c, body, data, lay, work,
            chunks=range(0, lay.num_chunks, 2) if half else None,
            loss_scale=2.0 if half else 1.0)
    updates = [a - b for a, b in zip(st2.params, st.params)]
    return CK.Step(float(loss), grads, updates, st2.scene.depth,
                   st2.dvf[:lay.T])


def program_step(pre, post, loss: float, c: int, scene, filtered) -> CK.Step:
    """The program's cycle c read back from its state before and after:
    the update, and the gradient RMSprop took it from."""
    lr = RF.decayed(0.01, 0.99, c)
    grads = [-(tr1 - 0.9 * tr0) * torch.sqrt(nu1 + 1e-8) / lr
             for tr0, tr1, nu1 in zip(pre.trace, post.trace, post.nu)]
    updates = [p1 - p0 for p0, p1 in zip(pre.params, post.params)]
    return CK.Step(loss, grads, updates, scene, filtered)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, controls: bool = False, log=print) -> Dict:
    """Run the cell once; returns the result line's object, with the
    control readings under "controls" when asked for."""
    from .program import Fit

    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    warm = int(traffic["window_from_cycle"])
    every = int(cfg["update_filters_every"])
    steps = int(cell.limits["steps"])
    t_gen = time.time()
    inputs, body = generate(cfg, traffic, seed, device)
    log(f"# generated in {time.time() - t_gen:.2f} s")
    log_len = warm + 2 * every + 2 + int(seconds * 200)
    fit = Fit(inputs, body, cfg, log_len, device)
    capture_s = fit.prepare()
    log(f"# init solve {fit.init_solve_s:.2f} s, captures {capture_s:.2f} s")
    for c in range(warm):
        fit.replay(c)
        if c == 0:
            nu0 = fit.snapshot().nu
        if c == steps - 1:
            p_steps = fit.snapshot().params
    _sync(device)

    clocks = Clocks() if device.type == "cuda" else contextlib.nullcontext()
    with clocks:
        inflight, marks = deque(), []
        t0 = time.time()
        cycle = warm
        while True:
            fit.replay(cycle)
            cycle += 1
            if device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                inflight.append(ev)
                marks.append(ev)
                if len(inflight) > 2:
                    inflight.popleft().synchronize()
            if (time.time() - t0 >= seconds
                    or cycle >= log_len - 2 * every - 2):
                break
        _sync(device)
        t1 = time.time()
    if device.type == "cuda":
        log(clocks.line())
        log(cycle_times_line(marks, warm, every))
    n = cycle - warm
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{bad}")
    window_losses = fit.losses(warm, cycle)
    failed = int((~torch.isfinite(window_losses)).sum())

    # cycle c: the first One-Euro refresh with PLAIN_PROFILED plain
    # cycles between it and the window
    c = -(-(cycle + PLAIN_PROFILED) // every) * every
    for k in range(cycle, c - PLAIN_PROFILED):
        fit.replay(k)

    def plain():
        for k in range(c - PLAIN_PROFILED, c):
            fit.replay(k)
    spans = {}
    if trace:
        from .trace import profile_call
        spans["plain"] = profile_call(plain, device)
    else:
        plain()
    pre = fit.snapshot()
    if trace:
        spans["refresh"] = profile_call(lambda: fit.replay(c), device)
    else:
        fit.replay(c)
    _sync(device)
    log(f"# post-window cycles {cycle}..{c} in "
        f"{time.time() - t1:.2f} s")
    post = fit.snapshot()
    loss_c = float(fit.losses(c, c + 1)[0])
    scene = fit.scene_depth()
    filtered = fit.filtered_targets()[:cfg["frames"]]
    p0 = fit.init_params
    prog_start = CK.Start(
        p0.poses_T[:cfg["frames"]].clone(),
        [float(x) for x in fit.losses(0, steps)],
        CK.norms([torch.sqrt(2.0 * nu) for nu in nu0]),
        CK.norms([a - b for a, b in zip(p_steps, p0)]))
    prog_windows, prog_chunk = tuple(fit.windows), fit.cfg.chunk
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    init_solve_s = fit.init_solve_s
    p0_kept = tuple(t.clone() for t in p0) if controls else None
    fit.close()
    del fit, p0

    # the reference, on the inputs as generated and the state read back
    t_ref = time.time()
    rin = to_device(inputs, device)
    body_t = body_tensors(body, device)
    lay = _layout(cell, inputs)
    data = RF.prepare(rin, lay)
    work = [] if trace else None
    ref_start = reference_start(body_t, rin, data, lay, steps)
    _sync(device)
    t_start = time.time()
    ref_step = reference_step(pre, c, body_t, data, lay, work)
    _sync(device)
    log(f"# reference: the start in {t_start - t_ref:.2f} s, cycle {c} in "
        f"{time.time() - t_start:.2f} s")
    prog_step = program_step(pre, post, loss_c, c, scene, filtered)
    for line in CK.leaf_lines(prog_start, ref_start, prog_step, ref_step):
        log(line)
    _sync(device)
    log(f"# reference: start ({steps} cycles) and cycle {c} in "
        f"{time.time() - t_ref:.2f} s")
    numbers = {"layout": float((prog_windows, prog_chunk)
                               != (lay.windows, lay.chunk))}
    numbers.update(CK.start_numbers(prog_start, ref_start))
    numbers.update(CK.step_numbers(prog_step, ref_step))
    correct, rows = CK.judge(numbers, {k: v for k, v in cell.limits.items()
                                       if k != "steps"})
    out = {"correct": bool(correct), "attempted": n, "failed": failed}

    T = cfg["frames"]
    if not trace:
        metrics = {
            "fit_frame_cycles_per_s": (T * n / (t1 - t0), "frame-cycles/s"),
            "peak_device_gib": (peak / 2 ** 30, "GiB"),
            "setup_s": (t0 - t_process, "s"),
        }
        want = [m["name"] for m in cell.end_to_end]
        out["metrics"] = {k: {"value": metrics[k][0], "unit": metrics[k][1]}
                          for k in want}
    else:
        facts = Facts(lay, n, t1 - t0, capture_s, init_solve_s, spans,
                      PLAIN_PROFILED, work,
                      len(body["v_template"]), len(body["faces"]))
        out["metrics"] = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(facts)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    out["device"] = device_info(device, peak)
    if trace:
        out["device"]["busy_s"] = sum(s.busy_s for s in spans.values())
        out["device"]["window_s"] = sum(s.wall_s for s in spans.values())
        out["breakdown"] = breakdown(spans)
    if controls:
        out["controls"] = control_readings(p0_kept, pre, c, body_t, rin,
                                           data, lay, steps, ref_start,
                                           ref_step, log)
        for name, nums in out["controls"].items():
            ok, _ = CK.judge(nums, {k: v for k, v in cell.limits.items()
                                    if k != "steps"})
            log(f"# control {name}: {'correct' if ok else 'not correct'}")
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def control_readings(p0, pre, c, body, rin, data, lay, steps, ref_start,
                     ref_step, log=print) -> Dict:
    """Each control's numbers: the reference with the control's change,
    put in the program's place. Its layout is the reference's own. The
    altered answer changes only the cycle's update, so its start is the
    reference's own; a frozen state is read off the reference's
    numbers."""
    out = {}
    for name in CONTROLS:
        if name in ("tf32", "halfbatch"):
            s = reference_start(body, rin, data, lay, steps, name)
            t = reference_step(pre, c, body, data, lay, None, name)
        elif name == "altered":
            s = ref_start
            t = ref_step._replace(updates=list(_alter(ref_step.updates,
                                                      lay.T // 2)))
        else:
            s = ref_start._replace(
                losses=[ref_start.losses[0]] * steps,
                grad_norms=[0.0] * len(ref_start.grad_norms),
                change_norms=[0.0] * len(ref_start.change_norms))
            t = ref_step._replace(
                grads=[torch.zeros_like(g) for g in ref_step.grads],
                updates=[torch.zeros_like(u) for u in ref_step.updates])
        nums = {"layout": 0.0}
        nums.update(CK.start_numbers(s, ref_start))
        nums.update(CK.step_numbers(t, ref_step))
        out[name] = nums
    # the reference's first gradient from the program's own init
    st = RF.start_state(tuple(p0))
    log("# grad_first from the program's init: ref leaf norms "
        + " ".join(f"{x:.3g}" for x in CK.norms(
            RF.cycle(st, 0, body, data, lay)[3])))
    return out


def cycle_times_line(marks, first: int, every: int) -> str:
    """The window's cycle times from the events recorded after each
    replay (the first cycle has no event before it)."""
    ms = np.asarray([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    if not len(ms):
        return "# cycle ms: too few cycles"
    cyc = np.arange(first + 1, first + 1 + len(ms))
    plain = ms[cyc % every != 0]
    half = len(plain) // 2
    return (f"# cycle ms (plain cycles): p10 {np.percentile(plain, 10):.2f} "
            f"median {np.median(plain):.2f} p90 {np.percentile(plain, 90):.2f}"
            f" max {plain.max():.2f}; medians of the halves "
            f"{np.median(plain[:half]):.2f} / {np.median(plain[half:]):.2f}; "
            f"refresh cycles {np.round(ms[cyc % every == 0], 2).tolist()}")


def device_info(device, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def breakdown(spans) -> Dict:
    ops: Dict[str, float] = {}
    for s in spans.values():
        for name, (_, sec) in s.ops.items():
            ops[name] = ops.get(name, 0.0) + sec
    gaps = sorted((g for s in spans.values() for g in s.gaps), reverse=True)
    return {"device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[label, sec] for sec, label in gaps[:10]]}

"""Smoke run of the PyTorch/CUDA port (mhmocap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero):
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles the raster kernels (ops/csrc/raster_*.cu), the
     face set-up kernels (ops/csrc/face_setup.cu), the fill-in kernel
     (ops/csrc/fillin.cu) and the window-loss kernels
     (ops/csrc/window_loss.cu) with nvcc for sm_90a and the host codecs
     (native/codecs.cpp) with g++, the five builds started at once, all
     into build/mhmocap_tpu_torch/, and prints the
     compilers, the build times and ptxas' register, spill and
     shared-memory report;
  3. kernels: each kernel against its plain torch version on the card
     at every raster call shape of phases 4, 6, 7, 9 and 10 and of
     bench-ts1 on 4 ranks (workload.KERNEL_SHAPES: posed full-size
     bodies, 29 per call at windows 160/128/112, 30 at 160/112/80,
     phase 7's, 12 at the full-frame 256, 34 and 17 at 160/128/112;
     errors printed beside their bounds), the forward's
     log1pf shortcut checked; at each shape the face set-up kernels
     (ops/csrc/face_setup.cu) first, against their plain version: tab
     and agg bit for bit (else the entries that differ and their
     largest gap in ulps), d_uvz to 1e-6 relative norm, two backward
     launches bit-identical, one launch counted a call; the raster
     kernels then run on the set-up kernel's tables; two forward and two backward launches
     bit-identical, one forward + backward at B=29, window 160 captured
     in a CUDA graph whose replay must be bit-identical to the eager
     launches, then, at the shapes of phases 4, 6 and 9
     (workload.TIMED_SHAPES), timed against the plain version on
     the same inputs; prints the active (cell, chunk) pairs (the JAX
     package's cell-major schedule, held equal to the backward's
     chunk-major cells) and the chunks per active cell, the pixel-face
     pairs among them whose coverage term is not 0 and those the
     forward's cull keeps, and each kernel's bound on that work and its
     share of it;
  3a. face set-up timing, at the fit's call shapes (29 bodies at
     windows 160 and 128): each set-up kernel on the device's clock (20
     launches captured in a CUDA graph, its replays between CUDA events)
     beside its bound (bytes over 3.35 TB/s: each input read once, each
     output written once), the plain version (eager) and the torch
     chain they replace (face_tables and its autograd backward, in a
     graph);
  3c. window loss: the window-loss kernel pair (ops/csrc/window_loss.cu)
     at the benchmark cells' chunk shapes (workload.WINDOW_LOSS_SHAPES:
     29 frames, 2 people, 256x256, windows 160/128; 39 frames, 3 people,
     240x135, windows 112/80/64) on workload.window_loss_inputs' cases
     against its plain version (ops/window_loss.py): per-pixel d_zbuf and
     d_sil bit for bit window_loss_bwd_plain's from the kernel's saved
     rows, both scalars and d_min_z, d_max_z to 1e-5 relative, two
     backward calls bit-identical, two launches counted each way; then
     each kernel pair timed (20 calls in a CUDA graph, CUDA events)
     beside its bound (bytes over 3.35 TB/s), the plain version (eager)
     and the torch chain it replaces (forward and autograd backward in a
     graph);
  3b. fill-in: the fill-in kernel (ops/csrc/fillin.cu) against its
     plain version (ops.image.fillin_plain) at its three call shapes,
     built from bench-ts1: the scene rebuild's map and mask (k 7,
     256x256), a 128-frame ingestion block of its disparity maps (k 7)
     and the final scene image's three channels (k 11): x, m and the
     pixels each round filled bit for bit, two launches bit-identical,
     the calls of each shape captured in a CUDA graph whose replay must
     equal the eager launches and count the same calls, rounds and live
     rounds; prints the live rounds of each call (read after it, off
     the path), the kernel's, the plain version's and an all-valid
     mask's ms (CUDA events) and the bound and share;
  4. main path: Predictor.run on the production workload (T=201, N=3,
     256x256, raster_window=160 -> windows 160/128/112) for 52 cycles,
     each one CUDA graph replay (phases 5-9 run the Predictor on the
     graphs too), so that the scene rebuild (cycle 30) and the One-Euro
     refresh (cycle 50) both run; the fit captures its 4 variants
     before its loop (CycleGraph.prepare), and every cycle from 30 is
     timed; checks the kernel launch counters (through the replays; the
     window-loss pair's: two launches each way a chunk, i.e. twice the
     raster's over the window groups), the 4 variants, the losses, the
     refreshes and the pickles, and
     prints the per-cycle, init-solve and capture seconds; fails on a
     raster call shape phase 3 did not check;
  5. reference: a tiny Predictor.run on the card against the same run on
     the CPU (plain torch path);
  6. entry points: writes two synthetic MuPoTs trees with the port's
     writer (TS1 with 3 people, TS2 with 2; 60 frames, 256x256, the full
     6890-vertex body, annot.mat GT), a sweep-style config (100 cycles,
     resize_factor 1.0, post_process_depth on), runs
     `predict_mupots.main --device cuda` on each tree and
     `eval_mupots.main` over both; prints the raster launches per tree,
     the ingestion seconds (decode / post-process / assignment), the
     init and per-cycle seconds, a replay's span on the card and the
     host gap share (CUDA events around each replay), and the FinalResults
     averages; checks the pickles against the JAX package's schema,
     finite metrics, each tree's pck_rel against its measured floor
     (ENTRY_MIN_PCK) and, as phase 4, the raster call shapes against
     phase 3's;
  6b. host codecs, on phase 7's tree before its fit: 2 of its 2048x2048
     frames parsed and entropy-decoded by the native decoder and by the
     plain Python one (`io._decode_scan`), coefficients and pixels
     (reconstructed on the card) bit-identical, and the split of a
     native parse (entropy decode, the rest in Python); its first
     disparity and label PNGs unfiltered natively and by
     `io._png_unfilter`, bit-identical; then the host parse of all its
     frames and `load_images` over them on the host thread map, on 1
     worker and on the map again (equal outputs): ms per frame and the
     worker count;
  7. shipped config: writes one degraded tree (the sweep's combined
     degradation plan: crossing paths, a person leaving the frame, an
     ID switch, detection and ROMP dropout, so that stale frames exist;
     32 frames, 3 people, 2048x2048) and runs `predict_mupots.main` with
     configs/predict_mupots_robust.yml unedited (250 cycles,
     resize_factor 0.125, gap_aware_temporal, id_swap_fix 0.5,
     post_process_depth, save_visualizations), then `eval_mupots.main`;
     prints the launches, the ingestion split, the per-cycle median
     (CUDA events between cycles), a replay's span and the host gap
     share,
     the seconds of the two exports and the FinalResults averages;
     checks stale frames, a live
     reg_gap_accel, both kernels launched, the visualization files and
     pickle, finite metrics and the raster call shapes;
  8. checkpoint and trace: a tiny sequence runs 4 cycles unbroken (with
     a profiler trace of cycle 2) and again as 2 + 2 cycles with
     checkpoint_every=1; the resumed run's stage-1 pickle and losses
     must equal the unbroken run's bit for bit, and the trace must exist;
  9. visualization and FHSOG, on phase 7's output (256x256, 32 frames, 3
     people, the full body): `visualization.main --device cuda` in scene
     mode with both captures (scene.ply, human_*.ply, camera view,
     colour and uint16 depth captures; depths inside the fit's z range)
     and in skeleton mode; then `build_fhsog_from_smpl` (128 bins) on the
     stage-1 visualization data, whose full-frame rasters must launch the
     forward kernel (at a shape phase 3 checked), checked against the
     same call on CPU tensors (the plain raster) over the first 2
     frames, and `carve_fog_with_meshes` at full size with frame 0's
     bodies, checked against the CPU on a strided subset of voxels;
     prints the seconds of each step and the raster's share of the
     build;
 10. sharded: bench-ts1 with its frames sharded over 2 ranks on the one
     card (`parallel/spmd.py`; gloo, since NCCL refuses two ranks on one
     GPU; the ranks started by `parallel/ranks.run_ranks`, file
     rendezvous, a deadline): chunk 34 x 3 a rank, padded 204, windows
     160/128/112, from one init written by this process, the fused
     cycles 30, 31 and 50 (scene rebuilds, filter refreshes at 30 and
     50) against the same cycles in this process on the same layout:
     cycle 30's loss, parts and gradients, the params after the three
     cycles, betas and xscale equal on both ranks, 9 forward and 9
     backward launches a rank a cycle, the raster call shapes against
     phase 3's; prints the seconds a cycle of both (a correctness run:
     two ranks on one card measure no speed-up) and the bytes each rank
     holds. The sharded cycles are eager (gloo's collectives cannot be
     captured), and so is the single process they are held to;
 11. graphs: bench-ts1 at full width from one init: the init solve's
     graph (one captured Adam step, replayed for the other 99) against
     its eager loop, then cycles 0-52 (every variant: no
     refresh, the scene rebuild from 30, both refreshes at 50, the
     rebuild with filters from 51) eagerly (`stage1_cycle_eager`) and
     through a `CycleGraph` whose `prepare` captured all four variants
     before cycle 0, each warmed up on a snapshot of the state that is
     then restored (as every fit on the card does): every cycle's loss
     and parts, the final params and RMSprop state bit-identical, 21
     forward and 21 backward launches a cycle on both paths and 14 + 14
     of the window-loss pair (two each way a chunk), counted by the
     kernels (every graph cycle a replay); prints prepare's seconds
     (each variant's warm-up and capture, and the snapshots), both
     runs' peak memory, the
     seconds a cycle of both paths over [30, 52) and at cycle 50 (a
     second replay of its graph), the device-busy share of a replayed
     cycle (torch.profiler, and CUDA events against the host clock), and
     `bench_multicycle`'s loop / graph / K=5 / K=15 cadence;
 11b. marks: the phase-mark kernel (ops/csrc/phase_mark.cu) captured
     into all four variants' graphs at bench-ts1's shape (7 chunks, 19
     slots) from phase 11's init, cycles 0-52: after each replay the
     ring row the kernel read from the device counter is filled, the
     other rows unchanged or -1, the slots copied from their
     predecessor (the phases a variant skips) those of the plain
     version (the CPU path of `PhaseMarks`, called in the same order),
     the rest increasing; a mark at a row outside the ring changes
     nothing; one launch counted a mark; the state bit-identical to
     phase 11's unmarked graphs; the groups' ms; a mark's time in a
     graph beside a one-element fill's (the launch that bounds it);
 12. bench: `python -m mhmocap_tpu_torch.bench`'s main at full size
     (bench.py's workload and line; its JSON and `#` lines printed with
     a "[12 bench]" prefix): three finite windows, each window's
     seconds a cycle within 15% of phase 11's replay median (a window
     that held a warm-up or a capture would read 35-75% slow), and the
     raster launches of its bare cycle's warm-up and 3 replays, the
     fit's 4 warm-ups and its 76 replays.
Phases 4, 6, 7 and 10-12 zero the fill-in kernel's counts (calls, round
launches, live rounds, counted on the card) with the raster counters
and read them after each run: every run must call it, with 64 round
launches a call; phase 10 holds each rank's counts a cycle to the one
process's, phase 11 the graphs' to the eager loop's (the same calls
stopping at the same round), only in the scene-rebuild cycles.
The last three lines are a JSON object with one entry per kernel (the
phase mark's launches are those of phase 11b, the window-loss pair's
those of phases 4 and 11),
nvidia-smi's name and power limit of the card, and
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NUM_CYCLES = 52

# The kernels must agree with the plain version to rounding: the
# planes, z test and coverage are evaluated with the same operation
# order (no FMA contraction), so z-buffer, coverage and winners match
# exactly but for ties; the silhouette log-sum and the gradient sums
# run in another order.
BOUNDS = {
    "zbuf_abs": 1e-5,            # metres at z ~ 3-5
    "coverage_frac": 1e-4,       # pixels covered by one side only
    "amin_frac": 1e-3,           # covered pixels with another winner
    "sil_abs": 1e-4,
    "dplanes_rel_max": 1e-4,     # max |err| / max |plain|
    "dplanes_rel_norm": 1e-5,    # ||err|| / ||plain||
}


# The least time the card could take for a kernel's work (bound_ms):
# the larger of its f32 operations over the H100 SXM's 67 TFLOP/s and
# its bytes (each input read once, each output written once) over
# 3.35 TB/s (NVIDIA's data sheet, 700 W). The operations are counted
# on this run's data (raster_cuda._pair_work): only the pixel-face
# pairs of active (cell, chunk) pairs whose coverage term is not
# exactly 0 (live), the covered ones among them and the depth winners
# do per-pair work, and a face's y terms are evaluated once per window
# row with a live pair. Operations from the plain version's arithmetic,
# a transcendental counted as one and |x| or -x as a free operand
# modifier:
#   forward, per live pair: 3 edge planes (9), the bbox clamp's x part
#     and its max with the y part (4), max (3), d|d| inv_blur (2),
#     log-sigmoid (4: min, expf, log1pf, sub), sum (1), cover test (1);
#     per covered pair: z plane (3), z > znear, z-min and winner (4);
#     per live row: the 4 planes' y products (4), the bbox's y part (3);
#   backward, per live pair: 3 edge planes (9), bbox (4), max (3), |d|,
#     d|d|, inv_blur (3), sigmoid (4: expf, 1 + e, select, divide),
#     g (4), routing to the winning edge (3), its 3 sums (3); per depth
#     winner: its 3 sums (3); per live row: the 3 edge planes' y
#     products (3), the bbox's y part (3), the 12 sums' rebase (24).
# Both kernels are built with --fmad=false, so a multiply and an add
# are two instructions and the attainable floor is about twice the
# operations bound.
F32_OPS_PER_S, HBM_BYTES_PER_S = 67e12, 3.35e12
OPS = {"fwd": {"live": 24, "covered": 7, "rows": 7},
       "bwd": {"live": 33, "winners": 3, "rows": 30}}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(ops, nbytes):
    """(bound ms, what sets it)."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    print(f"[1 device] {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"[1 device] nvidia-smi: {smi_line()}", flush=True)


def phase_build():
    """The raster kernels, the face set-up kernels, the fill-in kernel
    (nvcc) and the host codecs (g++), each build started at once on a
    thread of its own."""
    from concurrent.futures import ThreadPoolExecutor
    from mhmocap_tpu_torch import native
    from mhmocap_tpu_torch.ops import face_setup as FS
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    from mhmocap_tpu_torch.ops import window_loss as WL

    def timed(build):
        t0 = time.time()
        lib, log = build()
        return lib, log, time.time() - t0

    with ThreadPoolExecutor(5) as pool:
        jobs = {name: pool.submit(timed, build) for name, build in (
            ("raster", RC.build_kernels), ("face set-up", FS.build_kernels),
            ("fill-in", FC.build_kernels),
            ("window loss", WL.build_kernels),
            ("codecs", native.build_library))}
        built = {name: job.result() for name, job in jobs.items()}
    for name in ("raster", "face set-up", "fill-in", "window loss"):
        lib, log, dt = built[name]
        print(f"[2 build] {name} kernels {lib} in {dt:.2f}s"
              + ("" if log else " (already built)"), flush=True)
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                print(f"[2 build] ptxas: {line.strip()}")
    RC._library()
    FS._library()
    FC._library()
    WL._library()
    cxx = native.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    lib, log, dt = built["codecs"]
    print(f"[2 build] host codecs {lib} by {cxx} ({version}) "
          f"{' '.join(native.CXX_FLAGS)} in {dt:.2f}s"
          + (f": {log.strip()}" if log.strip() else ""), flush=True)
    native._library()
    return built["raster"][2]


def _raster_calls(cfg):
    """(bodies per call, window) of the raster calls of a cycle."""
    return {(cfg.chunk * len(ns), w) for w, ns in cfg.window_groups}


def _check_raster_calls(cfg, where, calls=None):
    from mhmocap_tpu_torch.workload import KERNEL_SHAPES
    calls = _raster_calls(cfg) if calls is None else calls
    checked = {(b, w) for b, wins in KERNEL_SHAPES for w in wins}
    print(f"[{where}] raster calls (bodies, window): {sorted(calls)}",
          flush=True)
    if not calls <= checked:
        raise AssertionError(f"{where}: raster calls {sorted(calls - checked)}"
                             f" were not held to the plain version in "
                             f"phase 3 ({sorted(checked)})")


def _reset_counts():
    """Zero the raster, face set-up, fill-in and window-loss kernels'
    launch counters."""
    from mhmocap_tpu_torch.ops import face_setup as FS
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    from mhmocap_tpu_torch.ops import window_loss as WL
    RC.launches.reset()
    FS.launches.reset()
    FC.launches.reset()
    WL.launches.reset()


COUNTED = ("fwd", "bwd", "setup_fwd", "setup_bwd")


def _raster_counts(where):
    """The raster kernels' launches since the last reset ("fwd", "bwd")
    and the face set-up's ("setup_fwd", "setup_bwd"), each counted by
    the kernel. Every raster call on the card launches one set-up
    forward and, if differentiated, one set-up backward, so each set-up
    count must equal the raster's."""
    from mhmocap_tpu_torch.ops import face_setup as FS
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    raster, faces = dict(RC.launches), dict(FS.launches)
    if faces != raster:
        raise AssertionError(f"{where}: face set-up launches {faces} are "
                             f"not the raster launches {raster}")
    return dict(raster, **{f"setup_{k}": v for k, v in faces.items()})


# the window-loss launches phases 4 and 11 counted, for the kernels JSON
WINDOW_LOSS_COUNTED = {"fwd": 0, "bwd": 0}


def _window_loss_counts(where, raster, groups):
    """The window-loss kernels' launches since the last reset, counted by
    the kernels. Each chunk of a fit makes one raster call a window group
    and one window-loss call (two launches forward, two backward), so
    each count must be twice the raster's over the groups."""
    from mhmocap_tpu_torch.ops import window_loss as WL
    got = dict(WL.launches)
    want = {k: 2 * (raster[k] // groups) for k in got}
    print(f"[{where}] window-loss kernels: {got} launches (want {want}: "
          f"two a chunk each way, raster {raster} over {groups} groups)",
          flush=True)
    if got != want or any(raster[k] % groups for k in got):
        raise AssertionError(f"{where}: window-loss launches {got}, want "
                             f"{want}")
    for k in got:
        WINDOW_LOSS_COUNTED[k] += got[k]
    return got


def _fillin_counts(where):
    """The fill-in's counts since the last reset (calls, round launches,
    live rounds), counted by the kernel; a path must have called it, with
    FILLIN_ITERS round launches a call, of which at least the first is
    live."""
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    got = dict(FC.launches)
    print(f"[{where}] fill-in kernel: {got['calls']} calls, {got['rounds']} "
          f"round launches, {got['live']} live rounds", flush=True)
    if not (got["calls"] > 0 and got["rounds"] == FILLIN_ITERS * got["calls"]
            and got["calls"] <= got["live"] <= got["rounds"]):
        raise AssertionError(f"{where}: fill-in counts {got}")
    return got


def phase_kernels():
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    from mhmocap_tpu_torch.ops.rasterizer import preorder_faces
    from mhmocap_tpu_torch.workload import (KERNEL_SHAPES, TIMED_SHAPES,
                                            cuda_ms, posed_uvz)
    dev = torch.device("cuda")
    # the faces in the Predictor's static spatial order, as on the main
    # path (the schedule is exact for any order; a coherent order gives
    # compact chunks and so fewer active (cell, chunk) pairs)
    model = preorder_faces(make_synthetic_smpl(device=dev))
    print(f"[3 kernels] body V={model.num_vertices} F={model.num_faces} "
          f"(faces preordered), (bodies per call, windows) {KERNEL_SHAPES}",
          flush=True)
    bad = RC.log1p_shortcut_mismatches(dev)
    print(f"[3 kernels] log1pf(e) != e for {bad} floats e in [0, "
          f"expf(-19)] (the forward's shortcut needs 0)", flush=True)
    if bad:
        raise AssertionError("the forward's log1pf shortcut is not exact")
    errs = {"fwd": 0.0, "bwd": 0.0}
    timing, setup = {}, {}
    for B, win in ((b, w) for b, wins in KERNEL_SHAPES for w in wins):
        uvz, origin, st = posed_uvz(model, win, B, seed=win, device=dev)
        setup[B, win] = _face_setup_check(model.faces, uvz, origin, st)
        tab, agg = setup[B, win].pop("tables")
        inv_blur, znear = 1.0 / st.sil_blur_px2, st.znear
        lists, bounds = RC._strip_chunk_lists(agg, win)
        if (B, win) in FACE_SETUP_TIMED:
            setup[B, win].update(_face_setup_timing(
                model.faces, uvz, origin, st, tab, agg, setup[B, win]))
        zk, lk, ak = RC.raster_fwd_cuda(tab, agg, win, inv_blur, znear)
        again = RC.raster_fwd_cuda(tab, agg, win, inv_blur, znear)
        zp, lp, ap = RC.raster_fwd_plain(tab, win, inv_blur, znear)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(again, (zk, lk, ak))):
            raise AssertionError(f"B={B} window {win}: two forward launches "
                                 f"on the same inputs differ")
        ck, cp = zk < RC.BIG, zp < RC.BIG
        both = ck & cp
        res = {
            "zbuf_abs": float((zk - zp)[both].abs().max()) if both.any()
            else 0.0,
            "coverage_frac": float((ck != cp).float().mean()),
            "amin_frac": float((ak != ap)[both].float().mean()),
            "sil_abs": float((torch.exp(lk) - torch.exp(lp)).abs().max()),
        }
        rng = np.random.RandomState(win + 1)
        dz = torch.as_tensor(rng.randn(B, win, win), dtype=torch.float32,
                             device=dev)
        dz = torch.where(ak >= 0, dz, torch.zeros_like(dz)).contiguous()
        dlk = torch.as_tensor(rng.randn(B, win, win),
                              dtype=torch.float32, device=dev)
        gk = RC.raster_bwd_cuda(tab, agg, dz, dlk, ak, win, inv_blur)
        gk2 = RC.raster_bwd_cuda(tab, agg, dz, dlk, ak, win, inv_blur)
        gp = RC.raster_bwd_plain(tab, dz, dlk, ak, win, inv_blur)
        torch.cuda.synchronize()
        if not torch.equal(gk, gk2):
            raise AssertionError(f"B={B} window {win}: two backward launches "
                                 f"on the same inputs differ")
        scale = float(gp.abs().max())
        res["dplanes_rel_max"] = float((gk - gp).abs().max()) / max(scale,
                                                                   1e-30)
        res["dplanes_rel_norm"] = float(torch.linalg.norm(gk - gp)
                                        / torch.linalg.norm(gp))
        if (B, win) == GRAPH_SHAPE:
            _graph_replay_check(tab, agg, dz, dlk, win, inv_blur, znear,
                                (zk, lk, ak), gk)
        errs["fwd"] = max(errs["fwd"], res["zbuf_abs"], res["sil_abs"])
        errs["bwd"] = max(errs["bwd"], float((gk - gp).abs().max()))
        covered = ck.reshape(B, -1).sum(-1)
        print(f"[3 kernels] B={B} win {win}: covered px per body "
              f"{int(covered.min())}..{int(covered.max())}, "
              + ", ".join(f"{k} {v:.3g} (bound {BOUNDS[k]:g})"
                          for k, v in res.items()), flush=True)
        for k, v in res.items():
            if not v <= BOUNDS[k]:
                raise AssertionError(f"kernel vs plain, B={B} window {win}: "
                                     f"{k} = {v} exceeds {BOUNDS[k]}")
        if int(covered.min()) == 0:
            raise AssertionError(f"B={B} window {win}: a body covers no "
                                 f"pixel")
        if (B, win) not in TIMED_SHAPES:
            continue

        # the work: active (cell, chunk) pairs of the JAX package's
        # cell-major schedule (the set the forward kernel visits), which
        # must be the backward's chunk-major cells exactly
        active = RC._active_pairs(agg, lists, bounds, win)
        pairs = int(active.sum())
        per_cell = active.sum(-1)
        per_cell = per_cell[per_cell > 0].float()
        cells = RC._chunk_cells(agg, win).long()
        chunk_major = int(((cells[..., 1] - cells[..., 0] + 1).clamp(min=0)
                           * (cells[..., 3] - cells[..., 2] + 1).clamp(min=0))
                          .sum())
        if chunk_major != pairs:
            raise AssertionError(f"B={B} window {win}: the backward's "
                                 f"chunk-major cells ({chunk_major}) are not "
                                 f"the forward's active pairs ({pairs})")
        pix_face = pairs * RC.STRIP_H * (win // RC._n_xb(win)) * RC.FACE_CHUNK
        live, covered, rows = RC._pair_work(tab, agg, lists, bounds, win,
                                            inv_blur)
        evaluated = RC._fwd_work(tab, agg, lists, bounds, win, inv_blur)
        n = {"live": live, "covered": covered, "rows": rows,
             "winners": int((ak >= 0).sum())}
        work = {   # (operations, bytes) per call
            k: (sum(ops * n[c] for c, ops in OPS[k].items()), nbytes)
            for k, nbytes in (
                ("fwd", _nbytes(tab, agg, zk, lk, ak)),
                ("bwd", _nbytes(tab, agg, dz, dlk, ak, gk)))}
        bound = {k: _bound(*v) for k, v in work.items()}
        t = {
            "plain_fwd": cuda_ms(lambda: RC.raster_fwd_plain(
                tab, win, inv_blur, znear), 2),
            "fwd": cuda_ms(lambda: RC.raster_fwd_cuda(
                tab, agg, win, inv_blur, znear), 20),
            "bwd": cuda_ms(lambda: RC.raster_bwd_cuda(
                tab, agg, dz, dlk, ak, win, inv_blur), 20),
            "plain_bwd": cuda_ms(lambda: RC.raster_bwd_plain(
                tab, dz, dlk, ak, win, inv_blur), 2),
        }
        timing[B, win] = dict(t, pairs=pairs, live=live, bound=bound)
        print(f"[3 kernels] time B={B} win {win}: "
              f"fwd {t['fwd']:.3f} ms (plain {t['plain_fwd']:.3f}), "
              f"bwd {t['bwd']:.3f} ms (plain {t['plain_bwd']:.3f})",
              flush=True)
        print(f"[3 kernels] work B={B} win {win}: {pairs} active (cell, "
              f"chunk) pairs in {per_cell.numel()} of "
              f"{active.shape[0] * active.shape[1]} (body, cell)s, "
              f"{float(per_cell.mean()):.2f} chunks per active cell (max "
              f"{int(per_cell.max())}), holding {pix_face} "
              f"pixel-face pairs, of which {live} live "
              f"({live / pix_face:.3f}) and {covered} covered; the forward "
              f"evaluates {evaluated} ({evaluated / pix_face:.3f}) after its "
              f"cull; {rows} live (body, row, face) rows; {n['winners']} "
              f"depth winners", flush=True)
        print(f"[3 kernels] bound B={B} win {win}: "
              + ", ".join(f"{k} {work[k][0] / 1e9:.3f} GFLOP and "
                          f"{work[k][1] / 1e6:.1f} MB, bound "
                          f"{bound[k][0]:.4f} ms ({bound[k][1]}), share "
                          f"{bound[k][0] / t[k]:.3f}"
                          for k in ("fwd", "bwd")), flush=True)
    return errs, timing, setup


# phase 3's CUDA graph check: the raster call shape of bench-ts1's
# largest window
GRAPH_SHAPE = (29, 160)


def _graph_replay_check(tab, agg, dz, dlk, win, inv_blur, znear, fwd, bwd):
    """One forward and one backward launch captured in a CUDA graph (the
    kernels launch on the current stream, the capture stream inside the
    capture); one replay must equal the eager launches bit for bit, and
    the kernels must count one launch each in it."""
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    out = {}

    def body():
        out["fwd"] = RC.raster_fwd_cuda(tab, agg, win, inv_blur, znear)
        out["bwd"] = RC.raster_bwd_cuda(tab, agg, dz, dlk, fwd[2], win,
                                        inv_blur)

    graph = capture_graph(body, tab.device)
    for t in (*out["fwd"], out["bwd"]):
        t.fill_(-7)
    RC.launches.reset()
    graph.replay()
    torch.cuda.synchronize()
    launches = dict(RC.launches)
    same = (all(torch.equal(a, b) for a, b in zip(out["fwd"], fwd))
            and torch.equal(out["bwd"], bwd))
    print(f"[3 kernels] B={tab.shape[0]} win {win}: forward + backward "
          f"captured in a CUDA graph ({launches} launches counted in a "
          f"replay), replay "
          f"bit-identical to the eager launches: {same}", flush=True)
    if not same or launches != {"fwd": 1, "bwd": 1}:
        raise AssertionError("the raster kernels' graph replay differs from "
                             "their eager launches")


# Phase 3a: the face set-up kernels timed at the fit's call shapes
FACE_SETUP_TIMED = ((29, 160), (29, 128))


def _bit_gap(a, b):
    """(entries of float32 a and b whose bits differ, the largest gap
    between them in units in the last place)."""
    ia, ib = (x.contiguous().view(torch.int32).long() for x in (a, b))

    def line(i):        # the floats' order as integers
        return torch.where(i < 0, -(i & 0x7fffffff), i)
    return int((ia != ib).sum()), int((line(ia) - line(ib)).abs().max())


def _graph_ms(fn, device, reps=20):
    """Mean ms of a call of fn on the device's clock: reps calls captured
    in one CUDA graph (the host's launch cost left out), its replays
    timed between CUDA events."""
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    from mhmocap_tpu_torch.workload import cuda_ms
    graph = capture_graph(lambda: [fn() for _ in range(reps)], device,
                          name="timed")
    return cuda_ms(graph.replay, 5) / reps


def _setup_args(faces, uvz, origin, st):
    """The face set-up's arguments (uvz, origin, faces, znear, inv_blur,
    reach_y), as rasterize_bodies passes them."""
    return (uvz, origin, faces, st.znear, 1.0 / st.sil_blur_px2,
            3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0)


def _face_setup_check(faces, uvz, origin, st):
    """Phase 3: the face set-up kernels against their plain version at
    one call shape. Returns the kernel's tables and the gaps."""
    from mhmocap_tpu_torch.ops import face_setup as FS
    B, win = uvz.shape[0], st.window
    args = _setup_args(faces, uvz, origin, st)
    FS.launches.reset()
    tab, agg = FS.face_setup_fwd_cuda(*args)
    ptab, pagg = FS.face_tables(*args)
    rng = np.random.RandomState(win + B)
    dtab = torch.as_tensor(rng.randn(B, tab.shape[2], 12),
                           dtype=torch.float32, device=uvz.device)
    gk = FS.face_setup_bwd_cuda(dtab, *args[:4])
    again = FS.face_setup_bwd_cuda(dtab, *args[:4])
    gp = FS.face_setup_bwd_plain(dtab, *args[:4])
    torch.cuda.synchronize()
    counted = dict(FS.launches)
    res = {"tab": _bit_gap(tab, ptab), "agg": _bit_gap(agg, pagg),
           "d_uvz": _bit_gap(gk, gp),
           "d_uvz_rel_norm": float(torch.linalg.norm(gk - gp)
                                   / torch.linalg.norm(gp))}
    print(f"[3 faces] B={B} win {win}: set-up kernels vs plain, (entries "
          f"that differ, largest ulp gap): tab {res['tab']} of "
          f"{tab.numel()}, agg {res['agg']} of {agg.numel()}, d_uvz "
          f"{res['d_uvz']} of {gk.numel()} (relative norm "
          f"{res['d_uvz_rel_norm']:.3g}, bound 1e-6); two backward "
          f"launches bit-identical: {torch.equal(gk, again)}; launches "
          f"counted {counted}", flush=True)
    if (res["tab"][0] or res["agg"][0] or not torch.equal(gk, again)
            or not res["d_uvz_rel_norm"] <= 1e-6
            or counted != {"fwd": 1, "bwd": 2}):
        raise AssertionError(f"face set-up kernels vs plain, B={B} window "
                             f"{win}: {res}, launches {counted}")
    return {"tables": (tab, agg), "errs": res, "dtab": dtab, "d_uvz": gk}


def _face_setup_timing(faces, uvz, origin, st, tab, agg, checked):
    """Phase 3a: the set-up kernels timed at one call shape beside their
    bound, their plain version and the torch chain they replace."""
    from mhmocap_tpu_torch.ops import face_setup as FS
    from mhmocap_tpu_torch.workload import cuda_ms
    dev = uvz.device
    B, win = uvz.shape[0], st.window
    args = _setup_args(faces, uvz, origin, st)
    dtab, gk = checked["dtab"], checked["d_uvz"]
    # the torch chain the kernels replace, forward and backward, as the
    # fit runs it: in a graph
    x = uvz.clone().requires_grad_(True)

    def chain():
        t, _ = FS.face_tables(x, *args[1:])
        torch.autograd.grad(t[:, :12], x, dtab.transpose(1, 2))

    fs32 = FS.incidence(faces, uvz.shape[1], dev)
    nbytes = {"fwd": _nbytes(uvz, origin, fs32[0], tab, agg),
              "bwd": _nbytes(uvz, origin, *fs32, dtab, gk)}
    t = {"fwd": _graph_ms(lambda: FS.face_setup_fwd_cuda(*args), dev),
         "bwd": _graph_ms(lambda: FS.face_setup_bwd_cuda(dtab, *args[:4]),
                          dev),
         "plain_fwd": cuda_ms(lambda: FS.face_tables(*args), 2),
         "plain_bwd": cuda_ms(lambda: FS.face_setup_bwd_plain(
             dtab, *args[:4]), 2),
         "chain": _graph_ms(chain, dev, 5)}
    bound = {k: _bound(0, nbytes[k]) for k in nbytes}
    print(f"[3a faces] time B={B} win {win}: "
          + ", ".join(f"{k} {t[k]:.4f} ms (plain {t['plain_' + k]:.3f}; "
                      f"{nbytes[k] / 1e6:.1f} MB, bound "
                      f"{bound[k][0]:.4f} ms, share "
                      f"{bound[k][0] / t[k]:.3f})"
                      for k in ("fwd", "bwd"))
          + f"; the torch chain they replace, forward + backward in a "
          f"CUDA graph: {t['chain']:.4f} ms", flush=True)
    return dict(t, bound=bound, bytes=nbytes)


# Phase 3c: the window-loss kernel pair (ops/csrc/window_loss.cu) at the
# benchmark cells' chunk shapes (workload.WINDOW_LOSS_SHAPES) on
# window_loss_inputs' cases: against its plain version (the saved n_pix
# and n_keep exact, the diffs and both scalars to 1e-5 relative; from
# the kernel's saved rows, d_zbuf and d_sil bit for bit
# window_loss_bwd_plain's, d_min_z and d_max_z to 1e-5 relative norm),
# then each kernel pair on the device's clock (20 calls in a CUDA graph)
# beside its bound: bytes over 3.35 TB/s, each input byte read once (the
# depths at the union of a frame's windows, the forward's masks over
# whole frames, the backward's at that union) and each output written
# once (the scratch between a pair's two kernels left out); the plain
# version (eager) and the torch chain it replaces, forward and autograd
# backward in a CUDA graph.
WINDOW_LOSS_COT = (0.75, -1.5)


def _window_loss_bytes(groups, rasters, inputs):
    """(forward, backward) bytes of a window-loss call, as above."""
    seg = inputs[3]
    C, N, H, W = seg.shape
    union = torch.zeros((C, H, W), dtype=torch.bool)
    win_px = 0
    for (win, group), (_, _, origin) in zip(groups, rasters):
        o = origin.reshape(C, len(group), 2).cpu().numpy()
        for c in range(C):
            for x0, y0 in o[c]:
                union[c, y0:y0 + win, x0:x0 + win] = True
        win_px += origin.shape[0] * win * win
    u = int(union.sum())
    small = 4 * (3 * C * N + 2 * C) + sum(8 * r[2].numel() for r in rasters)
    S = sum(C * len(g) for _, g in groups)
    fwd = 4 * (2 * win_px + win_px + u + C * N * H * W) + small \
        + 4 * (5 * S + 2)
    bwd = 4 * (2 * win_px + win_px + u + N * u + 5 * S + 2) + small \
        + 4 * (2 * win_px + 2 * C)
    return fwd, bwd


def phase_window_loss():
    from mhmocap_tpu_torch.ops import window_loss as WL
    from mhmocap_tpu_torch.workload import (WINDOW_LOSS_SHAPES, cuda_ms,
                                            window_loss_inputs)
    dev = torch.device("cuda")
    out = {}
    for cell, shape in WINDOW_LOSS_SHAPES.items():
        groups, rasters, inputs, eps = window_loss_inputs(shape, seed=17,
                                                          device=dev)
        leaves = ([inputs[1], inputs[2]] + [r[0] for r in rasters]
                  + [r[1] for r in rasters])
        rasters = [tuple(x.detach() for x in r) for r in rasters]
        inputs = [x.detach() for x in inputs]
        args = (groups, rasters, *inputs, eps)
        cot = [torch.tensor(g, device=dev) for g in WINDOW_LOSS_COT]
        WL.launches.reset()
        ld, ls, saved = WL.window_loss_fwd_cuda(*args)
        kz, ks, kmin, kmax = WL.window_loss_bwd_cuda(*args, saved, *cot)
        counted = dict(WL.launches)
        pd, ps = WL.window_losses_plain(*args)
        pz, pss, pmin, pmax = WL.window_loss_bwd_plain(*args, saved, *cot)
        again = WL.window_loss_bwd_cuda(*args, saved, *cot)
        torch.cuda.synchronize()
        bits = sum(_bit_gap(a, b)[0] for a, b in zip(kz + ks, pz + pss))
        rel = {"loss_depth": float(abs(ld - pd) / abs(pd)),
               "loss_sil": float(abs(ls - ps) / abs(ps)),
               "d_min_z": float(torch.linalg.norm(kmin - pmin)
                                / torch.linalg.norm(pmin)),
               "d_max_z": float(torch.linalg.norm(kmax - pmax)
                                / torch.linalg.norm(pmax))}
        same = all(torch.equal(a, b) for a, b in zip(
            again[0] + again[1] + [again[2], again[3]],
            kz + ks + [kmin, kmax]))
        print(f"[3c window loss] {cell} (C, N, (W, H), groups) {shape}: "
              f"kernels vs plain, per-pixel d_zbuf and d_sil entries whose "
              f"bits differ {bits}; relative gaps "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
              + f" (bound 1e-5); two backward calls bit-identical {same}; "
              f"launches counted {counted}", flush=True)
        if (bits or not same or not max(rel.values()) <= 1e-5
                or counted != {"fwd": 2, "bwd": 2}):
            raise AssertionError(f"window-loss kernels vs plain, {cell}: "
                                 f"bits {bits}, {rel}, launches {counted}")

        def chain():
            with torch.enable_grad():
                x = [v.clone().requires_grad_() for v in leaves]
                loss = WL.window_losses_plain(
                    groups, [(x[2 + i], x[2 + len(groups) + i], r[2])
                             for i, r in enumerate(rasters)],
                    inputs[0], x[0], x[1], *inputs[3:], eps)
                torch.autograd.grad(loss, x, cot)

        nbytes = dict(zip(("fwd", "bwd"),
                          _window_loss_bytes(groups, rasters, inputs)))
        t = {"fwd": _graph_ms(lambda: WL.window_loss_fwd_cuda(*args), dev),
             "bwd": _graph_ms(lambda: WL.window_loss_bwd_cuda(
                 *args, saved, *cot), dev),
             "plain_fwd": cuda_ms(lambda: WL.window_losses_plain(*args), 2),
             "plain_bwd": cuda_ms(lambda: WL.window_loss_bwd_plain(
                 *args, saved, *cot), 2),
             "chain": _graph_ms(chain, dev, 5)}
        bound = {k: _bound(0, nbytes[k]) for k in nbytes}
        print(f"[3c window loss] time {cell}: "
              + ", ".join(f"{k} {t[k]:.4f} ms (plain {t['plain_' + k]:.3f};"
                          f" {nbytes[k] / 1e6:.1f} MB, bound "
                          f"{bound[k][0]:.4f} ms, share "
                          f"{bound[k][0] / t[k]:.3f})" for k in ("fwd", "bwd"))
              + f"; the torch chain it replaces, forward + backward in a "
              f"CUDA graph: {t['chain']:.4f} ms", flush=True)
        out[cell] = dict(t, bound=bound, bytes=nbytes, bits=bits, rel=rel)
    return out


# Phase 3b: the fill-in kernel (ops/csrc/fillin.cu) against its plain
# version at its three call shapes, bit for bit. Every call on the paths
# runs FILLIN_ITERS (fillin_masked's default max_iters) round launches.
# Its work, for the bound, is counted on each call's data by
# _fillin_work; the rounds counted are the live ones (the last of them,
# where the loop ended, reads the state and fills nothing).
FILLIN_ITERS = 64
FILLIN_TILE = 16    # csrc/fillin.cu TILE: a round block's tile side


def _tile_sums(t, k):
    """(own, span): for (B, H, W) t, each round block's sum of t over
    its tile and over the span it stages (the tile and a halo of
    k // 2, zero outside the frame), both (B, tiles_y, tiles_x)."""
    import torch.nn.functional as F
    T, pad = FILLIN_TILE, k // 2
    H, W = t.shape[-2:]
    ey, ex = -(-H // T) * T - H, -(-W // T) * T - W
    t = t.to(torch.float64)[:, None]
    own = F.avg_pool2d(F.pad(t, (0, ex, 0, ey)), T) * T * T
    S = T + 2 * pad
    span = F.avg_pool2d(F.pad(t, (pad, ex + pad, pad, ey + pad)), S,
                        stride=T) * S * S
    return own[:, 0].round(), span[:, 0].round()


def _fillin_work(x, m, k, filled):
    """(operations, bytes) of one fill-in call on (x, m), counted from
    the state at the start of each live round (`fillin_plain` run that
    many rounds; `filled`, the pixels each round filled, has one entry a
    live round). Bytes: the init reads m and writes fr (8 a pixel); a
    live round reads the fr of every pixel of the frames whose mask
    holds no NaN (4 a pixel); a block whose tile holds a hole also
    stages the fr of its halo and the x of each valid pixel of its span
    (4 each, inside the frame); each pixel a round fills writes x, m and
    fr (12). The wrapper's copies of x and m are not counted.
    Operations: a validity test per window slot at each hole, and at
    each pixel filled the selection of two order statistics (about 2
    compares a slot) and the mean (2)."""
    from mhmocap_tpu_torch.ops.image import fillin_plain
    H, W = m.shape[-2:]
    frames = ~torch.isnan(m.reshape(-1, H, W)).flatten(1).any(1)
    ops, nbytes = 0, 8 * m.numel()
    if not bool(frames.any()):
        return ops, nbytes
    own_px, span_px = _tile_sums(torch.ones_like(m.reshape(-1, H, W)[:1]),
                                 k)
    for r, f in enumerate(filled):
        mr = m if r == 0 else fillin_plain(x, m, k, r)[1]
        mr = mr.reshape(-1, H, W)[frames]
        hole = mr < 0.5
        hole_tile = _tile_sums(hole, k)[0] > 0
        staged = (span_px - own_px) + _tile_sums(mr > 0.5, k)[1]
        nbytes += (4 * mr.numel() + 4 * int((staged * hole_tile).sum())
                   + 12 * f)
        ops += int(hole.sum()) * k * k + f * (2 * k * k + 2)
    return ops, nbytes


def _recording_fillin(calls):
    """A stand-in for ops.image.fillin_masked that records the (x, mask,
    k) of each call before it runs the wrapper."""
    from mhmocap_tpu_torch.ops import image
    wrapper = image.fillin_masked

    def record(x, mask, filter_size, max_iters=FILLIN_ITERS):
        calls.append((x.clone(), mask.clone(), filter_size))
        return wrapper(x, mask, filter_size, max_iters)

    return record


def _fillin_inputs(dev):
    """{shape: [(x, mask, k), ...]}, the calls a path makes at each of
    the fill-in's three call shapes, from bench-ts1: the scene rebuild
    (update_scene at the init params: its bilateral-filtered map and
    outlier mask, k 7, 256x256), the ingestion post-process of a
    128-frame block of its disparity maps (min-max normalized per frame
    as ingestion does, k 7), and the final scene image (the mask
    Predictor._final_scene builds from its background masks under three
    channels of seeded values in [0, 255], since bench-ts1's images are
    black; k 11, one call a channel)."""
    from mhmocap_tpu_torch.data.ingestion import DISP_BLOCK
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.ops import image
    from mhmocap_tpu_torch.workload import (WINDOW, bench_args,
                                            make_ts1_like_seq)
    seq, model = make_ts1_like_seq()
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, WINDOW),
                         device=dev)
    params, _, _ = E.init_params(pred.model, seq.pose2d, seq.poses_smpl,
                                 seq.betas_smpl, seq.cam["K"], pred.cfg)
    data = E.prepare_seq_data(seq, pred.cfg, dev)
    disp = seq.depths[:DISP_BLOCK]
    lo = disp.min(axis=(1, 2), keepdims=True)
    disp = (disp - lo) / np.maximum(disp.max(axis=(1, 2), keepdims=True)
                                    - lo, np.float32(1e-8))
    calls, wrapper = [], image.fillin_masked
    image.fillin_masked = _recording_fillin(calls)
    try:
        E.update_scene(params, data, pred.cfg)
        image.postprocess_dispmap(torch.as_tensor(disp, device=dev),
                                  minz=1, maxz=100, fillin_ksize=7)
    finally:
        image.fillin_masked = wrapper
    mask = torch.as_tensor(
        (~np.all(seq.backmasks <= 0.5, axis=0)).astype(np.float32),
        device=dev)
    rgb = np.random.RandomState(3).randint(0, 256, (3,) + mask.shape)
    return {"scene": calls[:1], "ingestion": calls[1:],
            "final_scene": [(torch.as_tensor(c, dtype=torch.float32,
                                             device=dev), mask, 11)
                            for c in rgb]}


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _live_rounds(per_round):
    """The rounds a call ran past the stop test: up to and including
    the first that filled nothing."""
    zero = (per_round == 0).nonzero()
    return int(zero[0]) + 1 if len(zero) else len(per_round)


def phase_fillin():
    """Phase 3b: the fill-in kernel against its plain version at the
    three call shapes, a graph replay against the eager launch, and
    times beside the bound."""
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    from mhmocap_tpu_torch.ops.image import fillin_plain
    from mhmocap_tpu_torch.workload import cuda_ms
    dev = torch.device("cuda")
    t0 = time.time()
    shapes = _fillin_inputs(dev)
    print(f"[3b fill-in] inputs from bench-ts1 in {time.time() - t0:.1f}s: "
          + ", ".join(f"{name} {len(c)} x {tuple(c[0][0].shape)} k {c[0][2]}"
                      for name, c in shapes.items()), flush=True)
    out, worst = {}, 0.0
    for name, calls in shapes.items():
        fails = []
        ops = nbytes = 0
        rounds, eager = [], []
        for x, m, k in calls:
            kx, km, per_round = FC.fillin_cuda(x, m, k)
            again = FC.fillin_cuda(x, m, k)
            px, pm, filled = fillin_plain(x, m, k)
            torch.cuda.synchronize()
            eager.append((kx, km, per_round))
            if not all(_same_bits(a, b) for a, b in zip(again, eager[-1])):
                fails.append("two launches differ")
            if not (_same_bits(kx, px) and _same_bits(km, pm)):
                fails.append("kernel and plain version differ")
            diff = torch.where(kx == px, torch.zeros_like(kx),
                               (kx - px).abs())
            worst = max(worst, float(torch.nan_to_num(diff, nan=0.0).max()))
            want = filled + [0] * (FILLIN_ITERS - len(filled))
            if per_round.tolist() != want:
                fails.append(f"pixels filled a round {per_round.tolist()} "
                             f"!= the plain version's {filled}")
            rounds.append(_live_rounds(per_round))
            o, b = _fillin_work(x, m, k, filled)
            ops, nbytes = ops + o, nbytes + b
        # the calls captured in one graph; its replay must equal the
        # eager launches and count what they counted
        got = []
        graph = capture_graph(
            lambda: got.__setitem__(slice(None), [
                FC.fillin_cuda(x, m, k) for x, m, k in calls]), dev)
        for r in got:
            for a in r:
                a.fill_(-7)
        FC.launches.reset()
        graph.replay()
        torch.cuda.synchronize()
        counts = dict(FC.launches)
        same = all(_same_bits(a, b) for r, e in zip(got, eager)
                   for a, b in zip(r, e))
        want = {"calls": len(calls), "rounds": FILLIN_ITERS * len(calls),
                "live": sum(rounds)}
        if not same or counts != want:
            fails.append(f"graph replay bit-identical {same}, counts "
                         f"{counts} (want {want})")

        def kernel():
            for x, m, k in calls:
                FC.fillin_cuda(x, m, k)

        def plain():
            for x, m, k in calls:
                fillin_plain(x, m, k)

        def empty():
            for x, m, k in calls:
                FC.fillin_cuda(x, torch.ones_like(m), k)

        t = {"ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 2),
             "empty_ms": cuda_ms(empty, 20)}
        bound_ms, bound_by = _bound(ops, nbytes)
        out[name] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                         rounds=rounds, calls=len(calls))
        print(f"[3b fill-in] {name}: {len(calls)} call(s) of "
              f"{tuple(calls[0][0].shape)} k {calls[0][2]}, live rounds "
              f"{rounds} of {FILLIN_ITERS} launched; kernel = plain bit for "
              f"bit and graph replay = eager launch: {not fails}; kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, a call on a "
              f"full mask (1 live round) {t['empty_ms']:.4f} ms; work "
              f"{ops / 1e6:.2f} M ops and {nbytes / 1e6:.2f} MB, bound "
              f"{bound_ms:.5f} ms ({bound_by}), share "
              f"{bound_ms / t['ms']:.4f}", flush=True)
        if fails:
            raise AssertionError(f"fill-in {name}: " + "; ".join(fails))
    out["max_abs_err"] = worst
    return out


INIT_KEYS = {"scale_factor", "poses_T", "poses_smpl", "betas_smpl",
             "valid_smpl", "min_z", "max_z", "scene_depth", "scene_img",
             "scene_mask", "pose2d"}
STAGE1_KEYS = (INIT_KEYS - {"pose2d"}) | {
    "raster_window", "window_clip_rate", "raster_windows",
    "window_clip_rates"}


def _load_pickles(out_dir, schema=None):
    import pickle
    res = {}
    for name, keys in (schema or {"optvar_init.pkl": INIT_KEYS,
                                  "optvar_stage1.pkl": STAGE1_KEYS}).items():
        with open(os.path.join(out_dir, name), "rb") as f:
            d = pickle.load(f)
        if set(d) != keys:
            raise AssertionError(f"{name} keys {sorted(d)} != "
                                 f"{sorted(keys)}")
        res[name] = d
    return res


def phase_main_path(out_dir):
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.workload import (T, WINDOW, bench_args,
                                            make_ts1_like_seq)
    seq, model = make_ts1_like_seq()
    args = bench_args(NUM_CYCLES, tuple(range(30, NUM_CYCLES + 1)), WINDOW,
                      verbose=True)
    pred = Predictor(seq, model, out_dir, args, device="cuda")
    cfg = pred.cfg
    print(f"[4 main] T={cfg.num_frames} padded {cfg.padded_frames} "
          f"chunk {cfg.chunk} x {cfg.num_chunks}, windows "
          f"{cfg.person_windows}, V={model.num_vertices} "
          f"F={model.num_faces}", flush=True)
    _check_raster_calls(cfg, "4 main")
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = pred.run(verbose=True)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = _raster_counts("4 main")
    fill = _fillin_counts("4 main")
    wl = _window_loss_counts("4 main", launches, len(cfg.window_groups))
    print(f"[4 main] window-loss launches a cycle: "
          f"{2 * cfg.num_chunks} forward and {2 * cfg.num_chunks} backward "
          f"({cfg.num_chunks} chunks); the run's {wl}", flush=True)
    losses = pred.stage1_losses
    per_cycle = np.asarray(pred.bench_window_seconds)
    print(f"[4 main] launches {launches}; losses cycle 0 {losses[0]:.6f} "
          f"cycle 30 {losses[30]:.6f} last {losses[-1]:.6f}", flush=True)
    print(f"[4 main] init solve {pred.init_seconds:.3f}s, per-cycle median "
          f"{np.median(per_cycle):.4f}s over cycles [30, {NUM_CYCLES}) "
          f"(min {per_cycle.min():.4f}, max {per_cycle.max():.4f}), "
          f"{T / np.median(per_cycle):.2f} frame-cycles/s, run {run_s:.1f}s, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"[4 main] {len(pred.capture_seconds)} variants captured before "
          f"the loop, (warm-up, capture) s: "
          + ", ".join(f"{tuple(int(x) for x in v)} ({w:.3f}, {c:.3f})"
                      for v, (w, c) in pred.capture_seconds.items()),
          flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a raster kernel never launched: {launches}")
    if len(pred.capture_seconds) != 4:
        raise AssertionError(f"{len(pred.capture_seconds)} variants "
                             f"captured, not 4")
    if len(losses) != NUM_CYCLES or not np.isfinite(losses).all():
        raise AssertionError(f"non-finite or missing losses: {losses}")
    log_parts = np.asarray([list(r.values()) for r in out["stage1_log"]])
    if not np.isfinite(log_parts).all():
        raise AssertionError("non-finite loss parts")
    # the loss gains terms when the scene (warmup_cycles) and the
    # filtered targets (first refresh at or after warmup) engage, so it
    # must fall over each span in which its terms are fixed
    filt = -(-cfg.warmup_cycles // cfg.update_filters_every) \
        * cfg.update_filters_every
    for a, b in ((0, cfg.warmup_cycles), (cfg.warmup_cycles, filt),
                 (filt, NUM_CYCLES)):
        print(f"[4 main] loss over cycles [{a}, {b}): {losses[a]:.6f} -> "
              f"{losses[b - 1]:.6f}", flush=True)
        if not losses[b - 1] < losses[a]:
            raise AssertionError(f"stage-1 loss did not fall over cycles "
                                 f"[{a}, {b}): {losses[a]} -> "
                                 f"{losses[b - 1]}")
    if not (pred._aux.have_scene and pred._aux.have_filters):
        raise AssertionError("scene or filter refresh never ran")
    pk = _load_pickles(out_dir)
    st1 = pk["optvar_stage1.pkl"]
    if st1["poses_T"].shape != (T, 3, 1, 3) or not np.isfinite(
            st1["poses_T"]).all() or st1["scene_depth"] is None:
        raise AssertionError("optvar_stage1.pkl content is wrong")
    return launches, fill


# Each of the 2 entries of the xscale gradient sums the scale's effect
# over every vertex of a person in every frame, and its loss terms
# cancel: on the tiny sequence person 0's depth part (-2.05e-4) and
# silhouette part (+2.22e-4) leave 3.6e-5, 12x below their magnitudes
# (CPU plain path). Its relative error is the terms' times that
# factor: 1.07e-2 on an H100 against the CPU, while the pose gradients
# agree to 6e-4 there.
# The first RMSprop step moves by about lr * sign(g), so the sign is
# what the update sees.
GRAD_BOUNDS = {"xscale": 5e-2}


def _cycle0(pred, params_np):
    """Cycle 0's loss and gradient on the Predictor's device, from the
    given numpy params (no scene yet)."""
    from mhmocap_tpu_torch import convert
    from mhmocap_tpu_torch.engine import optimizer as E
    seq, cfg, dev = pred.seq, pred.cfg, pred.device
    params = convert.params_from_numpy(params_np, dev)
    betas_ref = torch.as_tensor(np.mean(seq.betas_smpl, axis=0,
                                        keepdims=True), device=dev)
    aux = E.init_aux(cfg, pred.model.num_vertices, betas_ref)
    loss, _, grads = E.cycle_loss_and_grads(
        params, pred.model, E.prepare_seq_data(seq, cfg, dev), aux,
        pred.coefs, cfg)
    return float(loss), convert.params_to_numpy(grads)


def phase_reference(out_dir):
    """Tiny sequence: the card's main path (kernels) against the CPU
    plain path.

    The init pickle is held to 5e-3 and cycle 0's loss to 1e-4
    relative. From the same params, cycle 0's gradient agrees to 1e-2
    relative norm per parameter (a hard z-buffer winner can flip at an
    ulp-level vertex difference), but for the scale's (see
    GRAD_BOUNDS), whose sign must agree. RMSprop's first steps are about
    lr * sign(g), so a near-zero gradient component whose sign the
    rounding decides moves a full step the other way: after 3 cycles
    99% of the stage-1 entries (all arrays together) agree to 5e-3 and
    all to the reach of 3 steps (0.08; lr 0.01, momentum 0.9). Every
    comparison is printed before the phase fails."""
    from mhmocap_tpu_torch import convert
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.workload import bench_args, make_ts1_like_seq
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    seq, _ = make_ts1_like_seq(T=8, N=2, side=128, model=model)
    res, losses, preds = {}, {}, {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(out_dir, dev)
        pred = Predictor(seq, model, d, bench_args(3, None, 64), device=dev)
        pred.run(verbose=False)
        res[dev] = _load_pickles(d)
        losses[dev] = pred.stage1_losses
        preds[dev] = pred

    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)

    for k in ("poses_T", "min_z", "max_z"):
        err = float(np.abs(res["cuda"]["optvar_init.pkl"][k]
                           - res["cpu"]["optvar_init.pkl"][k]).max())
        print(f"[5 reference] optvar_init.pkl {k}: card vs CPU max err "
              f"{err:.3g} (bound 5e-3)", flush=True)
        check(err <= 5e-3, f"optvar_init.pkl {k}: {err}")
    diffs = []
    for k in ("poses_T", "poses_smpl", "betas_smpl", "min_z", "max_z",
              "scale_factor"):
        diff = np.abs(res["cuda"]["optvar_stage1.pkl"][k]
                      - res["cpu"]["optvar_stage1.pkl"][k]).ravel()
        diffs.append(diff)
        print(f"[5 reference] optvar_stage1.pkl {k}: card vs CPU max err "
              f"{diff.max():.3g} (bound 0.08), {int(np.sum(diff > 5e-3))} of "
              f"{diff.size} entries beyond 5e-3", flush=True)
        check(diff.max() <= 0.08, f"optvar_stage1.pkl {k}: {diff.max()}")
    within = float(np.mean(np.concatenate(diffs) <= 5e-3))
    print(f"[5 reference] optvar_stage1.pkl: share of entries within 5e-3 "
          f"{within:.4f} (bound 0.99)", flush=True)
    check(within >= 0.99, f"optvar_stage1.pkl share within 5e-3: {within}")
    rel = np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])
    print(f"[5 reference] stage-1 loss rel err per cycle {rel} (bound 1e-4 "
          f"on cycle 0, 1e-2 after)", flush=True)
    check(rel[0] <= 1e-4 and (rel <= 1e-2).all(), f"losses: {rel}")

    p = preds["cpu"]
    init, _, _ = E.init_params(p.model, seq.pose2d, seq.poses_smpl,
                               seq.betas_smpl, seq.cam["K"], p.cfg)
    init = convert.params_to_numpy(init)
    (lc, gc), (lh, gh) = (_cycle0(preds[dev], init) for dev in ("cuda", "cpu"))
    print(f"[5 reference] cycle 0 from the same params: loss {lc:.6f} card, "
          f"{lh:.6f} CPU (bound 1e-4 relative)", flush=True)
    check(abs(lc - lh) <= 1e-4 * abs(lh), f"cycle-0 loss: {lc} vs {lh}")
    for k in gh:
        rel_g = float(np.linalg.norm(gc[k] - gh[k])
                      / max(np.linalg.norm(gh[k]), 1e-30))
        bound = GRAD_BOUNDS.get(k, 1e-2)
        print(f"[5 reference] cycle 0 gradient {k}: rel norm err "
              f"{rel_g:.3g} (bound {bound:g})", flush=True)
        check(rel_g <= bound, f"cycle-0 gradient {k}: {rel_g}")
    same_sign = float(np.mean(np.sign(gc["xscale"]) == np.sign(gh["xscale"])))
    print(f"[5 reference] cycle 0 gradient xscale: same sign on "
          f"{same_sign:.2f} of its entries (bound 1)", flush=True)
    check(same_sign == 1.0, "cycle-0 gradient xscale changed sign")
    if fails:
        raise AssertionError("card vs CPU: " + "; ".join(fails))


# The pickles of an on-disk sequence, with the JAX package's keys (the
# stage-1 pickle carries ingestion's lagged_tn).
ENTRY_SCHEMA = {
    "optvar_init.pkl": INIT_KEYS,
    "optvar_stage1.pkl": STAGE1_KEYS | {"lagged_tn"},
    "mupots_annot.pkl": {"pose3d_gt", "pose3d_univ_gt", "visibility",
                         "cam_K"},
}
ENTRY_TREES = ((1, 3), (2, 2))       # (TS id, people)
ENTRY_FRAMES, ENTRY_CYCLES = 60, 100
# pck_rel floor per tree: the lowest of three phase-6 runs less one
# point. Three runs on an H100 80GB HBM3 at 700.00 W (nvidia-smi) read
# 97.5 (TS1) and 100.0 (TS2) every time: trees, kernels and fit are
# deterministic. TS1 sits below the clean sweep's 98.5, which bounds
# the 5-tree average; the same tree reads 97.74 in that sweep.
ENTRY_MIN_PCK = {1: 96.5, 2: 99.0}


def phase_entry_points(tmp):
    """The on-disk chain: port-written trees -> predict_mupots -> eval."""
    from mhmocap_tpu_torch import eval_mupots, predict_mupots, sweep
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    body = make_synthetic_smpl()
    for ts, people in ENTRY_TREES:
        t0 = time.time()
        generate_sequence(os.path.join(data, f"TS{ts}"),
                          num_frames=ENTRY_FRAMES, num_people=people,
                          image_size=(256, 256), model=body, seed=7 + ts,
                          mupots_gt=True)
        print(f"[6 entry] wrote TS{ts} ({people} people, {ENTRY_FRAMES} "
              f"frames, 256x256, V={body.num_vertices}) in "
              f"{time.time() - t0:.1f}s", flush=True)
    cfg = sweep.write_config(
        os.path.join(tmp, "predict.yml"),
        sweep.sweep_config(data, ENTRY_CYCLES, post_process_depth=True,
                           bench_cycles=list(range(30, ENTRY_CYCLES + 1))))
    launches, fill = {}, {}
    for ts, _ in ENTRY_TREES:
        _reset_counts()
        t0 = time.time()
        with CycleClock() as clock:
            summary = predict_mupots.main(
                ["--configs_yml", cfg, "--ts_id", str(ts), "--output_path",
                 out, "--device", "cuda"])
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches[ts] = _raster_counts(f"6 entry TS{ts}")
        fill[ts] = _fillin_counts(f"6 entry TS{ts}")
        _check_raster_calls(summary["engine_config"], f"6 entry TS{ts}")
        ing = summary["ingest_seconds"]
        cyc = np.asarray(summary["cycle_seconds"])
        print(f"[6 entry] TS{ts}: raster launches {launches[ts]}; ingestion "
              f"{ing['total']:.3f}s (decode {ing['decode']:.3f}, "
              f"{1e3 * ing['decode'] / ENTRY_FRAMES:.1f} ms per frame, "
              f"post-process {ing['postprocess']:.3f}, assignment "
              f"{ing['assignment']:.3f}); init solve "
              f"{summary['init_seconds']:.3f}s; per-cycle median "
              f"{np.median(cyc):.4f}s over cycles [30, {ENTRY_CYCLES}) "
              f"(min {cyc.min():.4f}, max {cyc.max():.4f}), "
              f"{clock.report(30)}; predict_mupots {wall:.1f}s", flush=True)
        if min(launches[ts].values()) <= 0:
            raise AssertionError(f"TS{ts}: a raster kernel never launched: "
                                 f"{launches[ts]}")
        _load_pickles(os.path.join(out, f"TS{ts}"), ENTRY_SCHEMA)
    final = eval_mupots.main(["--configs_yml", cfg, "--input_path", out,
                              "--device", "cuda"])
    print("[6 entry] FinalResults averages: " + json.dumps(
        {k: v[-1] for k, v in final.items()}), flush=True)
    print("[6 entry] per tree pck_rel " + json.dumps(final["pck_rel"][:-1])
          + ", mm_rel_error " + json.dumps(final["mm_rel_error"][:-1]),
          flush=True)
    if not all(np.isfinite(v).all() for v in final.values()):
        raise AssertionError(f"non-finite metrics: {final}")
    low = [(ts, p) for (ts, _), p in zip(ENTRY_TREES, final["pck_rel"])
           if not p >= ENTRY_MIN_PCK[ts]]
    if low:
        raise AssertionError(f"(TS, pck_rel) {low} below the floors "
                             f"{ENTRY_MIN_PCK}")
    return launches, fill


# Phase 7: the robust profile's shipped config on a degraded tree. The
# combined degradation plan is the one with stale frames: in the others
# ingestion refreshes every dropped detection from the ROMP projection.
# The tree is written at 2048x2048 so that the config's resize_factor
# 0.125 gives 256x256; 32 frames (one chunk of 32, as a long sequence's
# 16-48) keep the host JPEG encode and decode of the full-size frames
# within the smoke's time.
ROBUST_CONFIG = "configs/predict_mupots_robust.yml"
ROBUST_TS, ROBUST_PEOPLE, ROBUST_FRAMES, ROBUST_SIDE = 5, 3, 32, 2048
ROBUST_CYCLES = 250                  # the config's num_iter
VIS_FILES = {"fig_optim_curves_init.png", "fig_optim_curves_stage1.png",
             "vis_init", "vis_stage1", "visualization_data_stage1.pkl"}
VIS_KEYS = {"images", "depths", "backmasks", "cam_smpl", "cam", "verts",
            "valid", "pose2d"}


class CycleClock:
    """Records CUDA events before and after each stage-1 cycle (a
    `CycleGraph` replay) while active, with no host synchronization, so
    that the per-cycle times of a run can be read afterwards: the card's
    timeline between consecutive cycles' ends, and the span of each
    replay on the card. The rest of a cycle's timeline is the host's gap
    between replays; the span is not busy time (the gaps between a
    graph's kernels count in it), so 1 - span / cycle is no idle
    share."""

    def __init__(self):
        from mhmocap_tpu_torch.engine.cycle_graph import CycleGraph
        self.cls, self.replay, self.events = CycleGraph, CycleGraph.replay, []

    def __enter__(self):
        def timed(graph, cycle):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = self.replay(graph, cycle)
            b.record()
            self.events.append((a, b))
            return out
        self.cls.replay = timed
        return self

    def __exit__(self, *exc):
        self.cls.replay = self.replay

    def seconds(self) -> np.ndarray:
        """Seconds of cycles 1.. (cycle 0 has no event before it)."""
        torch.cuda.synchronize()
        return np.asarray([a[1].elapsed_time(b[1]) / 1e3 for a, b in
                           zip(self.events, self.events[1:])])

    def spans(self) -> np.ndarray:
        """Seconds of each replay on the card, cycles 0.. (a variant's
        first cycle includes its warm-up and capture)."""
        torch.cuda.synchronize()
        return np.asarray([a.elapsed_time(b) / 1e3 for a, b in self.events])

    def report(self, first: int) -> str:
        """The medians from cycle `first` on: cycle, replay span, and the
        host gap share 1 - span / cycle."""
        cyc, span = np.median(self.seconds()[first - 1:]), np.median(
            self.spans()[first:])
        return (f"replay span median {span:.4f}s of a {cyc:.4f}s cycle "
                f"(host gap share {1 - span / cyc:.3f})")


def write_robust_tree(tmp) -> str:
    """Phase 7's degraded tree, under tmp/data; returns its TS folder."""
    from mhmocap_tpu_torch import sweep
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    ts_dir = os.path.join(tmp, "data", f"TS{ROBUST_TS}")
    t0 = time.time()
    generate_sequence(
        ts_dir, num_frames=ROBUST_FRAMES, num_people=ROBUST_PEOPLE,
        image_size=(ROBUST_SIDE, ROBUST_SIDE), model=make_synthetic_smpl(),
        seed=7 + ROBUST_TS, mupots_gt=True,
        degradations=sweep.degradation_plan(ROBUST_TS, ROBUST_FRAMES))
    print(f"[7 robust] wrote TS{ROBUST_TS} ({ROBUST_PEOPLE} people, "
          f"{ROBUST_FRAMES} frames, {ROBUST_SIDE}x{ROBUST_SIDE}, degraded) "
          f"in {time.time() - t0:.1f}s", flush=True)
    return ts_dir


# Phase 6b: the plain Python codecs stand in for the native ones while
# `_plain_codecs` is active (the DHT tables as `_huff_lut`'s tuples).
CODEC_FRAMES = 2


class _plain_codecs:
    def __enter__(self):
        from mhmocap_tpu_torch import io as TIO, native
        self.saved = TIO._scan, native.png_unfilter

        def scan(segments, comps, frame, tables, restart_interval):
            luts = [{th: (tuple(t[0].tolist()), tuple(t[1].tolist()))
                     for (tc, th), t in tables.items() if tc == k}
                    for k in (0, 1)]
            TIO._decode_scan(segments, comps, frame, *luts, restart_interval)
        TIO._scan, native.png_unfilter = scan, TIO._png_unfilter
        return self

    def __exit__(self, *exc):
        from mhmocap_tpu_torch import io as TIO, native
        TIO._scan, native.png_unfilter = self.saved


def _timed_parse(data):
    """io._parse_jpeg(data) with the codecs in place, its scans' entropy
    decode timed apart: (frame, s, entropy decode s)."""
    from mhmocap_tpu_torch import io as TIO
    scan, secs = TIO._scan, [0.0]

    def timed(*args):
        t = time.perf_counter()
        scan(*args)
        secs[0] += time.perf_counter() - t
    TIO._scan = timed
    try:
        t0 = time.perf_counter()
        frame = TIO._parse_jpeg(data)
        return frame, time.perf_counter() - t0, secs[0]
    finally:
        TIO._scan = scan


def phase_codecs(ts_dir):
    """The host codecs against their plain versions on phase 7's tree,
    and load_images on the thread map and on 1 worker."""
    import glob
    from mhmocap_tpu_torch import io as TIO
    from mhmocap_tpu_torch.data.ingestion import load_images
    paths = sorted(glob.glob(os.path.join(ts_dir, "images", "*.jpg")))
    fails = []
    for p in paths[:CODEC_FRAMES]:
        with open(p, "rb") as f:
            data = f.read()
        nat, t_nat, s_nat = _timed_parse(data)
        with _plain_codecs():
            ref, t_ref, s_ref = _timed_parse(data)
        same = all(a.coefs.dtype == b.coefs.dtype
                   and np.array_equal(a.coefs, b.coefs)
                   for a, b in zip(nat.components, ref.components))
        pix = [TIO._reconstruct([fr], "cuda") for fr in (nat, ref)]
        same_pix = torch.equal(*pix)
        print(f"[6b codecs] {os.path.basename(p)} ({len(data)} bytes, "
              f"{nat.height}x{nat.width}): coefficients "
              f"{'bit-identical' if same else 'DIFFER'}, pixels "
              f"{'bit-identical' if same_pix else 'DIFFER'}; native parse "
              f"{1e3 * t_nat:.1f} ms (entropy decode {1e3 * s_nat:.1f} ms, "
              f"the rest in Python, which holds the GIL: marker walk, "
              f"unstuffing, headers, coefficient arrays "
              f"{1e3 * (t_nat - s_nat):.1f} ms); plain Python parse "
              f"{t_ref:.3f} s (entropy decode {1e3 * s_ref:.1f} ms)",
              flush=True)
        if not (same and same_pix):
            fails.append(f"{p}: native and plain JPEG decode differ")
    for sub in ("DPT_large_monodepth", "Mask2Former_Instances"):
        p = sorted(glob.glob(os.path.join(ts_dir, sub, "*.png")))[0]
        t0 = time.perf_counter()
        nat = TIO.read_png(p)
        t_nat = time.perf_counter() - t0
        with _plain_codecs():
            ref = TIO.read_png(p)
        same = nat.dtype == ref.dtype and np.array_equal(nat, ref)
        print(f"[6b codecs] {sub}/{os.path.basename(p)} {nat.dtype} "
              f"{nat.shape}: native and plain PNG "
              f"{'bit-identical' if same else 'DIFFER'}; native read "
              f"{1e3 * t_nat:.1f} ms", flush=True)
        if not same:
            fails.append(f"{p}: native and plain PNG read differ")
    # the pool, 1 worker, the pool
    outs, pool = {}, TIO.HOST_WORKERS
    for workers in (pool, 1, pool):
        saved, TIO.HOST_WORKERS = TIO.HOST_WORKERS, workers
        try:
            t0 = time.perf_counter()
            TIO._host_map(TIO._read_jpeg_file, paths)
            t_host = time.perf_counter() - t0
            t0 = time.perf_counter()
            outs[workers] = load_images(paths, 0.125, device="cuda")
            t_load = time.perf_counter() - t0
        finally:
            TIO.HOST_WORKERS = saved
        print(f"[6b codecs] workers={workers}: host parse and entropy "
              f"decode {1e3 * t_host / len(paths):.1f} ms per frame; "
              f"load_images {1e3 * t_load / len(paths):.1f} ms per frame "
              f"({t_load:.3f} s for {len(paths)} frames at {ROBUST_SIDE}x"
              f"{ROBUST_SIDE} -> {outs[workers].shape[1:3]})", flush=True)
    if not np.array_equal(outs[1], outs[pool]):
        fails.append("load_images differs between the thread map and 1 "
                     "worker")
    if fails:
        raise AssertionError("codecs: " + "; ".join(fails))


def phase_shipped_config(tmp):
    """configs/predict_mupots_robust.yml, unedited, on the degraded tree
    write_robust_tree wrote under tmp."""
    import pickle
    from mhmocap_tpu_torch import eval_mupots, predict_mupots
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    _reset_counts()
    t0 = time.time()
    with CycleClock() as clock:
        summary = predict_mupots.main(
            ["--configs_yml", ROBUST_CONFIG, "--ts_id", str(ROBUST_TS),
             "--input_path", data, "--output_path", out,
             "--device", "cuda"])
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _raster_counts("7 robust")
    fill = _fillin_counts("7 robust")
    cfg = summary["engine_config"]
    _check_raster_calls(cfg, "7 robust")
    cyc = clock.seconds()[29:]       # cycles [30, 250)
    ing = summary["ingest_seconds"]
    exp = summary["export_seconds"]
    print(f"[7 robust] T={cfg.num_frames} at {cfg.image_size}, chunk "
          f"{cfg.chunk}, windows {cfg.person_windows}, gap_aware_temporal "
          f"{cfg.gap_aware_temporal}; raster launches {launches}; "
          f"ingestion {ing['total']:.3f}s (decode {ing['decode']:.3f}, "
          f"post-process {ing['postprocess']:.3f}, assignment "
          f"{ing['assignment']:.3f}); init solve "
          f"{summary['init_seconds']:.3f}s; per-cycle median "
          f"{np.median(cyc):.4f}s over cycles [30, {ROBUST_CYCLES}) (min "
          f"{cyc.min():.4f}, max {cyc.max():.4f}), {clock.report(30)}; "
          f"exports: init "
          f"{exp['init']:.3f}s, stage-1 {exp['stage1']:.3f}s; "
          f"predict_mupots {wall:.1f}s", flush=True)
    if not cfg.gap_aware_temporal or cfg.image_size != (256, 256):
        raise AssertionError(f"the robust config did not run as shipped: "
                             f"{cfg}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a raster kernel never launched: {launches}")
    ts_dir = os.path.join(out, f"TS{ROBUST_TS}")
    st1 = _load_pickles(ts_dir, ENTRY_SCHEMA)["optvar_stage1.pkl"]
    gap = np.asarray([row["reg_gap_accel"] for row in summary["stage1_log"]])
    print(f"[7 robust] stale person-frames {int(st1['lagged_tn'].sum())}; "
          f"reg_gap_accel cycle 0 {gap[0]:.6g}, last {gap[-1]:.6g}",
          flush=True)
    if not st1["lagged_tn"].any():
        raise AssertionError("the degraded tree has no stale frame")
    if len(gap) != ROBUST_CYCLES or not gap.max() > 0:
        raise AssertionError(f"reg_gap_accel never live: {gap.max()}")
    names = set(os.listdir(ts_dir))
    n_vis = {d: len(os.listdir(os.path.join(ts_dir, d)))
             for d in ("vis_init", "vis_stage1")}
    if not VIS_FILES <= names or n_vis != {
            "vis_init": min(ROBUST_FRAMES, 25),
            "vis_stage1": min(ROBUST_FRAMES, 20)}:
        raise AssertionError(f"visualization files: {sorted(names)}, "
                             f"{n_vis}")
    with open(os.path.join(ts_dir, "visualization_data_stage1.pkl"),
              "rb") as f:
        vis = pickle.load(f)
    if set(vis) != VIS_KEYS or vis["verts"].shape[:2] != (
            ROBUST_FRAMES, ROBUST_PEOPLE) or not np.isfinite(
                vis["verts"]).all():
        raise AssertionError(f"visualization pickle: {sorted(vis)}")
    final = eval_mupots.main(["--configs_yml", ROBUST_CONFIG,
                              "--input_path", out, "--device", "cuda"])
    print("[7 robust] FinalResults averages: " + json.dumps(
        {k: v[-1] for k, v in final.items()}), flush=True)
    if not all(np.isfinite(v).all() for v in final.values()):
        raise AssertionError(f"non-finite metrics: {final}")
    return launches, fill


def phase_checkpoint(tmp):
    """A tiny sequence: 4 cycles unbroken (profiler trace of cycle 2,
    captured with phase marks, whose ring row of cycle 2 must be filled)
    against 2 + 2 cycles resumed from a checkpoint, before cycle 30
    (the aux state, which is not saved, is still its initial value)."""
    import contextlib
    import io
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.workload import bench_args, make_ts1_like_seq
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    seq, _ = make_ts1_like_seq(T=8, N=2, side=128, model=model)

    def run(name, num_iter, **extra):
        args = bench_args(num_iter, None, 64)
        for k, v in extra.items():
            setattr(args, k, v)
        pred = Predictor(seq, model, os.path.join(tmp, name), args,
                         device="cuda")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            pred.run(verbose=False)
        return pred, printed.getvalue()

    trace_dir = os.path.join(tmp, "trace")
    whole, _ = run("whole", 4, profile_dir=trace_dir)
    run("split", 2, checkpoint_every=1)
    resumed, printed = run("split", 4, checkpoint_every=1)
    ref, got = (_load_pickles(os.path.join(tmp, d))["optvar_stage1.pkl"]
                for d in ("whole", "split"))
    differ = [k for k, v in ref.items() if isinstance(v, np.ndarray)
              and not np.array_equal(got[k], v)]
    same_losses = np.array_equal(resumed.stage1_losses,
                                 whole.stage1_losses[2:])
    trace = os.path.join(trace_dir, "trace_cycle2.json")
    size = os.path.getsize(trace) if os.path.exists(trace) else 0
    phases = os.path.join(trace_dir, "phases_cycle2.json")
    ring = []
    if os.path.exists(phases):
        with open(phases) as f:
            ring = json.load(f)["ring_ns"]
    print(f"[8 checkpoint] {printed.strip()}; resumed vs unbroken: arrays "
          f"that differ {differ}, losses of cycles 2-3 equal {same_losses}; "
          f"trace {trace} {size} bytes; cycle 2's phase marks (device ns "
          f"from its start) {[t - ring[0] for t in ring]}", flush=True)
    if "resumed from checkpoint at cycle 1" not in printed:
        raise AssertionError("the 4-cycle run did not resume at cycle 1")
    if differ or not same_losses:
        raise AssertionError("the resumed run is not bit-identical to the "
                             "unbroken one")
    if not size:
        raise AssertionError("profile_dir wrote no trace")
    if not ring or ring[0] <= 0 or any(b < a for a, b in zip(ring, ring[1:])):
        raise AssertionError(f"profile_dir's phase marks are not one filled, "
                             f"non-decreasing row: {ring}")


class RasterClock:
    """Records the (bodies, window) shape and CUDA events around each
    `rasterize_bodies` call while active, with no host synchronization."""

    def __init__(self):
        from mhmocap_tpu_torch.ops import rasterizer
        self.mod, self.fn, self.calls, self.events = (
            rasterizer, rasterizer.rasterize_bodies, set(), [])

    def __enter__(self):
        def timed(verts, faces, cam_K, settings):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(verts, faces, cam_K, settings)
            b.record()
            self.events.append((a, b))
            self.calls.add((verts.shape[0], settings.window))
            return out
        self.mod.rasterize_bodies = timed
        return self

    def __exit__(self, *exc):
        self.mod.rasterize_bodies = self.fn

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


# The CPU's plain raster of a full-size body at window 256 takes 24-30 s
# on the card's host, so the check against the CPU covers the first 2
# frames, rastered one frame a call on the CPU (the result does not
# depend on the frames a call: tests/test_torch_fhsog.py).
FHSOG_BINS, FHSOG_CPU_FRAMES = 128, 2
FHSOG_RTOL, FHSOG_ATOL = 1e-4, 1e-6
CARVE_STRIDE, CARVE_MAX_DIFF = 997, 1e-3


def _vis_config(tmp, mode):
    """The robust config with the viewer's ARGS: `mode`, both captures."""
    from mhmocap_tpu_torch.config import dump_yaml, load_yaml
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ROBUST_CONFIG)) as f:
        cfg = load_yaml(f.read())
    cfg["ARGS"] = dict(cfg.get("ARGS") or {}, viz_mode=mode,
                       capture_rendered_color=True,
                       capture_rendered_depth=True)
    path = os.path.join(tmp, f"vis_{mode}.yml")
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path


def _close(got, ref, what, fails):
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    excess = float(((got - ref).abs()
                    - (FHSOG_ATOL + FHSOG_RTOL * ref.abs())).max())
    print(f"[9 fhsog] card vs CPU {what}: max |err| "
          f"{float((got - ref).abs().max()):.3g}, excess over atol "
          f"{FHSOG_ATOL:g} + rtol {FHSOG_RTOL:g} |CPU| {excess:.3g}",
          flush=True)
    if excess > 0:
        fails.append(what)


def phase_visualization_fhsog(tmp, robust_dir):
    """Phase 9: the visualization entry point and the FHSOG build on
    phase 7's stage-1 output."""
    import pickle
    import shutil
    from mhmocap_tpu_torch import visualization
    from mhmocap_tpu_torch.engine import fhsog
    from mhmocap_tpu_torch.io import read_png
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    with open(os.path.join(robust_dir, "optvar_stage1.pkl"), "rb") as f:
        optvar = pickle.load(f)
    with open(os.path.join(robust_dir, "visualization_data_stage1.pkl"),
              "rb") as f:
        vis = pickle.load(f)
    T, N = vis["verts"].shape[:2]
    H, W = vis["depths"].shape[1:]
    near_z = float(np.min(optvar["min_z"]))
    far_z = float(np.max(optvar["max_z"]))

    # (a) scene view, (b) skeleton view
    secs, viz_dirs = {}, {}
    for mode in ("scene", "skeleton"):
        t0 = time.time()
        out_dir = visualization.main(
            ["--configs_yml", _vis_config(tmp, mode), "--input_path",
             robust_dir, "--device", "cuda"])
        secs[mode] = time.time() - t0
        viz_dirs[mode] = out_dir + "_" + mode
        shutil.move(out_dir, viz_dirs[mode])
    names = set(os.listdir(viz_dirs["scene"]))
    frames = min(T, 10)
    want = ({"scene.ply", "camera_view_0000.png"}
            | {f"human_{t:04d}_{n}.ply" for t in range(frames)
               for n in range(N)}
            | {f"{k}_{t:06d}.png" for k in ("img", "depth")
               for t in range(frames)})
    depth = np.stack([read_png(os.path.join(viz_dirs["scene"],
                                            f"depth_{t:06d}.png"))
                      for t in range(frames)]).astype(np.float64) / 1e3
    hit = depth[depth > 0]
    with open(os.path.join(viz_dirs["scene"], "scene.ply")) as f:
        n_scene = int(f.read(200).split("element vertex ")[1].split()[0])
    print(f"[9 vis] scene view: {len(names)} files ({n_scene} scene points,"
          f" {N * frames} body meshes) in {secs['scene']:.2f}s; depth "
          f"captures {depth.shape}, {hit.size} nonzero in "
          f"[{hit.min():.3f}, {hit.max():.3f}] m, fit z range "
          f"[{near_z:.3f}, {far_z:.3f}] m", flush=True)
    if not want <= names:
        raise AssertionError(f"scene view files missing: "
                             f"{sorted(want - names)}")
    if not (hit.size and np.isfinite(hit).all() and hit.min()
            >= near_z - 1e-3 and hit.max() <= far_z):
        raise AssertionError("depth captures outside the fit's z range")
    sk_names = set(os.listdir(viz_dirs["skeleton"]))
    sk_want = ({f"skeleton_{t:04d}.ply" for t in range(frames)}
               | {f"img_{t:06d}.png" for t in range(frames)})
    print(f"[9 vis] skeleton view: {len(sk_names)} files in "
          f"{secs['skeleton']:.2f}s", flush=True)
    if not sk_want <= sk_names:
        raise AssertionError(f"skeleton view files missing: "
                             f"{sorted(sk_want - sk_names)}")

    # (c) FHSOG on the stage-1 data, then the carve
    model = make_synthetic_smpl()
    dev = torch.device("cuda")

    def inputs(device, frames=T):
        return ([torch.as_tensor(np.asarray(vis[k][:frames], np.float32),
                                 device=device)
                 for k in ("depths", "images", "backmasks", "verts")]
                + [model.faces.to(device),
                   torch.as_tensor(np.asarray(vis["cam"]["K"], np.float32),
                                   device=device)])

    def build(args):
        return fhsog.build_fhsog_from_smpl(*args, near_z, far_z,
                                           num_depth_bins=FHSOG_BINS)

    args = inputs(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with RasterClock() as clock:
        out = build(args)
        torch.cuda.synchronize()
    build_s = time.time() - t0
    launches = _raster_counts("9 fhsog")
    raster_s = clock.seconds()
    print(f"[9 fhsog] T={T} N={N} {H}x{W}, {FHSOG_BINS} bins, z "
          f"[{near_z:.3f}, {far_z:.3f}]: build {build_s:.3f}s, raster "
          f"{raster_s:.3f}s ({raster_s / build_s:.3f} of it) in "
          f"{len(clock.events)} calls; launches {launches}; fog mass "
          f"{float(out[0].sum()):.4g}, body pixels "
          f"{int(out[3].sum())}", flush=True)
    _check_raster_calls(None, "9 fhsog", clock.calls)
    if launches["fwd"] != len(clock.events) or launches["bwd"]:
        raise AssertionError(f"FHSOG raster launches {launches} for "
                             f"{len(clock.events)} calls")
    if not (out[3].any() and float(out[0].sum()) > 0
            and all(bool(torch.isfinite(x).all()) for x in out)):
        raise AssertionError("FHSOG output is empty or not finite")

    fails = []
    k = FHSOG_CPU_FRAMES
    per_call = fhsog.FRAMES_PER_CALL
    t0 = time.time()
    try:
        fhsog.FRAMES_PER_CALL = 1
        ref = build(inputs("cpu", k))
    finally:
        fhsog.FRAMES_PER_CALL = per_call
    cpu_s = time.time() - t0
    got = build(inputs(dev, k))
    same = torch.equal(got[3].cpu(), ref[3])
    print(f"[9 fhsog] first {k} frames, card vs CPU (plain raster, one "
          f"frame a call, {cpu_s:.1f}s): smpl_masks equal {same}",
          flush=True)
    if not same:
        fails.append("smpl_masks")
    for i, what in ((0, "fhsog_alpha"), (4, "gdfs"), (1, "texture")):
        _close(got[i], ref[i], what, fails)

    fog = out[0] > 0
    verts0 = args[3][0]
    t0 = time.time()
    carved = fhsog.carve_fog_with_meshes(fog, verts0, args[4], near_z,
                                         far_z, args[5])
    torch.cuda.synchronize()
    carve_s = time.time() - t0
    pts = fhsog.fog_voxel_points(fog.shape, near_z, far_z,
                                 args[5].cpu())
    idx = torch.arange(0, pts.shape[0], CARVE_STRIDE)
    solid = fog.permute(1, 2, 0).reshape(-1)[idx.to(dev)].cpu()
    inside = torch.zeros(idx.shape[0], dtype=torch.bool)
    for b in range(verts0.shape[0]):
        inside |= fhsog.points_inside_mesh(verts0[b].cpu(), args[4].cpu(),
                                           pts[idx])
    got_c = carved.permute(1, 2, 0).reshape(-1)[idx.to(dev)].cpu()
    diff = float((got_c != (solid & inside)).float().mean())
    print(f"[9 fhsog] carve {tuple(fog.shape)} voxels, {int(fog.sum())} "
          f"solid, {int(carved.sum())} carved by frame 0's {N} bodies in "
          f"{carve_s:.3f}s; card vs CPU on every {CARVE_STRIDE}th voxel "
          f"({idx.numel()}, {int((solid & inside).sum())} carved): "
          f"differ {diff:.3g} (bound {CARVE_MAX_DIFF:g})", flush=True)
    if diff > CARVE_MAX_DIFF:
        fails.append(f"carve differs on {diff}")
    if fails:
        raise AssertionError("FHSOG card vs CPU: " + "; ".join(fails))
    return launches


# Phase 10: bench-ts1 with its frames sharded over 2 ranks on the one
# card. NCCL refuses two ranks on one GPU, so the ranks exchange over
# gloo with CUDA tensors (all_gather only); each rank builds nothing (the
# parent built the kernels in phase 2) and runs both kernels on its own
# chunks. A correctness run: two ranks on one card measure no speed-up.
SHARD_SPEC = {"T": 201, "N": 3, "side": 256, "V": None, "window": 160,
              "ranks": 2}
SHARD_CYCLES = (30, 31, 50)      # scene rebuilds at all; filters at 30, 50
SHARD_TIMEOUT = 600.0
# against the single process on the same layout: loss and parts
# relative, gradients relative norm, params after the cycles absolute.
# The sharded cycle adds the chunks' shared terms in the single process's
# order, so on the CPU the two agree bit for bit (tests/test_torch_spmd.py);
# the phase prints whether they do on the card.
SHARD_BOUNDS = {"loss": 1e-5, "grad": 1e-4, "params": 5e-3}


def _shard_case(spec, device):
    """(seq, model, cfg, coefs) of the sharded workload: the Predictor's
    windows and coefficients with the time layout of spec["ranks"]."""
    import dataclasses
    from mhmocap_tpu_torch.engine.predictor import (Predictor,
                                                    tune_time_layout)
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.workload import bench_args, make_ts1_like_seq
    model = (None if spec["V"] is None
             else make_synthetic_smpl(num_vertices=spec["V"], seed=1))
    seq, model = make_ts1_like_seq(T=spec["T"], N=spec["N"],
                                   side=spec["side"], model=model)
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, spec["window"]),
                         device=device)
    chunk, bucket = tune_time_layout(spec["T"], spec["ranks"])
    cfg = dataclasses.replace(pred.cfg, chunk=chunk, frame_bucket=bucket)
    return seq, pred.model, cfg, pred.coefs


def _shard_run(spec, params_np, cycles, device, mesh=None):
    """The first cycle's loss and gradient (after its refreshes), then
    the fused cycles, each timed between synchronizations (and barriers)
    with the raster launches counted from 0: sharded over `mesh`, or in
    this process without one."""
    from mhmocap_tpu_torch import convert
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    from mhmocap_tpu_torch.parallel import spmd as S
    dev = torch.device(device)
    seq, model, cfg, coefs = _shard_case(spec, dev)
    params = convert.params_from_numpy(params_np, dev)
    data = E.prepare_seq_data(seq, cfg, dev)
    aux = E.init_aux(cfg, model.num_vertices, torch.as_tensor(
        np.mean(seq.betas_smpl, axis=0, keepdims=True), device=dev))
    state = E.rmsprop_init(params)
    if mesh is not None:
        data, aux = S.shard_data(data, mesh), S.shard_aux(aux, mesh)
        state = S.shard_opt_state(state, mesh)
        params = S.shard_params(params, mesh)
        held = {"local data": _nbytes(*data.local),
                "full-T scene inputs": _nbytes(*data.scene[:3]),
                "params + RMSprop": 3 * _nbytes(*params),
                "filtered targets": _nbytes(aux.verts_filt_diff)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if mesh is not None:
            mesh.barrier()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if mesh is None:
        aux0 = E.fused_aux_refresh(params, aux, cycles[0], model, data, cfg)
        loss, parts, grads = E.cycle_loss_and_grads(params, model, data,
                                                    aux0, coefs, cfg)
    else:
        aux0 = S.spmd_fused_aux_refresh(params, aux, cycles[0], model, data,
                                        cfg, mesh)
        loss, parts, grads = S.spmd_cycle_loss_and_grads(
            params, model, data, aux0, coefs, cfg, mesh)
        grads = S.gather_params(grads, mesh)
    out = {"loss0": float(loss), "parts0": parts.cpu().numpy(),
           "grads0": [g.cpu().numpy() for g in grads], "seconds": [],
           "launches": [], "fillin": [], "losses": [],
           "calls": sorted(_raster_calls(cfg)),
           "local_chunks": cfg.padded_frames // (spec["ranks"] * cfg.chunk),
           "cfg": (cfg.chunk, cfg.padded_frames, cfg.person_windows)}
    del aux0, grads
    for c in cycles:
        sync()
        _reset_counts()
        t0 = time.time()
        if mesh is None:
            params, state, aux, loss, _ = E.stage1_cycle_eager(
                params, state, aux, c, model, data, coefs, cfg)
        else:
            params, state, aux, loss, _ = S.spmd_stage1_cycle_fused(
                params, state, aux, c, model, data, coefs, cfg, mesh)
        sync()
        out["seconds"].append(time.time() - t0)
        out["launches"].append(_raster_counts("10 sharded"))
        out["fillin"].append(dict(FC.launches))
        out["losses"].append(float(loss))
    if mesh is not None:
        out["replicated"] = [params.betas.cpu().numpy(),
                             params.xscale.cpu().numpy()]
        out["held"] = held
        params = S.gather_params(params, mesh)
    out["params"] = [x.cpu().numpy() for x in params]
    out["peak"] = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    return out


def _shard_rank(mesh, payload):
    """A rank of phase 10 (started by parallel.ranks.run_ranks)."""
    return _shard_run(payload["spec"], payload["params"], payload["cycles"],
                      mesh.device, mesh)


def phase_sharded(spec=SHARD_SPEC, device="cuda", rank_device="cuda:0"):
    """Phase 10: `spmd_stage1_cycle_fused` on spec["ranks"] gloo ranks
    against `stage1_cycle_eager` in this process, on the same layout,
    from the same init params."""
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.parallel.ranks import run_ranks
    seq, model, cfg, _ = _shard_case(spec, device)
    D = spec["ranks"]
    print(f"[10 sharded] T={cfg.num_frames} padded {cfg.padded_frames}, "
          f"chunk {cfg.chunk} x {cfg.padded_frames // (D * cfg.chunk)} a "
          f"rank on {D} gloo ranks on {rank_device}, windows "
          f"{cfg.person_windows}, cycles {SHARD_CYCLES}", flush=True)
    _check_raster_calls(cfg, "10 sharded")
    params, _, _ = E.init_params(model, seq.pose2d, seq.poses_smpl,
                                 seq.betas_smpl, seq.cam["K"], cfg)
    params_np = [x.cpu().numpy() for x in params]
    del seq, model, params
    t0 = time.time()
    ranks = run_ranks("chip_smoke:_shard_rank", D,
                      {"spec": spec, "params": params_np,
                       "cycles": SHARD_CYCLES}, device=rank_device,
                      backend="gloo", timeout=SHARD_TIMEOUT,
                      path=[os.path.dirname(os.path.abspath(__file__))])
    ranks_s = time.time() - t0
    single = _shard_run(spec, params_np, SHARD_CYCLES, device)

    fails = []
    want = {k: (len(cfg.window_groups) * ranks[0]["local_chunks"]
                if torch.device(device).type == "cuda" else 0)
            for k in COUNTED}
    names = ("poses_T", "poses_smpl", "betas", "zmin_lin", "zmax_lin",
             "xscale")
    for r, got in enumerate(ranks):
        rel = abs(got["loss0"] - single["loss0"]) / abs(single["loss0"])
        prel = float(np.max(np.abs(got["parts0"] - single["parts0"])
                            / np.maximum(np.abs(single["parts0"]), 1e-30)))
        grel = {k: float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                      1e-30))
                for k, a, b in zip(names, got["grads0"], single["grads0"])}
        perr = {k: float(np.abs(a - b).max())
                for k, a, b in zip(names, got["params"], single["params"])}
        same = (got["losses"] == single["losses"] and all(
            np.array_equal(a, b) for a, b in zip(got["params"],
                                                 single["params"])))
        print(f"[10 sharded] rank {r} vs one process, cycle "
              f"{SHARD_CYCLES[0]}: loss rel err {rel:.3g}, parts max rel "
              f"err {prel:.3g} (bound {SHARD_BOUNDS['loss']:g}); gradient "
              f"rel norm err " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in grel.items())
              + f" (bound {SHARD_BOUNDS['grad']:g}); params after "
              f"{len(SHARD_CYCLES)} cycles max err " + ", ".join(
                  f"{k} {v:.3g}" for k, v in perr.items())
              + f" (bound {SHARD_BOUNDS['params']:g}); losses "
              f"{got['losses']} vs {single['losses']}; bit-identical "
              f"{same}; raster launches per "
              f"cycle {got['launches']} (want {want}); layout "
              f"{got['cfg']}; held {got['held']} bytes, peak "
              f"{got['peak'] / 2**30:.2f} GiB", flush=True)
        if not (rel <= SHARD_BOUNDS["loss"] and prel <= SHARD_BOUNDS["loss"]):
            fails.append(f"rank {r} loss/parts {rel}, {prel}")
        fails += [f"rank {r} gradient {k}: {v}" for k, v in grel.items()
                  if not v <= SHARD_BOUNDS["grad"]]
        fails += [f"rank {r} params {k}: {v}" for k, v in perr.items()
                  if not v <= SHARD_BOUNDS["params"]]
        if any(n != want for n in got["launches"]):
            fails.append(f"rank {r} raster launches {got['launches']}")
        # every rank rebuilds the whole scene, as the one process does,
        # and its fill-in stops at the same round
        print(f"[10 sharded] rank {r} fill-in counts per cycle "
              f"{got['fillin']} (one process {single['fillin']})",
              flush=True)
        if got["fillin"] != single["fillin"] or not all(
                n["calls"] for n in got["fillin"]):
            fails.append(f"rank {r} fill-in counts {got['fillin']}")
        if got["calls"] != single["calls"] or got["cfg"] != single["cfg"]:
            fails.append(f"rank {r} layout {got['cfg']} {got['calls']}")
        for a, b in zip(got["replicated"], ranks[0]["replicated"]):
            if not np.array_equal(a, b):
                fails.append(f"rank {r} betas/xscale differ from rank 0's")
    per_rank = np.max([g["seconds"] for g in ranks], axis=0)
    print(f"[10 sharded] seconds a cycle at {SHARD_CYCLES}: {D} ranks "
          f"{np.round(per_rank, 4).tolist()}, one process "
          f"{np.round(single['seconds'], 4).tolist()} (a correctness run: "
          f"{D} ranks share one card, so this is no scaling measurement); "
          f"ranks' command {ranks_s:.1f}s", flush=True)
    if torch.device(device).type == "cuda":
        print(f"[10 sharded] nvidia-smi: {smi_line()}", flush=True)
    if fails:
        raise AssertionError("sharded vs one process: " + "; ".join(fails))
    return ({k: sum(n[k] for g in ranks for n in g["launches"])
             for k in COUNTED},
            {k: sum(n[k] for g in ranks for n in g["fillin"])
             for k in ranks[0]["fillin"][0]})


# Phase 11: bench-ts1 eagerly and through the graphs from one init, over
# cycles 0-52, which run every variant: no refresh (0-29), the scene
# rebuild (30-49), both refreshes (50), the rebuild with filters (51-52).
GRAPH_CYCLES = 53
GRAPH_TIMED = (30, 52)
GRAPH_BENCH = {"Ks": (5, 15), "meas": 15, "reps": 1}


def _run_cycles(step, n):
    """(seconds, raster launches, fill-in counts, window-loss launches)
    of cycles 0..n-1, each run by step(c) between synchronizations with
    the counts from 0."""
    from mhmocap_tpu_torch.ops import fillin_cuda as FC
    from mhmocap_tpu_torch.ops import window_loss as WL
    secs, launches, fill, wl = [], [], [], []
    for c in range(n):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        step(c)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(_raster_counts("11 graphs"))
        fill.append(dict(FC.launches))
        wl.append(dict(WL.launches))
    return np.asarray(secs), launches, fill, wl


def _span(secs):
    a, b = GRAPH_TIMED
    w = secs[a:b]
    return (f"median {np.median(w):.4f}s (min {w.min():.4f}, max "
            f"{w.max():.4f}) over [{a}, {b}), cycle 50 {secs[50]:.4f}s")


def phase_graphs():
    """Phase 11: the fused cycle and the init solve as CUDA graphs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mhmocap_tpu_torch import bench_multicycle
    from mhmocap_tpu_torch.engine import cycle_graph as CG
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.workload import (WINDOW, bench_args,
                                            make_ts1_like_seq)
    dev = torch.device("cuda")
    seq, model = make_ts1_like_seq()
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, bench_args(1, None, WINDOW),
                         device=dev)
    cfg, m, coefs = pred.cfg, pred.model, pred.coefs
    per_cycle = len(cfg.window_groups) * cfg.num_chunks
    fails = []

    # the init solve: one captured Adam step, replayed for the other 99,
    # against the eager loop
    args = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (seq.pose2d, seq.poses_smpl, seq.betas_smpl,
                      seq.cam["K"])]
    args.append(torch.zeros((1, cfg.num_people, 1, 1), device=dev))
    kw = dict(dist_coef=E._dist_coef(cfg, dev),
              pose_weights=E._j17_weights(cfg, dev))
    secs = {}
    for name, fn in (("eager", E.init_global_poses),
                     ("graph", CG.init_global_poses_fused)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        secs[name] = [x.clone() for x in fn(m, *args, **kw)]
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    same = all(torch.equal(a, b) for a, b in zip(secs["eager"][:2],
                                                 secs["graph"][:2]))
    print(f"[11 graphs] init solve (100 Adam steps, T={cfg.num_frames}, "
          f"N={cfg.num_people}): eager loop {secs['eager'][2]:.3f}s, graph "
          f"(step 0 eager as the warm-up, its capture, 99 replays) "
          f"{secs['graph'][2]:.3f}s; "
          f"poses_T and history bit-identical {same}", flush=True)
    if not same:
        fails.append("init solve graph differs from the eager loop")

    params, _, opt_scale = E.init_params(m, seq.pose2d, seq.poses_smpl,
                                         seq.betas_smpl, seq.cam["K"], cfg)
    data = E.prepare_seq_data(seq, cfg, dev)
    aux0 = E.init_aux(cfg, m.num_vertices, torch.as_tensor(
        np.mean(seq.betas_smpl, axis=0, keepdims=True), device=dev))

    def eager_run():
        state = {"s": (params, E.rmsprop_init(params), aux0)}
        losses, parts = [], []

        def step(c):
            p, st, aux, loss, part = E.stage1_cycle_eager(
                *state["s"], c, m, data, coefs, cfg, opt_scale)
            state["s"] = (p, st, aux)
            losses.append(loss)
            parts.append(part)

        torch.cuda.reset_peak_memory_stats()
        secs, launches, fill, wl = _run_cycles(step, GRAPH_CYCLES)
        p, st, _ = state["s"]
        return dict(secs=secs, launches=launches, fill=fill, wl=wl,
                    losses=torch.stack(losses),
                    parts=torch.stack(parts), state=(p, st.nu, st.trace),
                    count=int(st.count),
                    peak=torch.cuda.max_memory_allocated())

    eager = eager_run()
    graph = CG.CycleGraph(params, E.rmsprop_init(params), aux0, m, data,
                          coefs, cfg, opt_scale, num_cycles=GRAPH_CYCLES)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.prepare(0, GRAPH_CYCLES)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    variants = []
    g_secs, g_launches, g_fill, g_wl = _run_cycles(
        lambda c: variants.append(graph.replay(c)), GRAPH_CYCLES)
    g_peak = torch.cuda.max_memory_allocated()
    st = graph.state
    diff = [c for c in range(GRAPH_CYCLES)
            if not (torch.equal(st.losses[c], eager["losses"][c])
                    and torch.equal(st.parts[c], eager["parts"][c]))]
    state_same = all(torch.equal(a, b) for a, b in zip(
        CG.tree_leaves((st.params, st.nu, st.trace)),
        CG.tree_leaves(eager["state"])))
    print(f"[11 graphs] cycles 0-{GRAPH_CYCLES - 1}, {len(graph.graphs)} "
          f"variants {[tuple(int(x) for x in v) for v in graph.graphs]} "
          f"(do_scene, do_filt, have_scene, have_filters): graph vs eager "
          f"cycles whose loss or parts differ {diff}; final params and "
          f"RMSprop state bit-identical {state_same}, step count "
          f"{int(st.count)} / {eager['count']}", flush=True)
    if diff or not state_same or int(st.count) != eager["count"]:
        again = eager_run()
        self_same = (torch.equal(again["losses"], eager["losses"])
                     and all(torch.equal(a, b) for a, b in zip(
                         CG.tree_leaves(again["state"]),
                         CG.tree_leaves(eager["state"]))))
        print(f"[11 graphs] eager rerun bit-identical to the first eager "
              f"run: {self_same}; loss rel diff graph vs eager per cycle "
              f"{((st.losses - eager['losses']).abs() / eager['losses'].abs()).tolist()}",
              flush=True)
        fails.append("graph cycles differ from the eager cycles")

    want = dict.fromkeys(COUNTED, per_cycle)
    bad = [(c, n_e, n_g) for c, (n_e, n_g) in enumerate(
        zip(eager["launches"], g_launches)) if n_e != want or n_g != want]
    print(f"[11 graphs] raster launches a cycle, counted by the kernels: "
          f"eager {eager['launches'][-1]}, graph {g_launches[-1]} (want "
          f"{want}); cycles off {bad}", flush=True)
    if bad:
        fails.append(f"raster launches {bad}")
    # the window-loss pair: two launches each way a chunk, in the graphs
    # as in the eager loop
    want_wl = dict.fromkeys(("fwd", "bwd"), 2 * cfg.num_chunks)
    bad = [(c, n_e, n_g) for c, (n_e, n_g) in enumerate(
        zip(eager["wl"], g_wl)) if n_e != want_wl or n_g != want_wl]
    print(f"[11 graphs] window-loss launches a cycle, counted by the "
          f"kernels: eager {eager['wl'][-1]}, graph {g_wl[-1]} (want "
          f"{want_wl}); cycles off {bad}", flush=True)
    if bad:
        fails.append(f"window-loss launches {bad}")
    for k in want_wl:
        WINDOW_LOSS_COUNTED[k] += sum(n[k] for n in eager["wl"] + g_wl)
    # the fill-in of every scene rebuild (cycles 30-52) stops at the same
    # round in the graphs as in the eager loop, and runs nowhere else
    scene = [c for c, n in enumerate(g_fill) if n["calls"]]
    print(f"[11 graphs] fill-in counts a cycle, counted by the kernel: "
          f"eager {eager['fill'][-1]}, graph {g_fill[-1]}; cycles with a "
          f"call {scene[0] if scene else None}..{scene[-1] if scene else None}"
          f"; live rounds a call "
          f"{sorted({n['live'] // max(n['calls'], 1) for n in g_fill if n['calls']})}",
          flush=True)
    if g_fill != eager["fill"] or scene != [
            c for c in range(GRAPH_CYCLES) if E.refresh_flags(c, cfg)[0]]:
        fails.append(f"fill-in counts graph {g_fill} eager {eager['fill']}")
    for v, (warm, cap) in graph.capture_seconds.items():
        print(f"[11 graphs] variant {tuple(int(x) for x in v)}: warm-up "
              f"{warm:.3f}s, capture and instantiation {cap:.3f}s",
              flush=True)
    caps = sum(w + c for w, c in graph.capture_seconds.values())
    print(f"[11 graphs] prepare (4 variants before cycle 0) "
          f"{prep_s:.3f}s: warm-ups and captures {caps:.3f}s, snapshots "
          f"and restores {prep_s - caps:.3f}s", flush=True)
    # phase 11b's reference: the unmarked graphs' cycles 0-52 and setup
    ref = dict(losses=st.losses.clone(), parts=st.parts.clone(),
               leaves=[t.clone() for t in CG.tree_leaves(
                   (st.params, st.nu, st.trace, st.count))],
               setup=(params, data, aux0, m, coefs, cfg, opt_scale))
    print(f"[11 graphs] peak memory eager {eager['peak'] / 2**30:.2f} GiB, "
          f"graphs {g_peak / 2**30:.2f} GiB", flush=True)
    print(f"[11 graphs] seconds a cycle: eager {_span(eager['secs'])}; "
          f"graphs {_span(g_secs)} (replays only)", flush=True)

    # steady replays after the comparison: cycle 50's graph (both
    # refreshes) again, then one steady cycle under the profiler and
    # between CUDA events
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay(50)
    torch.cuda.synchronize()
    r50 = time.perf_counter() - t0
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        graph.replay(51)
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [k for k in prof.key_averages()
            if k.device_type == DeviceType.CUDA]
    busy = sum(k.device_time_total for k in rows) / 1e6
    span = a.elapsed_time(b) / 1e3
    print(f"[11 graphs] replay of cycle 50's graph again: {r50:.4f}s; a "
          f"steady replay (cycle 51's graph): host wall {wall:.4f}s, CUDA "
          f"events around it {span:.4f}s ({span / wall:.3f} of the wall); "
          f"torch.profiler sees {len(rows)} device rows, "
          f"{sum(k.count for k in rows)} launches, busy {busy:.4f}s = "
          f"{busy / wall:.3f} of the profiled wall (idle "
          f"{1 - busy / wall:.3f})", flush=True)

    med = bench_multicycle.run(
        seq, model, device=dev,
        report=lambda line: print(f"[11 graphs] bench_multicycle: {line}",
                                  flush=True), **GRAPH_BENCH)
    print(f"[11 graphs] nvidia-smi: {smi_line()}", flush=True)
    if fails:
        raise AssertionError("graphs: " + "; ".join(fails))
    a, b = GRAPH_TIMED
    return ({k: sum(n[k] for n in g_launches) for k in want},
            {k: sum(n[k] for n in g_fill) for k in g_fill[0]},
            {"replay_median": float(np.median(g_secs[a:b])),
             "per_cycle": per_cycle, "variants": len(graph.graphs),
             "ref": ref})


# Phase 11b: marks captured back to back in one graph to time a mark,
# and replays of it
MARK_GRAPH = (200, 20)


def _launch_ms(body, device):
    """ms a launch of `body`, MARK_GRAPH[0] calls captured in one graph
    and replayed MARK_GRAPH[1] times between CUDA events."""
    from mhmocap_tpu_torch.engine.cycle_graph import capture_graph
    per, reps = MARK_GRAPH
    graph = capture_graph(lambda: [body() for _ in range(per)], device,
                          name="smoke")
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / (per * reps)


def phase_marks(ref):
    """Phase 11b: the phase-mark kernel at bench-ts1's shape (7 chunks,
    19 slots), captured into all 4 variants' graphs from phase 11's
    init, against its plain version (the CPU path of
    `PhaseMarks.__call__`) run in the same order as `cycle_body` calls
    it. After each replay: the row the kernel read from the device
    counter is the one filled, the earlier rows are as they were and the
    later ones -1; the slots equal to their predecessor (the phases the
    variant skips, copied) are the plain ring's, every other slot
    increases, and the update mark (row offset -1) lands in the cycle's
    own row. A mark at a row outside the ring changes nothing. The
    kernel counts one launch a mark. The losses, parts, params and
    RMSprop state equal phase 11's unmarked graphs bit for bit. Timed:
    a mark in a graph against torch's one-element fill (the launch,
    which bounds it)."""
    from mhmocap_tpu_torch.engine import cycle_graph as CG
    from mhmocap_tpu_torch.engine import optimizer as E
    from mhmocap_tpu_torch.ops import phase_marks as PM
    params, data, aux0, m, coefs, cfg, opt_scale = ref["setup"]
    dev = params.poses_T.device
    n, K = GRAPH_CYCLES, cfg.num_chunks
    names = PM.slot_names(K)
    graph = CG.CycleGraph(params, E.rmsprop_init(params), aux0, m, data,
                          coefs, cfg, opt_scale, num_cycles=n,
                          phase_marks=True)
    graph.prepare(0, n)
    PM.launches.reset()
    plain_ring = PM.make_ring(n, K, "cpu")
    plain_cycle = torch.zeros((), dtype=torch.int64)
    plain = PM.PhaseMarks(plain_ring, plain_cycle, K)
    fails, want_launches, seen = [], 0, {}
    before = graph.state.ring.cpu()
    if not (before == -1).all():
        fails.append("prepare left marks in the ring")
    for c in range(n):
        v = graph.replay(c)
        order = graph.mark_order[v]
        for name in order:
            if name == "update":
                plain_cycle.add_(1)
                plain(name, row_offset=-1)
            else:
                plain(name)
        want_launches += len(order)
        seen.setdefault(v, order)
        ring = graph.state.ring.cpu()
        got, want = ring[c], plain_ring[c]
        if not (torch.equal(ring[:c], before[:c])
                and (ring[c + 1:] == -1).all()):
            fails.append(f"cycle {c} wrote outside its row")
        if not torch.equal(got[1:] == got[:-1], want[1:] == want[:-1]):
            fails.append(f"cycle {c} ({''.join(str(int(f)) for f in v)}): "
                         f"copied slots {(got[1:] == got[:-1]).tolist()}, "
                         f"plain {(want[1:] == want[:-1]).tolist()}")
        if (got <= 0).any() or (got.diff() < 0).any() or (
                c and got[0] < before[c - 1, -1]):
            fails.append(f"cycle {c}'s row is not filled and non-decreasing")
        before = ring
    counted = PM.launches["marks"]
    # rows outside the ring: past its end (the counter now reads n) and
    # before its start
    graph.marks("start")
    graph.marks("start", row_offset=-n - 1)
    outside = torch.equal(graph.state.ring.cpu(), before)
    total = PM.launches["marks"]
    same = (torch.equal(graph.state.losses, ref["losses"])
            and torch.equal(graph.state.parts, ref["parts"])
            and all(torch.equal(a, b) for a, b in zip(
                CG.tree_leaves((graph.state.params, graph.state.nu,
                                graph.state.trace, graph.state.count)),
                ref["leaves"])))
    rows = graph.phase_rows(0, n)
    refresh = [c for c in range(n) if E.refresh_flags(c, cfg)[1]]
    plain_c = [c for c in range(n)
               if c > cfg.warmup_cycles and c not in refresh]
    groups = PM.group_ms(rows, K)
    print(f"[11b marks] {len(seen)} variants, marks a cycle "
          f"{ {''.join(str(int(f)) for f in v): len(o) for v, o in seen.items()} }"
          f" of {len(names)} slots; rows that differ from the plain "
          f"version's structure {len([f for f in fails if 'copied' in f])}"
          f"; launches counted {counted} (want {want_launches}), two "
          f"marks outside the ring {total - counted} and the ring "
          f"unchanged {outside}; state bit-identical to phase 11's "
          f"unmarked graphs {same}", flush=True)
    print(f"[11b marks] group ms, median of plain cycles {plain_c[0]}-"
          f"{plain_c[-1]}: " + ", ".join(
        f"{g} {np.median(groups[g][plain_c]):.3f}" for g in PM.GROUPS)
          + f"; refresh cycles {refresh}: " + ", ".join(
              f"{g} {np.round(groups[g][refresh], 3).tolist()}"
              for g in PM.GROUPS), flush=True)
    ring1 = PM.make_ring(1, K, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    one = torch.zeros((1,), device=dev)
    mark = PM.PhaseMarks(ring1, zero, K)
    mark_ms = _launch_ms(lambda: mark("start"), dev)
    fill_ms = _launch_ms(lambda: one.zero_(), dev)
    print(f"[11b marks] a mark in a graph {1e3 * mark_ms:.2f} us, a "
          f"one-element fill {1e3 * fill_ms:.2f} us (the launch bound); "
          f"{len(names) - 2} marks a plain cycle "
          f"{1e3 * mark_ms * (len(names) - 2):.1f} us", flush=True)
    if counted != want_launches or total - counted != 2:
        fails.append(f"mark launches {counted} + {total - counted}, want "
                     f"{want_launches} + 2")
    if not outside:
        fails.append("a mark outside the ring changed it")
    if not same:
        fails.append("the marked graphs' state differs from the unmarked")
    if len(seen) != 4:
        fails.append(f"{len(seen)} variants, want 4")
    if fails:
        raise AssertionError("phase marks: " + "; ".join(fails[:8]))
    return {"launches": counted, "ms": mark_ms, "bound_ms": fill_ms,
            "rows": n, "slots": len(names)}


# Phase 12: a bench window's seconds a cycle may differ from phase 11's
# replay median by this share (replays within one call spread under 1%;
# a window that held a warm-up and a capture would read 35-75% slow)
BENCH_WINDOW_TOL = 0.15


def phase_bench(graphs):
    """Phase 12: the port's bench.py at full size."""
    import contextlib
    import io
    from mhmocap_tpu_torch import bench
    fails = []
    _reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = bench.main([])
    wall = time.time() - t0
    launches = _raster_counts("12 bench")
    fill = _fillin_counts("12 bench")
    for line in buf.getvalue().splitlines():
        print(f"[12 bench] {line}", flush=True)
    wins = np.asarray(res["secondary"]["window_frame_cycles_per_sec"])
    win_s = bench.T / wins
    med = graphs["replay_median"]
    print(f"[12 bench] bench.main {wall:.1f}s; windows' seconds a cycle "
          f"{[round(float(x), 5) for x in win_s]} against phase 11's replay "
          f"median {med:.5f}s (ratios "
          f"{[round(float(x / med), 4) for x in win_s]}, bound "
          f"{1 + BENCH_WINDOW_TOL}); launches {launches}", flush=True)
    if len(wins) != 3 or not np.isfinite(wins).all():
        fails.append(f"windows {wins.tolist()}")
    elif np.abs(win_s / med - 1).max() > BENCH_WINDOW_TOL:
        fails.append(f"a window's s/cycle {win_s.tolist()} is more than "
                     f"{BENCH_WINDOW_TOL:.0%} from the replay median {med}")
    # the bare cycle's warm-up and 3 replays, one warm-up of each of the
    # fit's variants, its 76 replays; captures launch nothing
    cycles = 4 + graphs["variants"] + bench.BENCH_CYCLES[-1] + 1
    want = {k: cycles * graphs["per_cycle"] for k in launches}
    if launches != want:
        fails.append(f"bench launches {launches} != {want}")
    if fails:
        raise AssertionError("bench: " + "; ".join(fails))
    return launches, fill


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    phase_build()
    errs, timing, setup = phase_kernels()
    window_loss = phase_window_loss()
    fillin = phase_fillin()
    with tempfile.TemporaryDirectory() as tmp:
        runs = [phase_main_path(os.path.join(tmp, "main"))]
        phase_reference(os.path.join(tmp, "ref"))
        entry_launches, entry_fill = phase_entry_points(
            os.path.join(tmp, "entry"))
        runs += [(entry_launches[ts], entry_fill[ts]) for ts in entry_launches]
        phase_codecs(write_robust_tree(os.path.join(tmp, "robust")))
        runs.append(phase_shipped_config(os.path.join(tmp, "robust")))
        phase_checkpoint(os.path.join(tmp, "ckpt"))
        fhsog_launches = phase_visualization_fhsog(
            tmp, os.path.join(tmp, "robust", "out", f"TS{ROBUST_TS}"))
    runs.append(phase_sharded())
    graph_launches, graph_fill, graphs = phase_graphs()
    runs.append((graph_launches, graph_fill))
    marks = phase_marks(graphs.pop("ref"))
    runs.append(phase_bench(graphs))
    # the launches of every main-path run, each counted from 0 (the
    # FHSOG build runs the forward kernel only, and no fill-in)
    launches = {k: fhsog_launches[k] + sum(r[k] for r, _ in runs)
                for k in fhsog_launches}
    fill = {k: sum(f[k] for _, f in runs) for k in runs[0][1]}
    print(f"fill-in over the main paths: {fill}", flush=True)
    # times and bounds at B=29, window 160; no single PyTorch call
    # computes either function, so neither has a library time
    t160 = timing[29, 160]
    kernels = [
        {"name": f"raster_{k}", "route": "cuda",
         "source": f"mhmocap_tpu_torch/ops/csrc/raster_{k}.cu",
         "replaces": f"mhmocap_tpu/ops/raster_pallas.py:{line}",
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": t160[k], "plain_ms": t160[f"plain_{k}"],
         "bound_ms": t160["bound"][k][0], "bound_by": t160["bound"][k][1],
         "library_ms": None, "pairs": t160["pairs"],
         "live_pairs": t160["live"]}
        for k, line in (("fwd", 515), ("bwd", 650))]
    # the face set-up's at B=29, window 160; its launches are those of
    # the main paths, each run's equal to its raster launches; its bits
    # that differ from the plain version over every shape of phase 3
    f160 = setup[29, 160]
    timed = {k: v for k, v in setup.items() if "fwd" in v}
    bits = {"fwd": sum(v["errs"]["tab"][0] + v["errs"]["agg"][0]
                       for v in setup.values()),
            "bwd": sum(v["errs"]["d_uvz"][0] for v in setup.values())}
    kernels += [
        {"name": f"face_setup_{k}", "route": "cuda",
         "source": "mhmocap_tpu_torch/ops/csrc/face_setup.cu",
         "replaces": None, "launches": launches[f"setup_{k}"],
         "bits_differ": bits[k], "shapes_checked": len(setup),
         "max_rel_norm_err": (0.0 if k == "fwd" else max(
             v["errs"]["d_uvz_rel_norm"] for v in setup.values())),
         "ms": f160[k], "plain_ms": f160[f"plain_{k}"],
         "bound_ms": f160["bound"][k][0], "bound_by": "bytes",
         "library_ms": None, "chain_graph_ms": f160["chain"],
         "shapes": {f"{b}x{w}": {"ms": v[k], "bound_ms": v["bound"][k][0]}
                    for (b, w), v in timed.items()}}
        for k in ("fwd", "bwd")]
    # the fill-in's numbers at the scene rebuild's call (once a cycle);
    # its launches are the round launches (FILLIN_ITERS a call)
    kernels.append(dict(
        fillin["scene"], name="fillin", route="cuda",
        source="mhmocap_tpu_torch/ops/csrc/fillin.cu",
        replaces="mhmocap_tpu/ops/image.py:56", launches=fill["rounds"],
        max_abs_err=fillin["max_abs_err"], library_ms=None,
        calls=fill["calls"], live_rounds=fill["live"],
        shapes={k: v for k, v in fillin.items() if k != "max_abs_err"}))
    # the window-loss pair at ts11-fit's chunk (the claimed cell); its
    # launches are those phases 4 and 11 counted
    w11 = window_loss["ts11-fit"]
    kernels += [
        {"name": f"window_loss_{k}", "route": "cuda",
         "source": "mhmocap_tpu_torch/ops/csrc/window_loss.cu",
         "replaces": None, "launches": WINDOW_LOSS_COUNTED[k],
         "bits_differ": (sum(v["bits"] for v in window_loss.values())
                         if k == "bwd" else None),
         "max_rel_err": max(max(v["rel"].values())
                            for v in window_loss.values()),
         "ms": w11[k], "plain_ms": w11[f"plain_{k}"],
         "bound_ms": w11["bound"][k][0], "bound_by": "bytes",
         "library_ms": None, "chain_graph_ms": w11["chain"],
         "shapes": {c: {"ms": v[k], "bound_ms": v["bound"][k][0]}
                    for c, v in window_loss.items()}}
        for k in ("fwd", "bwd")]
    # the phase mark at bench-ts1's graphs (phase 11b): its structure
    # held to the plain version's, row for row; bound by its launch
    kernels.append(dict(
        name="phase_mark", route="cuda",
        source="mhmocap_tpu_torch/ops/csrc/phase_mark.cu", replaces=None,
        launches=marks["launches"], rows_differ=0, ms=marks["ms"],
        plain_ms=None, bound_ms=marks["bound_ms"], bound_by="launch",
        library_ms=None, shape=[marks["rows"], marks["slots"]]))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port (mhmocap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero):
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles the raster kernels (ops/csrc/*.cu) with nvcc for
     sm_90a into build/mhmocap_tpu_torch/ and prints the build time and
     ptxas' register, spill and shared-memory report;
  3. kernels: each kernel against its plain torch version on the card
     at every raster call shape of phases 4, 6, 7, 9 and 10 and of
     bench-ts1 on 4 ranks (workload.KERNEL_SHAPES: posed full-size
     bodies, 29 per call at windows 160/128/112, 30 at 160/112/80,
     phase 7's, 12 at the full-frame 256, 34 and 17 at 160/128/112;
     errors printed beside their bounds), the forward's
     log1pf shortcut checked, two forward and two backward launches
     bit-identical, then, at the shapes of phases 4, 6 and 9
     (workload.TIMED_SHAPES), timed against the plain version on
     the same inputs; prints the active (cell, chunk) pairs (the JAX
     package's cell-major schedule, held equal to the backward's
     chunk-major cells) and the chunks per active cell, the pixel-face
     pairs among them whose coverage term is not 0 and those the
     forward's cull keeps, and each kernel's bound on that work and its
     share of it;
  4. main path: Predictor.run on the production workload (T=201, N=3,
     256x256, raster_window=160 -> windows 160/128/112) for 52 cycles,
     so that the scene rebuild (cycle 30) and the One-Euro refresh
     (cycle 50) both run; checks the kernel launch counters, the losses,
     the refreshes and the pickles, and prints the per-cycle and
     init-solve seconds; fails on a raster call shape phase 3 did not
     check;
  5. reference: a tiny Predictor.run on the card against the same run on
     the CPU (plain torch path);
  6. entry points: writes two synthetic MuPoTs trees with the port's
     writer (TS1 with 3 people, TS2 with 2; 60 frames, 256x256, the full
     6890-vertex body, annot.mat GT), a sweep-style config (100 cycles,
     resize_factor 1.0, post_process_depth on), runs
     `predict_mupots.main --device cuda` on each tree and
     `eval_mupots.main` over both; prints the raster launches per tree,
     the ingestion seconds (decode / post-process / assignment), the
     init and per-cycle seconds and the FinalResults averages; checks
     the pickles against the JAX package's schema, finite metrics, each
     tree's pck_rel against its measured floor (ENTRY_MIN_PCK) and, as
     phase 4, the raster call shapes against phase 3's;
  7. shipped config: writes one degraded tree (the sweep's combined
     degradation plan: crossing paths, a person leaving the frame, an
     ID switch, detection and ROMP dropout, so that stale frames exist;
     32 frames, 3 people, 2048x2048) and runs `predict_mupots.main` with
     configs/predict_mupots_robust.yml unedited (250 cycles,
     resize_factor 0.125, gap_aware_temporal, id_swap_fix 0.5,
     post_process_depth, save_visualizations), then `eval_mupots.main`;
     prints the launches, the ingestion split, the per-cycle median
     (CUDA events between cycles), the seconds of the two exports and
     the FinalResults averages; checks stale frames, a live
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
     holds.
The last three lines are a JSON object with one entry per kernel,
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
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    t0 = time.time()
    lib, log = RC.build_kernels()
    dt = time.time() - t0
    print(f"[2 build] {lib} in {dt:.2f}s"
          + ("" if log else " (already built)"), flush=True)
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"[2 build] ptxas: {line.strip()}")
    RC._library()
    return dt


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


def phase_kernels():
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    from mhmocap_tpu_torch.ops.rasterizer import preorder_faces
    from mhmocap_tpu_torch.workload import (KERNEL_SHAPES, TIMED_SHAPES,
                                            cuda_ms, posed_raster_tables)
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
    timing = {}
    for B, win in ((b, w) for b, wins in KERNEL_SHAPES for w in wins):
        tab, agg, lists, bounds, inv_blur, znear = posed_raster_tables(
            model, win, B, seed=win, device=dev)
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
    return errs, timing


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
    from mhmocap_tpu_torch.ops.raster_cuda import RasterPlanes
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
    for k in RasterPlanes.launches:
        RasterPlanes.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = pred.run(verbose=True)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = dict(RasterPlanes.launches)
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
    if min(launches.values()) <= 0:
        raise AssertionError(f"a raster kernel never launched: {launches}")
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
    return launches


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
    from mhmocap_tpu_torch.ops.raster_cuda import RasterPlanes
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
    launches = {}
    for ts, _ in ENTRY_TREES:
        for k in RasterPlanes.launches:
            RasterPlanes.launches[k] = 0
        t0 = time.time()
        summary = predict_mupots.main(
            ["--configs_yml", cfg, "--ts_id", str(ts), "--output_path", out,
             "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[ts] = dict(RasterPlanes.launches)
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
              f"(min {cyc.min():.4f}, max {cyc.max():.4f}); predict_mupots "
              f"{wall:.1f}s", flush=True)
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
    return launches


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
    """Records a CUDA event after each stage-1 cycle while active, with
    no host synchronization, so that the per-cycle times of a run whose
    config sets no bench_cycles can be read afterwards (the card's
    timeline between consecutive cycles' last work)."""

    def __init__(self):
        from mhmocap_tpu_torch.engine import optimizer as E
        self.E, self.cycle, self.events = E, E.stage1_cycle_fused, []

    def __enter__(self):
        def timed(*args, **kwargs):
            out = self.cycle(*args, **kwargs)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return out
        self.E.stage1_cycle_fused = timed
        return self

    def __exit__(self, *exc):
        self.E.stage1_cycle_fused = self.cycle

    def seconds(self) -> np.ndarray:
        """Seconds of cycles 1.. (cycle 0 has no event before it)."""
        torch.cuda.synchronize()
        return np.asarray([a.elapsed_time(b) / 1e3 for a, b in
                           zip(self.events, self.events[1:])])


def phase_shipped_config(tmp):
    """configs/predict_mupots_robust.yml, unedited, on a degraded tree."""
    import pickle
    from mhmocap_tpu_torch import eval_mupots, predict_mupots, sweep
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.ops.raster_cuda import RasterPlanes
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    t0 = time.time()
    body = make_synthetic_smpl()
    generate_sequence(
        os.path.join(data, f"TS{ROBUST_TS}"), num_frames=ROBUST_FRAMES,
        num_people=ROBUST_PEOPLE, image_size=(ROBUST_SIDE, ROBUST_SIDE),
        model=body, seed=7 + ROBUST_TS, mupots_gt=True,
        degradations=sweep.degradation_plan(ROBUST_TS, ROBUST_FRAMES))
    print(f"[7 robust] wrote TS{ROBUST_TS} ({ROBUST_PEOPLE} people, "
          f"{ROBUST_FRAMES} frames, {ROBUST_SIDE}x{ROBUST_SIDE}, degraded) "
          f"in {time.time() - t0:.1f}s", flush=True)
    for k in RasterPlanes.launches:
        RasterPlanes.launches[k] = 0
    t0 = time.time()
    with CycleClock() as clock:
        summary = predict_mupots.main(
            ["--configs_yml", ROBUST_CONFIG, "--ts_id", str(ROBUST_TS),
             "--input_path", data, "--output_path", out,
             "--device", "cuda"])
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(RasterPlanes.launches)
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
          f"{cyc.min():.4f}, max {cyc.max():.4f}); exports: init "
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
    return launches


def phase_checkpoint(tmp):
    """A tiny sequence: 4 cycles unbroken (profiler trace of cycle 2)
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
    print(f"[8 checkpoint] {printed.strip()}; resumed vs unbroken: arrays "
          f"that differ {differ}, losses of cycles 2-3 equal {same_losses}; "
          f"trace {trace} {size} bytes", flush=True)
    if "resumed from checkpoint at cycle 1" not in printed:
        raise AssertionError("the 4-cycle run did not resume at cycle 1")
    if differ or not same_losses:
        raise AssertionError("the resumed run is not bit-identical to the "
                             "unbroken one")
    if not size:
        raise AssertionError("profile_dir wrote no trace")


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
    from mhmocap_tpu_torch.ops.raster_cuda import RasterPlanes
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
    for k in RasterPlanes.launches:
        RasterPlanes.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with RasterClock() as clock:
        out = build(args)
        torch.cuda.synchronize()
    build_s = time.time() - t0
    launches = dict(RasterPlanes.launches)
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
    from mhmocap_tpu_torch.ops.raster_cuda import RasterPlanes
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
           "launches": [], "losses": [], "calls": sorted(_raster_calls(cfg)),
           "local_chunks": cfg.padded_frames // (spec["ranks"] * cfg.chunk),
           "cfg": (cfg.chunk, cfg.padded_frames, cfg.person_windows)}
    del aux0, grads
    for c in cycles:
        sync()
        for k in RasterPlanes.launches:
            RasterPlanes.launches[k] = 0
        t0 = time.time()
        if mesh is None:
            params, state, aux, loss, _ = E.stage1_cycle_fused(
                params, state, aux, c, model, data, coefs, cfg)
        else:
            params, state, aux, loss, _ = S.spmd_stage1_cycle_fused(
                params, state, aux, c, model, data, coefs, cfg, mesh)
        sync()
        out["seconds"].append(time.time() - t0)
        out["launches"].append(dict(RasterPlanes.launches))
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
    against `stage1_cycle_fused` in this process, on the same layout,
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
            for k in ("fwd", "bwd")}
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
    return {k: sum(n[k] for g in ranks for n in g["launches"])
            for k in ("fwd", "bwd")}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    phase_build()
    errs, timing = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        main_launches = phase_main_path(os.path.join(tmp, "main"))
        phase_reference(os.path.join(tmp, "ref"))
        entry_launches = phase_entry_points(os.path.join(tmp, "entry"))
        robust_launches = phase_shipped_config(os.path.join(tmp, "robust"))
        phase_checkpoint(os.path.join(tmp, "ckpt"))
        fhsog_launches = phase_visualization_fhsog(
            tmp, os.path.join(tmp, "robust", "out", f"TS{ROBUST_TS}"))
    shard_launches = phase_sharded()
    # the launches of every main-path run, each counted from 0
    launches = {k: main_launches[k] + robust_launches[k] + fhsog_launches[k]
                + shard_launches[k]
                + sum(v[k] for v in entry_launches.values())
                for k in main_launches}
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
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

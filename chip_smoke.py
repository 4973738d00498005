"""Smoke run of the PyTorch/CUDA port (mhmocap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero):
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles the raster kernels (ops/csrc/*.cu) with nvcc for
     sm_90a into build/mhmocap_tpu_torch/ and prints the build time and
     ptxas' register/shared-memory report;
  3. kernels: each kernel against its plain torch version on the card
     at the main path's shapes, 29 posed full-size bodies per call at
     windows 160/128/112 (errors printed beside their bounds), then
     timed against the plain version on the same inputs;
  4. main path: Predictor.run on the production workload (T=201, N=3,
     256x256, raster_window=160 -> windows 160/128/112) for 52 cycles,
     so that the scene rebuild (cycle 30) and the One-Euro refresh
     (cycle 50) both run; checks the kernel launch counters, the losses,
     the refreshes and the pickles, and prints the per-cycle and
     init-solve seconds;
  5. reference: a tiny Predictor.run on the card against the same run on
     the CPU (plain torch path).
The line before the last is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FULL_WINDOWS = (160, 128, 112)
# body depth whose projection fills each window (bench placement)
WINDOW_DEPTH = {160: 3.4, 128: 4.2, 112: 5.0}
BODIES = 29               # bodies per raster call on the main path
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
        if "registers" in line or "Compiling entry" in line:
            print(f"[2 build] ptxas: {line.strip()}")
    RC._library()
    return dt


def _posed_tables(model, win, n_bodies, seed, device):
    """Folded tables and schedule of n_bodies posed bodies at the depth
    that fills `win` in a 256x256 image."""
    from mhmocap_tpu_torch.models.smpl import smpl_forward
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    from mhmocap_tpu_torch.ops import rasterizer as R
    from mhmocap_tpu_torch.ops.cameras import intrinsics_from_fov, \
        project_points
    rng = np.random.RandomState(seed)
    poses = torch.as_tensor(0.1 * rng.randn(n_bodies, 72), dtype=torch.float32,
                            device=device)
    transl = np.zeros((n_bodies, 3), np.float32)
    transl[:, 2] = WINDOW_DEPTH[win]
    transl[:, :2] = 0.05 * rng.randn(n_bodies, 2)
    with torch.no_grad():
        v = smpl_forward(model, torch.zeros((n_bodies, 10), device=device),
                         poses, transl=torch.as_tensor(transl, device=device))
        st = R.RasterSettings(image_size=(256, 256), window=win)
        K = torch.as_tensor(intrinsics_from_fov((256, 256), 60.0),
                            device=device)
        uvz = project_points(v["verts"], K, return_depth=True)
        origin = R.window_origin(uvz[..., :2], uvz[..., 2], st)
        fuvz = uvz[:, model.faces]
        fuv = fuvz[..., :2] - origin[:, None, None, :].float()
        planes, bbox, oks, okd = R.face_planes(fuv, fuvz[..., 2], st.znear)
        reach = 3.0 * float(np.sqrt(st.sil_blur_px2)) + 1.0
        inv_blur = 1.0 / st.sil_blur_px2
        tab, agg = RC._tables(planes, bbox, bbox[..., 2] - reach,
                              bbox[..., 3] + reach, oks, okd, inv_blur)
        lists, bounds = RC._strip_chunk_lists(agg, win)
    return tab, agg, lists, bounds, inv_blur, st.znear


def _cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernels():
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    from mhmocap_tpu_torch.ops import raster_cuda as RC
    from mhmocap_tpu_torch.ops.rasterizer import preorder_faces
    dev = torch.device("cuda")
    # the faces in the Predictor's static spatial order, as on the main
    # path (the schedule is exact for any order; a coherent order gives
    # compact chunks and so fewer active (cell, chunk) pairs)
    model = preorder_faces(make_synthetic_smpl(device=dev))
    print(f"[3 kernels] body V={model.num_vertices} F={model.num_faces} "
          f"(faces preordered), B={BODIES} per call", flush=True)
    errs = {"fwd": 0.0, "bwd": 0.0}
    timing = {}
    for win in FULL_WINDOWS:
        tab, agg, lists, bounds, inv_blur, znear = _posed_tables(
            model, win, BODIES, seed=win, device=dev)
        zk, lk, ak = RC.raster_fwd_cuda(tab, agg, lists, bounds, win,
                                        inv_blur, znear)
        zp, lp, ap = RC.raster_fwd_plain(tab, win, inv_blur, znear)
        torch.cuda.synchronize()
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
        dz = torch.as_tensor(rng.randn(BODIES, win, win), dtype=torch.float32,
                             device=dev)
        dz = torch.where(ak >= 0, dz, torch.zeros_like(dz)).contiguous()
        dlk = torch.as_tensor(rng.randn(BODIES, win, win),
                              dtype=torch.float32, device=dev)
        gk = RC.raster_bwd_cuda(tab, agg, lists, bounds, dz, dlk, ak, win,
                                inv_blur)
        gp = RC.raster_bwd_plain(tab, dz, dlk, ak, win, inv_blur)
        torch.cuda.synchronize()
        scale = float(gp.abs().max())
        res["dplanes_rel_max"] = float((gk - gp).abs().max()) / max(scale,
                                                                   1e-30)
        res["dplanes_rel_norm"] = float(torch.linalg.norm(gk - gp)
                                        / torch.linalg.norm(gp))
        errs["fwd"] = max(errs["fwd"], res["zbuf_abs"], res["sil_abs"])
        errs["bwd"] = max(errs["bwd"], float((gk - gp).abs().max()))
        covered = ck.reshape(BODIES, -1).sum(-1)
        print(f"[3 kernels] win {win}: covered px per body "
              f"{int(covered.min())}..{int(covered.max())}, "
              + ", ".join(f"{k} {v:.3g} (bound {BOUNDS[k]:g})"
                          for k, v in res.items()), flush=True)
        for k, v in res.items():
            if not v <= BOUNDS[k]:
                raise AssertionError(f"kernel vs plain, window {win}: {k} "
                                     f"= {v} exceeds {BOUNDS[k]}")
        if int(covered.min()) == 0:
            raise AssertionError(f"window {win}: a body covers no pixel")

        t = {
            "plain_fwd": _cuda_ms(lambda: RC.raster_fwd_plain(
                tab, win, inv_blur, znear), 2),
            "fwd": _cuda_ms(lambda: RC.raster_fwd_cuda(
                tab, agg, lists, bounds, win, inv_blur, znear), 5),
            "bwd": _cuda_ms(lambda: RC.raster_bwd_cuda(
                tab, agg, lists, bounds, dz, dlk, ak, win, inv_blur), 5),
            "plain_bwd": _cuda_ms(lambda: RC.raster_bwd_plain(
                tab, dz, dlk, ak, win, inv_blur), 2),
        }
        timing[win] = t
        print(f"[3 kernels] time B={BODIES} win {win}: "
              f"fwd {t['fwd']:.3f} ms (plain {t['plain_fwd']:.3f}), "
              f"bwd {t['bwd']:.3f} ms (plain {t['plain_bwd']:.3f})",
              flush=True)
    return errs, timing


INIT_KEYS = {"scale_factor", "poses_T", "poses_smpl", "betas_smpl",
             "valid_smpl", "min_z", "max_z", "scene_depth", "scene_img",
             "scene_mask", "pose2d"}
STAGE1_KEYS = (INIT_KEYS - {"pose2d"}) | {
    "raster_window", "window_clip_rate", "raster_windows",
    "window_clip_rates"}


def _load_pickles(out_dir):
    import pickle
    res = {}
    for name, keys in (("optvar_init.pkl", INIT_KEYS),
                       ("optvar_stage1.pkl", STAGE1_KEYS)):
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
    if cfg.person_windows != FULL_WINDOWS:
        raise AssertionError(f"windows {cfg.person_windows} != "
                             f"{FULL_WINDOWS}")
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


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    phase_build()
    errs, timing = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(os.path.join(tmp, "main"))
        phase_reference(os.path.join(tmp, "ref"))
    t160 = timing[160]
    kernels = [
        {"name": "raster_fwd", "route": "cuda",
         "source": "mhmocap_tpu_torch/ops/csrc/raster_fwd.cu",
         "replaces": "mhmocap_tpu/ops/raster_pallas.py:515",
         "launches": launches["fwd"], "max_abs_err": errs["fwd"],
         "ms": t160["fwd"], "plain_ms": t160["plain_fwd"]},
        {"name": "raster_bwd", "route": "cuda",
         "source": "mhmocap_tpu_torch/ops/csrc/raster_bwd.cu",
         "replaces": "mhmocap_tpu/ops/raster_pallas.py:650",
         "launches": launches["bwd"], "max_abs_err": errs["bwd"],
         "ms": t160["bwd"], "plain_ms": t160["plain_bwd"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

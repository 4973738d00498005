"""The four scripts ported as package modules: diff_final_results,
decompose_jitter, predict_mupots_sweep and bench_e2e.

The numpy parts are held against the JAX package's script files, loaded
by path here only; the sweep's scheduling, pinning, timeout, retries and
failure report as tests/test_sweep.py holds the JAX script's; bench_e2e
and decompose_jitter run end to end on tiny trees with --device cpu.
"""

import importlib.util
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest

from mhmocap_tpu_torch import (bench_e2e, decompose_jitter,
                               diff_final_results, predict_mupots,
                               predict_mupots_sweep as sweep)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """script/<name>.py of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "script", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def final_results(path, pck_avg, keys=("pck_rel", "mm_rel_error",
                                       "abs_jitter_univ")):
    vals = {k: [10.0 + i for i in range(2)] + [11.0] for k in keys}
    if "pck_rel" in vals:
        vals["pck_rel"][-1] = pck_avg
    with open(path, "w") as f:
        json.dump({"final_results": vals, "sequences": ["TS1", "TS2"]}, f)
    return str(path)


@pytest.mark.parametrize("ours_avg, keys, rc", [
    (95.2, ("pck_rel", "mm_rel_error", "abs_jitter_univ"), 0),
    (94.0, ("pck_rel", "mm_rel_error"), 1),
    (95.0, ("other",), 2)])
def test_diff_final_results_matches_jax(tmp_path, capsys, ours_avg, keys, rc):
    """The same table, verdict and exit code as the JAX script."""
    ref = final_results(tmp_path / "ref.json", 95.0, keys)
    ours = final_results(tmp_path / "ours.json", ours_avg, keys)
    got = diff_final_results.main([ref, ours])
    out = capsys.readouterr()
    want = jax_script("diff_final_results").main([ref, ours])
    jout = capsys.readouterr()
    assert got == want == rc
    assert (out.out, out.err) == (jout.out, jout.err)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jitter_classes_match_jax(seed):
    """frame_jitter_mm and classify_frames against the JAX script's."""
    ref = jax_script("decompose_jitter")
    rng = np.random.RandomState(seed)
    T = 40
    m = {"abs_jitter": rng.rand(T, 3, 14).astype(np.float32),
         "valid_joints": (rng.rand(T, 3, 14) > 0.3).astype(np.float32)}
    m["valid_joints"][5] = 0
    stale = rng.rand(T, 3) > 0.8
    np.testing.assert_array_equal(decompose_jitter.frame_jitter_mm(m),
                                  ref.frame_jitter_mm(m))
    np.testing.assert_array_equal(decompose_jitter.classify_frames(stale),
                                  ref.classify_frames(stale))


def test_build_commands_shape():
    cmds = sweep.build_commands([1, 7], "cfg.yml", "/out",
                                ["--num_iter", "5"], device="cpu")
    assert len(cmds) == 2
    assert cmds[0][1:3] == ["-m", "mhmocap_tpu_torch.predict_mupots"]
    assert cmds[1][cmds[1].index("--ts_id") + 1] == "7"
    assert cmds[0][cmds[0].index("--device") + 1] == "cpu"
    assert cmds[0][-2:] == ["--num_iter", "5"]


def test_worker_env_pins_one_card():
    env = sweep.worker_env(3)
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert sweep.worker_env(0, device="cpu")["CUDA_VISIBLE_DEVICES"] == ""


def test_run_sweep_schedules_all_jobs(tmp_path):
    marker = tmp_path / "done"
    cmds = [[sys.executable, "-c", f"open(r'{marker}_{i}', 'w').write('x')"]
            for i in range(5)]
    res = sweep.run_sweep(cmds, workers=2, device="cpu",
                          labels=[f"TS{i}" for i in range(5)])
    assert res == {f"TS{i}": 0 for i in range(5)}
    for i in range(5):
        assert os.path.exists(f"{marker}_{i}")


def test_run_sweep_job_timeout_kills_hung_worker():
    t0 = time.time()
    res = sweep.run_sweep(
        [[sys.executable, "-c", "import time; time.sleep(60)"],
         [sys.executable, "-c", "pass"]],
        workers=1, device="cpu", labels=["hung", "ok"], job_timeout=2.0)
    assert res == {"hung": 124, "ok": 0}
    assert time.time() - t0 < 30


def test_run_sweep_reports_failures_and_retries(tmp_path, capsys):
    flag = tmp_path / "flag"
    toggle = (f"import os,sys; p=r'{flag}'; "
              "sys.exit(0) if os.path.exists(p) else "
              "(open(p,'w').close(), sys.exit(3))")
    res = sweep.run_sweep(
        [[sys.executable, "-c", toggle],
         [sys.executable, "-c", "import sys; sys.exit(2)"]],
        workers=1, device="cpu", retries=1, labels=["a", "b"],
        log_dir=str(tmp_path / "logs"))
    assert res == {"a": 0, "b": 2}
    out = capsys.readouterr().out
    assert "a: rc=3" in out and "a: rc=0" in out and "b: rc=2" in out
    assert sorted(os.listdir(tmp_path / "logs")) == ["a.log", "b.log"]


def test_audit_windows_reports_clip_rate(tmp_path, capsys):
    for ts, clip in ((1, 0.0), (2, 0.05)):
        os.makedirs(tmp_path / f"TS{ts}")
        with open(tmp_path / f"TS{ts}" / "optvar_stage1.pkl", "wb") as f:
            pickle.dump({"raster_window": 128, "window_clip_rate": clip}, f)
    sweep.audit_windows(str(tmp_path), [1, 2, 3])
    assert capsys.readouterr().out.splitlines() == [
        "TS1: raster_window=128 clip_rate=0.00%",
        "TS2: raster_window=128 clip_rate=5.00% !"]


@pytest.fixture(scope="module")
def degraded_tree(tmp_path_factory):
    """The sweep's layout for one degraded tree (TS5's combined plan:
    stale frames) with a 2-cycle CPU fit: <workdir>/predict.yml,
    <workdir>/out/TS5."""
    from mhmocap_tpu_torch import sweep as tiers
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    work = tmp_path_factory.mktemp("decompose")
    body = make_synthetic_smpl(num_vertices=512)
    generate_sequence(str(work / "data" / "TS5"), num_frames=12,
                      num_people=3, image_size=(64, 64), model=body,
                      seed=12, mupots_gt=True,
                      degradations=tiers.degradation_plan(5, 12))
    cfg = tiers.write_config(str(work / "predict.yml"), tiers.sweep_config(
        str(work / "data"), 2, raster_window=32))
    mp = pytest.MonkeyPatch()
    mp.setenv("MHMOCAP_SYNTHETIC_SMPL", "512")
    try:
        predict_mupots.main(["--configs_yml", cfg, "--ts_id", "5",
                             "--output_path", str(work / "out"),
                             "--device", "cpu"])
    finally:
        mp.undo()
    return work


@pytest.mark.parametrize("record", ["recorded", "re-ingested"])
def test_decompose_jitter_end_to_end(degraded_tree, tmp_path, monkeypatch,
                                     capsys, record):
    """On the degraded tree: the stale mask from the pickle, or from a
    re-ingest when the pickle lacks it (a copy of the output without the
    record); the same decomposition."""
    import shutil
    monkeypatch.setenv("MHMOCAP_SYNTHETIC_SMPL", "512")
    with open(degraded_tree / "out" / "TS5" / "optvar_stage1.pkl",
              "rb") as f:
        optvar = pickle.load(f)
    assert optvar["lagged_tn"].any()
    work = degraded_tree
    if record == "re-ingested":
        work = tmp_path / "work"
        shutil.copytree(degraded_tree / "out", work / "out")
        shutil.copy(degraded_tree / "predict.yml", work / "predict.yml")
        with open(work / "out" / "TS5" / "optvar_stage1.pkl", "wb") as f:
            pickle.dump({k: v for k, v in optvar.items()
                         if k != "lagged_tn"}, f)
    res = decompose_jitter.main(["--workdir", str(work), "--ts", "5",
                                 "--top", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == res
    frames = sum(c["frames"] for c in res["per_class"].values())
    assert frames == 12 and res["per_class"]["gap"]["frames"] > 0
    cls = decompose_jitter.classify_frames(optvar["lagged_tn"].astype(bool))
    assert res["per_class"]["gap"]["frames"] == int((cls == 1).sum())
    assert len(res["top"]) == 4
    assert all(np.isfinite(t[1]) for t in res["top"])


def test_bench_e2e_end_to_end(monkeypatch, capsys):
    """The workload's whole path at a tiny size (4 frames, 2 people, 2
    cycles, a 512-vertex body) on the CPU: the same lines as the JAX
    script."""
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    monkeypatch.setattr(bench_e2e, "make_synthetic_smpl",
                        lambda: make_synthetic_smpl(num_vertices=512))
    pred, res = bench_e2e.main(["--frames", "4", "--people", "2",
                                "--cycles", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "e2e: T=4 N=2 window=" in out and "TOTAL" in out
    assert "e2e: loss first/last" in out and "e2e: set-up: init solve" in out
    assert len(res["stage1_log"]) == 2 and pred.device.type == "cpu"
    assert np.isfinite(res["stage1_optvar"]["poses_T"]).all()

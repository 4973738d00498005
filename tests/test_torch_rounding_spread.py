"""`python -m mhmocap_tpu_torch.rounding_spread` on the CPU: the one-ulp
perturbation of the init params, and the tool end to end on a tiny tree
with the plain raster (its kernel variants need the card)."""

import os
import pickle

import numpy as np
import pytest
import torch

from mhmocap_tpu_torch import predict_mupots, rounding_spread as RS, sweep
from mhmocap_tpu_torch.engine import optimizer as E
from mhmocap_tpu_torch.engine.predictor import Predictor
from mhmocap_tpu_torch.ops import raster_cuda as RC


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(8, 3, 1, 3), (8, 3, 72), (1, 3, 10), (8, 1, 1), (8, 1, 1),
              (1, 3, 1, 1)]
    return E.StageParams(*[torch.randn(s, generator=g) for s in shapes])


def test_perturb_ulp_moves_every_entry_one_ulp():
    """Each entry moves to its float32 neighbour, up or down as the seeded
    CPU generator draws; the same seed draws the same directions, and
    another seed others."""
    p = _params()
    a, b, c = (RS.perturb_ulp(p, s) for s in (0, 0, 1))
    ups = []
    for x, y, z, w in zip(p, a, b, c):
        x, y = x.numpy(), y.numpy()
        up = y > x
        want = np.nextafter(x, np.where(up, np.float32(np.inf),
                                        np.float32(-np.inf)))
        np.testing.assert_array_equal(y, want)
        assert (y != x).all()
        np.testing.assert_array_equal(y, z.numpy())
        ups.append(up.ravel())
    ups = np.concatenate(ups)
    assert 0.4 < ups.mean() < 0.6
    assert any(not torch.equal(y, w) for y, w in zip(a, c))


def test_trees_are_the_sweeps_and_the_smokes():
    """ts3 is the degraded sweep's TS3 (its plan and seed 7 + 3, 3
    people) under the robust tier's knobs; entry1 is chip_smoke.py phase
    6's TS1 (seed 8, 3 people, post_process_depth on)."""
    ts, people, seed, deg, knobs = RS.TREES["ts3"]
    assert (ts, people, seed, deg) == (3, 3, 10, "degraded")
    assert knobs == dict(gap_aware_temporal=True, id_swap_fix=0.5)
    assert sweep.degradation_plan(3, 60) == {"romp_person_dropout": 0.2,
                                             "romp_missing_frames": 0.1}
    assert RS.TREES["entry1"] == (1, 3, 8, None,
                                  dict(post_process_depth=True))


def test_rounding_spread_on_the_cpu(tmp_path, monkeypatch, capsys):
    """A tiny ts3 tree (4 frames, 64x64, 512 vertices, 2 cycles) with the
    plain raster: one line per run and the summaries; both runs write the
    same init-solve pickle and the perturbed one's fit ends elsewhere; the
    swapped Predictor and raster library are restored. The prediction
    and the evaluation resolve the same 512-vertex body as the writer."""
    monkeypatch.setenv("MHMOCAP_SYNTHETIC_SMPL", "512")
    for name, value in (("FRAMES", 4), ("SIDE", 64), ("NUM_VERTICES", 512),
                        ("NUM_ITER", 2)):
        monkeypatch.setattr(RS, name, value)
    library = RC._library
    out = tmp_path / "lines.txt"
    results = RS.main(["--trees", "ts3", "--variants", "kernel", "--seeds",
                       "0", "--device", "cpu", "--workdir", str(tmp_path),
                       "--out", str(out)])
    assert predict_mupots.Predictor is Predictor and RC._library is library
    rows = results["ts3"]["kernel"]
    assert len(rows) == 2 and np.isfinite(rows).all()
    lines = out.read_text().splitlines()
    assert [ln.split()[:4] for ln in lines[:2]] == [
        ["ts3", "kernel", "seed", "None"], ["ts3", "kernel", "seed", "0"]]
    assert lines[2].startswith("ts3 kernel    min/median/max  pck_rel")
    assert lines[3].startswith("ts3 all       min/median/max  pck_rel")
    assert capsys.readouterr().out.splitlines()[-4:] == lines

    def optvar(seed, name):
        with open(tmp_path / "ts3" / "out" / f"kernel_{seed}" / "TS3"
                  / name, "rb") as f:
            return pickle.load(f)

    init = optvar(0, "optvar_init.pkl")
    for k, v in optvar(None, "optvar_init.pkl").items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(init[k], v, err_msg=k)
    assert not np.array_equal(optvar(0, "optvar_stage1.pkl")["poses_smpl"],
                              optvar(None, "optvar_stage1.pkl")["poses_smpl"])


def test_one_group_needs_the_card(tmp_path):
    with pytest.raises(SystemExit):
        RS.main(["--variants", "kernel", "one_group", "--device", "cpu",
                 "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)

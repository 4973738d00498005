"""CPU tests of the cell `ts11-fit` (MuPoTs-3D TS11, outdoor: three
people over 701 frames of 240x135).

    python -m pytest portbench/tests/test_ts11_fit.py -q -p no:cacheprovider

The cell is data: a configuration, a traffic mix and limits, found by
name. These tests hold its layout at the full size (the windows and
chunk the traffic is chosen for) and run its files at a tiny size,
sound and with each fault.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench.generate import generate
from test_portbench_harness import _judge_controls, _plant

ROOT = Path(H.__file__).resolve().parents[1]
CELL = "ts11-fit"
# TS11 at the full size: the windows and the frame chunk
WINDOWS, CHUNK = (112, 80, 64), 39
# the least distance, in px, of each person's window need from either
# end of its 16 px step
MARGIN = 4.0
SEEDS = [1, 7, 31337, 99999, 2 ** 31 + 11, 3200000101, 4294967311,
         2 ** 32 + 2 ** 31 + 5]


def test_the_cell_finds_its_configuration_traffic_and_limits():
    cell = H.load_cell(CELL, ROOT)
    cfg = cell.config
    assert cell.chips == 1
    assert (cfg["name"], cell.traffic["name"]) == ("mupots-ts11",
                                                   "outdoor-fit")
    assert (cfg["frames"], cfg["people"]) == (701, 3)
    assert cfg["image_size"] == [round(s * cfg["resize_factor"])
                                 for s in cfg["source_frame_size"]]
    assert cfg["image_size"] == [240, 135]
    assert len(cell.traffic["depth_m"]) == len(cell.traffic["x_m"]) == 3
    assert set(cell.limits) == set(H.load_cell("ts1-fit", ROOT).limits)
    assert cell.limits["layout"] == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_full_size_windows_and_chunk_sit_mid_step(seed):
    """At 240x135, T=701, N=3 each person's window need (the 99th
    percentile of 1.3x its keypoints' extent) lies at least MARGIN px
    inside its 16 px step, so no seed flips a window."""
    cell = H.load_cell(CELL, ROOT)
    cfg = cell.config
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        inputs, _ = generate(cfg, cell.traffic, seed, "cpu")
    finally:
        torch.set_num_threads(threads)
    lay = H._layout(cell, inputs)
    assert (lay.windows, lay.chunk, lay.num_chunks) == (WINDOWS, CHUNK, 18)
    pose2d = inputs["pose2d"]
    assert (pose2d[..., 2] > cfg["joint_confidence_thr"]).all()
    uv = pose2d[..., :2]
    extent = (uv.max(axis=2) - uv.min(axis=2)).max(axis=-1)
    for n, win in enumerate(WINDOWS):
        need = float(np.percentile(1.3 * extent[:, n], 99))
        assert win - 16 + MARGIN <= need <= win - MARGIN, (n, need)


def tiny_cell() -> H.Cell:
    """ts11-fit's files at a size the CPU runs in seconds: 6 frames of
    64x36 (16:9), its three people, a 256-vertex body."""
    cell = H.load_cell(CELL, ROOT)
    cfg = dict(cell.config, frames=6, image_size=[64, 36], raster_window=48,
               body=dict(num_vertices=256, seed=0))
    return cell._replace(name="tiny-ts11", config=cfg)


@pytest.mark.parametrize("fault", ["sound", "frozen", "halfbatch", "altered"])
def test_tiny_ts11_run_is_correct_and_each_fault_fails_its_limits(
        monkeypatch, fault):
    torch.set_num_threads(4)
    if fault != "sound":
        _plant(monkeypatch, fault)
    cell = tiny_cell()
    out = H.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu", time.time(),
                     log=lambda *a: None)
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert out["checks"]["layout"]["value"] == 0.0
    assert {k: row["limit"] for k, row in out["checks"].items()} == {
        k: v for k, v in cell.limits.items() if k != "steps"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_tiny_ts11_controls_fail_its_limits():
    """The controls the harness builds, judged by ts11-fit's limits; TF32
    is left to the card's test."""
    torch.set_num_threads(4)
    cell = tiny_cell()
    out = H.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu", time.time(),
                     controls=True, log=lambda *a: None)
    _judge_controls(cell, out, ("halfbatch", "altered", "frozen"))


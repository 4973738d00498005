"""Whole-trajectory parity with mhmocap_tpu on a clean tree with
post_process_depth on, as chip_smoke.py phase 6 runs its entry TS1: the
tests of tests/torch_trajectory.py (see tests/test_torch_trajectory.py
for the degraded TS3 tree), one tree a file so that two workers run
them side by side."""

import pytest

from torch_trajectory import (  # noqa: F401  (collected here)
    run_tree, test_aux_round_trip, test_drift_per_cycle,
    test_final_metrics_match, test_opt_state_round_trip,
    test_raster_matches_uncompiled_jax, test_refreshes_are_live,
    test_teacher_forced_cycle_matches,
    test_whole_loss_matches_uncompiled_jax)


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    return run_tree("entry1", tmp_path_factory.mktemp("entry1"))

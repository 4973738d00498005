"""Whole-trajectory parity with mhmocap_tpu on the degraded sweep's TS3
plan under the robust tier's knobs: 16 fused cycles in both packages,
teacher-forced cycles, the raster against JAX's uncompiled ops and the
final accuracy (tests/torch_trajectory.py holds the runs and the
tests; tests/test_torch_trajectory_entry.py runs them on the entry
tree)."""

import pytest

from torch_trajectory import (  # noqa: F401  (collected here)
    run_tree, test_aux_round_trip, test_drift_per_cycle,
    test_final_metrics_match, test_opt_state_round_trip,
    test_raster_matches_uncompiled_jax, test_refreshes_are_live,
    test_teacher_forced_cycle_matches,
    test_whole_loss_matches_uncompiled_jax)


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    return run_tree("ts3", tmp_path_factory.mktemp("ts3"))

"""Tracked positions (``loop_collision_freeze_positions=False``, the CLI's
``--loop_collision_track_positions``): the nearest-face selection is frozen
per superblock (the ``idx`` payload) while the selected faces' positions
are taken from the current mesh at every step (``pair_depths_at``). Held
to the JAX package's ``optimize_batch`` on the same inputs (harness, inputs
and bounds: tests/torch_port_modes.py)."""

from tests.torch_port_modes import check_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_tracked_positions_match_jax():
    check_against_jax("tracked positions", dict(save_mid_freq=2, loop_collision_freeze_positions=False))

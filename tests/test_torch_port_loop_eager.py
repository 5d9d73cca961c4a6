"""Per-step face reselection (``loop_collision_lazy_reselect=False``, the
CLI's ``--loop_collision_eager_reselect``): every step selects each stride-2
query's nearest face again and takes its depth, JAX's K=1 ``"xla"`` path
through ``collision_loss``. Held to the JAX package's ``optimize_batch`` on
the same inputs (harness, inputs and bounds: tests/torch_port_modes.py)."""

from tests.torch_port_modes import check_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_eager_reselection_matches_jax():
    check_against_jax("eager reselection", dict(save_mid_freq=2, loop_collision_lazy_reselect=False))

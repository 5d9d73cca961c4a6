"""Parity-alternating queries (``loop_collision_alternate`` at stride 2):
even vertices on even steps, odd on odd, with one frozen payload per parity
built at each superblock. Held to the JAX package's ``optimize_batch`` on
the same inputs (harness, inputs and bounds: tests/torch_port_modes.py)."""

from tests.torch_port_modes import check_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_alternating_queries_match_jax():
    check_against_jax("alternating queries", dict(save_mid_freq=2, loop_collision_alternate=True))

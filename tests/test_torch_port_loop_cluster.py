"""The 2-level in-loop hierarchy (``OptConfig.loop_collision_cluster=8``):
every step selects each stride-2 query's face through two levels of
Morton-adjacent face clusters of the stride-2 face set
(``collision_loss(backend="2level")``), no block payload. Held to the JAX
package's ``optimize_batch`` on the same inputs (harness, inputs and bounds:
tests/torch_port_modes.py)."""

import pytest

from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import opt_engine as TE
from ihmr_tpu_torch.refine import schedule as TS
from tests.torch_port_modes import check_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_two_level_hierarchy_in_the_loop_matches_jax():
    check_against_jax("2-level hierarchy", dict(save_mid_freq=2, loop_collision_cluster=8))


def test_two_level_backend_without_a_cluster_fails_before_any_step(monkeypatch):
    """``collision_backend="2level"`` with the default cluster of 0 constructs,
    as JAX's does, but ``optimize_batch`` refuses it before the first step
    (JAX fails only in its final pass, dividing by the group of 0)."""
    config = TE.OptConfig(collision_backend="2level")
    assert config.loop_collision_cluster == 0
    model = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(model, batch=1, seed=0)
    monkeypatch.setattr(TE, "run_stage", lambda *a, **k: pytest.fail("a stage ran"))
    with pytest.raises(ValueError, match="loop_collision_cluster > 0"):
        TE.optimize_batch(model, params, batch, TS.opt_default, config)

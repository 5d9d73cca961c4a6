"""JAX's per-stage programs with SGD (``optimizer="sgd"``,
``stage_hoist_decode=False``; ``run_stage_program`` in the port): the full
decode and a fresh face selection at every step, step 0 setting the origin
losses and bars, a snapshot at each j % save_mid_freq == 0 for j in
1..epoch, optax's momentum SGD. ``opt_default``'s trans, orient and shape
stages at epoch 7. Held to the JAX package's ``optimize_batch`` on the same
inputs (harness, inputs and bounds: tests/torch_port_modes.py), and apart
from the port's hoisted SGD engine (whose payload is block-frozen)."""

from tests.torch_port_modes import check_against_jax, inputs, param_gap, run_port, strategies
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_sgd_per_stage_programs_match_jax():
    config = dict(save_mid_freq=2, optimizer="sgd", stage_hoist_decode=False)
    out, _ = check_against_jax("SGD per-stage programs", config, stages=(0, 1, 3), must_differ_from_default=False)
    _, torch_inputs = inputs()
    hoisted, _ = run_port(torch_inputs, strategies((0, 1, 3))[1], save_mid_freq=2, optimizer="sgd")
    apart = param_gap({k: v.numpy() for k, v in out.items()}, {k: v.numpy() for k, v in hoisted.items()})
    print(f"SGD per-stage programs: {apart:.3g} from the hoisted SGD engine")
    assert apart > 1e-3

"""JAX's per-stage programs for ``opt_with_cam`` without the hoist (Adam,
``stage_hoist_decode=False``: its stages differ in epoch and filter, so
JAX's fused engine does not take it): the port's ``run_stage_program`` on
all five stages cut to epoch 5. Held to the JAX package's
``optimize_batch`` on the same inputs (harness, inputs and bounds:
tests/torch_port_modes.py), and apart from the port's hoisted engine."""

from tests.torch_port_modes import check_against_jax, inputs, param_gap, run_port, strategies
from tests.torch_threads import one_torch_thread  # noqa: F401

STAGES = (0, 1, 2, 3, 4)


def test_opt_with_cam_per_stage_programs_match_jax():
    config = dict(save_mid_freq=2, stage_hoist_decode=False)
    out, _ = check_against_jax("opt_with_cam per-stage programs", config, stages=STAGES, epoch=5,
                               name="opt_with_cam", must_differ_from_default=False)
    _, torch_inputs = inputs()
    hoisted, _ = run_port(torch_inputs, strategies(STAGES, 5, "opt_with_cam")[1], save_mid_freq=2)
    apart = param_gap({k: v.numpy() for k, v in out.items()}, {k: v.numpy() for k, v in hoisted.items()})
    print(f"opt_with_cam per-stage programs: {apart:.3g} from the hoisted engine")
    assert apart > 1e-3

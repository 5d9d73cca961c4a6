"""JAX's fused engine (``stage_hoist_decode=False``, Adam, stages sharing
epoch, filter and select losses) on a strategy where one stage weighs
collision 0 and another does not: JAX traces the per-stage weights, so its
weight-0 stage still computes collision, whose unweighted per-sample values
enter the -10% collision filter, and still builds the block payloads; only
a strategy where every stage weighs collision 0 skips it. The port's
full-decode block engine does the same (``run_stage(...,
skip_zero_collision=False)``); skipping the weight-0 stage, as the hoisted
engine rightly does, ends 0.119 away from JAX here. ``opt_default``'s
orient stage at epoch 7 with collision weight 0, then the same stage with
its weights. Held to the JAX package's ``optimize_batch`` on the same inputs
(harness, inputs and bounds: tests/torch_port_modes.py)."""

import dataclasses

from ihmr_tpu.refine import schedule as JS
from ihmr_tpu_torch.refine import schedule as TS
from tests.torch_port_modes import PARAM_BOUND, inputs, param_gap, run_jax, run_port
from tests.torch_threads import one_torch_thread  # noqa: F401


def _strategy(pkg):
    stage = pkg.opt_default[1]
    weights = tuple((k, 0.0 if k == "collision_loss_weight" else w) for k, w in stage.loss_weights)
    return dataclasses.replace(stage, epoch=7, loss_weights=weights), dataclasses.replace(stage, epoch=7)


def test_fused_engine_keeps_collision_in_a_weight_zero_stage():
    jax_inputs, torch_inputs = inputs()
    config = dict(save_mid_freq=2, stage_hoist_decode=False)
    jout, _ = run_jax(jax_inputs, _strategy(JS), **config)
    out, _ = run_port(torch_inputs, _strategy(TS), **config)
    gap = param_gap({k: v.numpy() for k, v in out.items()}, jout)
    print(f"fused engine, mixed collision weights: params {gap:.3g} from JAX")
    assert gap <= PARAM_BOUND

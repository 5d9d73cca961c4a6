"""``OptConfig(optimizer="sgd")``: the port's hoisted engine against the JAX
package's (``run_all_stages_hoisted``, what its ``optimize_batch`` runs
by default) on the same inputs.

SGD with momentum 0.9 and no dampening (buf = 0.9 buf + g, p -= lr buf, the
first step buf = g). The strategy is ``opt_default``'s trans, orient and
shape stages at epoch 19 (20 steps: one superblock of two snapshot blocks
with one payload), B=2, ``save_mid_freq=10``; the stages are compared
without the final pass, whose code SGD does not change. That keeps JAX's
compile near 30 s on one core (a one-step tail block, or the final pass's
exact kernel in interpret mode, would double it). Bound: final params
within 2e-4 absolute, as the OPT slice test holds the Adam engine
(tests/test_torch_port_opt.py).
"""

import dataclasses

import jax
import numpy as np
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import schedule as JS
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import SGD, OptBatch, OptConfig, opt_default, run_stage
from tests.torch_threads import one_torch_thread  # noqa: F401

B, EPOCH, STAGES = 2, 19, (0, 1, 3)


def T(x):
    return torch.tensor(np.asarray(x))


def _short(strategy):
    return tuple(dataclasses.replace(strategy[i], epoch=EPOCH) for i in STAGES)


def test_sgd_matches_jax():
    jm = jax_synthetic()
    jp, jb = jax_make_opt_inputs(jm, batch=B, seed=0)
    cfg = JE.OptConfig(save_mid_freq=10, optimizer="sgd")
    strategy = _short(JS.opt_default)
    jout = jax.jit(lambda p, b: JE.run_all_stages_hoisted(jm, p, b, strategy, cfg))(jp, jb)
    tb = OptBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(OptBatch)})
    tp = {k: T(v) for k, v in jp.items()}
    out = tp
    for stage in _short(opt_default):
        out = run_stage(synthetic_mano_model(device="cpu"), out, tb, stage, OptConfig(save_mid_freq=10, optimizer="sgd"))
    for k in jout:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=2e-4, err_msg=k)
    moved = max(float((out[k] - tp[k]).abs().max()) for k in ("trans", "right_orient", "left_shape"))
    assert moved > 1e-3  # SGD moved the stages' groups


def test_sgd_step_is_momentum_sgd():
    p = {"x": torch.tensor([1.0, -2.0])}
    g1, g2 = torch.tensor([0.5, 0.25]), torch.tensor([-1.0, 2.0])
    opt = SGD(p)
    p1 = opt.step(p, {"x": g1}, 0.1)
    p2 = opt.step(p1, {"x": g2}, 0.1)
    torch.testing.assert_close(p1["x"], p["x"] - 0.1 * g1)
    torch.testing.assert_close(p2["x"], p1["x"] - 0.1 * (0.9 * g1 + g2))

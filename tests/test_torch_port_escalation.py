"""Two-pass grid escalation (``escalate_collision > 0``,
refine/escalation.py) against the JAX package's ``optimize_batch`` on the
same inputs: ``make_opt_inputs(variant="interlocked", batch=4, seed=2)``,
``opt_default``'s orient stage at epoch 4, ``save_mid_freq=2``, the
defaults otherwise (warm start 0.5, the fast K=1 build on a focused res-24
lattice over every second face). Pass 1 leaves one sample in collision
(0.6617) and three at 0; at the threshold 1e-6 the first is flagged,
padded to a bucket of 4 (min(8, B)) with itself, and pass 2 lowers its
exact collision (to 0.5174), so the keep-best merge takes it. (JAX's own
escalation test case, B=2 seed 1, flags a sample that pass 2 does not
improve.) JAX runs under ``jax_tpu_branch``: "auto" is the exact kernel.

Bounds: the ``escalated`` masks equal; the merged params within 2e-4
(tests/torch_port_modes.py); the final collision within 1e-3 relative; no
sample's exact collision above pass 1's; the unflagged samples' params
equal to pass 1's bit for bit. A threshold above every residual runs no
pass 2 and returns pass 1's bits."""

import numpy as np
import pytest

from tests.torch_port_modes import PARAM_BOUND, inputs, param_gap, run_jax, run_port, strategies
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = dict(save_mid_freq=2)
STAGES, EPOCH = (1,), 4


@pytest.fixture(scope="module")
def runs():
    jax_inputs, torch_inputs = inputs(batch=4, seed=2)
    jstrat, tstrat = strategies(STAGES, EPOCH)
    return jax_inputs, torch_inputs, jstrat, tstrat, run_jax(jax_inputs, jstrat, **BASE), run_port(torch_inputs, tstrat, **BASE)


def _host(tree):
    return {k: v.numpy() for k, v in tree.items()}


def test_escalation_matches_jax(runs):
    jax_inputs, torch_inputs, jstrat, tstrat, (_, jres1), (p1, r1) = runs
    coll1 = r1["collision_loss"].numpy()
    threshold = max(float(np.median(jres1["collision_loss"])), 1e-6)
    jout, jres = run_jax(jax_inputs, jstrat, **BASE, escalate_collision=threshold)
    out, res = run_port(torch_inputs, tstrat, **BASE, escalate_collision=threshold)
    esc = res["escalated"].numpy()
    gap = param_gap(_host(out), jout)
    print(f"escalation: flagged {np.nonzero(coll1 > threshold)[0]}, escalated {esc} (JAX {jres['escalated']}); "
          f"params {gap:.3g} from JAX; collision {coll1} -> {res['collision_loss'].numpy()}")
    np.testing.assert_array_equal(esc, np.asarray(jres["escalated"]))
    assert esc.dtype == np.int32 and esc.any()  # the merge was exercised
    assert gap <= PARAM_BOUND
    np.testing.assert_allclose(res["collision_loss"].numpy(), jres["collision_loss"], rtol=1e-3, atol=1e-6)
    assert np.all(res["collision_loss"].numpy() <= coll1)
    kept = esc == 0
    for k in p1:
        np.testing.assert_array_equal(out[k].numpy()[kept], p1[k].numpy()[kept], err_msg=k)
    assert not np.array_equal(out["left_orient"].numpy()[~kept], p1["left_orient"].numpy()[~kept])


def test_threshold_above_every_residual_is_pass_one(runs):
    jax_inputs, torch_inputs, jstrat, tstrat, (jp1, _), (p1, r1) = runs
    jout, jres = run_jax(jax_inputs, jstrat, **BASE, escalate_collision=1e9)
    out, res = run_port(torch_inputs, tstrat, **BASE, escalate_collision=1e9)
    np.testing.assert_array_equal(res["escalated"].numpy(), np.zeros(4, np.int32))
    np.testing.assert_array_equal(jres["escalated"], np.zeros(4, np.int32))
    for k in p1:
        np.testing.assert_array_equal(out[k].numpy(), p1[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(res["collision_loss"].numpy(), r1["collision_loss"].numpy())
    assert param_gap(_host(out), jout) <= PARAM_BOUND and param_gap(_host(p1), jp1) <= PARAM_BOUND

"""Shared harness of the in-loop collision mode tests
(``tests/test_torch_port_loop_*.py``, ``tests/test_torch_port_programs_*.py``).

Each of those files runs ONE configuration of the JAX package's
``optimize_batch`` (one engine compile, so that xdist's loadfile spreads the
compiles over workers) and the port's on the same numpy inputs:
``make_opt_inputs(variant="interlocked", batch=2, seed=0)`` (B=2, the
family whose sparse deep contacts make each in-loop path change the
result), ``opt_default``'s orient stage cut to ``epoch`` with
``save_mid_freq=2``, as the JAX package's own grid test runs it
(tests/test_opt_engine.py::test_grid_in_loop_runs_hoisted). JAX runs under
``jax_tpu_branch`` (tests/test_torch_port_nearest.py): its "auto" backend
is then the exact kernel (interpret mode), the port's meaning of "auto", in
the final metric and, with ``loop_collision_fast=False``, in the loop.

Bound: the refined params within ``PARAM_BOUND`` = 2e-4 absolute, the
bound the port's engine tests hold (tests/test_torch_port_opt.py), and the
final per-sample collision within 1e-3 relative. The run must move the
params (by more than 1e-4), and where the path is a variant of the default
one, its result must lie more than 100x the port-JAX gap (and 1e-5) from
the port's default path, so that a test cannot pass on the default path.
Each test prints its measured gaps.
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
from ihmr_tpu_torch.refine import opt_engine as TE
from ihmr_tpu_torch.refine import schedule as TS
from tests.test_torch_port_nearest import jax_tpu_branch

B, SEED, VARIANT = 2, 0, "interlocked"
PARAM_BOUND = 2e-4
COLLISION_RTOL = 1e-3


def T(x):
    return torch.tensor(np.asarray(x))


def inputs(batch=B, seed=SEED, variant=VARIANT):
    """(JAX model, params, OptBatch), (port model, params, OptBatch): the JAX
    package's arrays, the port's as torch copies of them."""
    jm = jax_synthetic()
    jp, jb = jax_make_opt_inputs(jm, batch=batch, seed=seed, variant=variant)
    tb = TE.OptBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(TE.OptBatch)})
    return (jm, jp, jb), (synthetic_mano_model(device="cpu"), {k: T(v) for k, v in jp.items()}, tb)


def strategies(stages=(1,), epoch=7, name="opt_default"):
    """The JAX and port strategies: the named schedule's ``stages``, each cut
    to ``epoch``."""
    return tuple(
        tuple(dataclasses.replace(pkg.strategies[name][i], epoch=epoch) for i in stages) for pkg in (JS, TS)
    )


def run_jax(jax_inputs, strategy, **config):
    jm, jp, jb = jax_inputs
    with jax_tpu_branch():
        out, res = JE.optimize_batch(jm, jp, jb, strategy, JE.OptConfig(**config))
    return jax.tree_util.tree_map(np.asarray, (out, res))


def run_port(torch_inputs, strategy, **config):
    tm, tp, tb = torch_inputs
    return TE.optimize_batch(tm, tp, tb, strategy, TE.OptConfig(**config))


def param_gap(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in b)


def check_against_jax(label, config, stages=(1,), epoch=7, name="opt_default", must_differ_from_default=True):
    """Run both packages on ``config`` and hold the port to JAX; with
    ``must_differ_from_default`` also check that the path changed the port's
    result against its default config (so the test cannot pass on the
    default path). Returns the port's (params, results)."""
    jax_inputs, torch_inputs = inputs()
    jstrat, tstrat = strategies(stages, epoch, name)
    jout, jres = run_jax(jax_inputs, jstrat, **config)
    out, res = run_port(torch_inputs, tstrat, **config)
    gap = param_gap({k: v.numpy() for k, v in out.items()}, jout)
    coll, jcoll = res["collision_loss"].numpy(), jres["collision_loss"]
    moved = param_gap({k: v.numpy() for k, v in out.items()}, {k: v.numpy() for k, v in torch_inputs[1].items()})
    print(f"{label}: params {gap:.3g} from JAX (bound {PARAM_BOUND}), moved {moved:.3g}; "
          f"final collision {coll} (JAX {jcoll})")
    assert gap <= PARAM_BOUND, (label, gap)
    np.testing.assert_allclose(coll, jcoll, rtol=COLLISION_RTOL, atol=1e-6)
    assert moved > 1e-4  # the stages moved the params
    if must_differ_from_default:
        default_out, _ = run_port(torch_inputs, tstrat, save_mid_freq=config.get("save_mid_freq", 10))
        apart = param_gap({k: v.numpy() for k, v in out.items()}, {k: v.numpy() for k, v in default_out.items()})
        print(f"{label}: {apart:.3g} from the default path's params")
        assert apart > max(100 * gap, 1e-5), (label, apart)
    return out, res

"""``ihmr_tpu_torch/parallel/mesh.py`` against ``ihmr_tpu/parallel/mesh.py``,
and the port's sharded IHMR-OPT against the JAX package's, on 8 devices of
the CPU (JAX's virtual mesh of ``tests/conftest.py``; the port's
``make_mesh(["cpu"] * 8)``).

The sharded OPT has the inputs of ``tests/test_parallel.py::
test_sharded_opt_matches_single_device``: ``make_opt_inputs(batch=8,
seed=1)``, ``opt_default``'s first two stages at epoch 6,
``OptConfig(save_mid_freq=2, num_candidates=4)``. JAX's final pass takes
``collision_backend="pallas"`` (the exact kernel, in interpret mode), the
port's default: on the CPU JAX's "auto" is the K-candidate depth, which the
port runs only where asked. Every key of the results, the batch scalars
included, within 1e-5 (the JAX test's bound between its sharded and
one-device runs; measured 3.3e-6, on ``total_loss``); JAX compiles once
for the module (~26 s on one core). Under SGD, whose step scales with the
gradient, the sharded run is held to the port's one-device run within
1e-5 (measured: the same bits), and a shard that took its own batch mean
as the loss (``opt_engine._global_mean`` undone) misses it by 0.35.
Escalation (two passes, SGD) over 4 shards is held to the one-device run
too: the same samples escalate, and the same params come out.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.parallel import gather_to_host as jax_gather_to_host
from ihmr_tpu.parallel import make_mesh as jax_make_mesh
from ihmr_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from ihmr_tpu.parallel import replicate as jax_replicate
from ihmr_tpu.parallel import shard_batch as jax_shard_batch
from ihmr_tpu.refine import OptConfig as JaxOptConfig
from ihmr_tpu.refine import opt_default as jax_opt_default
from ihmr_tpu.refine import optimize_batch as jax_optimize_batch
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.parallel import (
    batch_sharding,
    gather_to_host,
    make_mesh,
    mesh as M,
    pad_to_multiple,
    replicate,
    replicated,
    shard_batch,
)
from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch
from ihmr_tpu_torch.refine import opt_engine as TE
from tests.torch_threads import one_torch_thread  # noqa: F401

SHARDS = 8
OPT_TOL = 1e-5
BATCH_SCALARS = ("total_loss", "joints_2d_loss", "joints_3d_loss", "hand_trans_loss")


def _cpu_mesh(n=SHARDS):
    return make_mesh([torch.device("cpu")] * n)


def _strategy(stages):
    return tuple(dataclasses.replace(s, epoch=6) for s in stages)


# ---------------------------------------------------------------------------
# the module's helpers


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_pad_to_multiple_matches_jax(m):
    for n in range(0, 20):
        assert pad_to_multiple(n, m) == jax_pad_to_multiple(n, m), (n, m)


def test_make_mesh_needs_a_card_or_explicit_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    mesh = _cpu_mesh()
    assert mesh.size == SHARDS and mesh.axis == "data"
    assert batch_sharding(mesh).mesh is mesh and replicated(mesh).mesh is mesh


def test_shard_batch_places_contiguous_shards_in_device_order():
    mesh = _cpu_mesh()
    model = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(model, batch=16, seed=0)
    sharded = shard_batch(batch, mesh)
    assert sharded.mesh is mesh and len(sharded.parts) == SHARDS
    assert sharded.rows() == [2] * SHARDS
    for k, part in enumerate(sharded.parts):
        assert type(part) is type(batch)
        for f in dataclasses.fields(batch):
            torch.testing.assert_close(getattr(part, f.name), getattr(batch, f.name)[2 * k:2 * k + 2], rtol=0, atol=0)
            assert getattr(part, f.name).device == mesh.devices[k]
    parts = shard_batch(params, mesh).parts
    assert [float(p["trans"][0, 0]) for p in parts] == [float(params["trans"][2 * k, 0]) for k in range(SHARDS)]


def test_shard_batch_rejects_an_indivisible_leading_dimension():
    mesh = _cpu_mesh()
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        shard_batch({"x": torch.zeros(12, 3)}, mesh)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        shard_batch({"x": torch.zeros(())}, mesh)
    n = 12
    padded = shard_batch({"x": torch.zeros(n + pad_to_multiple(n, SHARDS), 3)}, mesh)
    assert padded.rows() == [2] * SHARDS


def test_gather_to_host_returns_the_batch_bit_for_bit():
    mesh = _cpu_mesh()
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(16, 5, generator=gen), "b": (torch.randint(0, 9, (8,), generator=gen),)}
    back = gather_to_host(shard_batch(tree, mesh))
    assert back["a"].tobytes() == tree["a"].numpy().tobytes()
    assert back["b"][0].tobytes() == tree["b"][0].numpy().tobytes()
    model = synthetic_mano_model(device="cpu")
    rep = replicate(model, mesh)
    assert len(rep.copies) == SHARDS and rep.primary is model
    np.testing.assert_array_equal(gather_to_host(rep).v_template, model.v_template.numpy())


def test_replicate_gives_each_shard_a_module_without_weights():
    mesh = _cpu_mesh(2)
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    rep = replicate({"model": model}, mesh)
    assert rep.primary["model"] is model
    copies = [c["model"] for c in rep.copies]
    assert copies[0] is not copies[1] and all(c is not model for c in copies)
    assert {t.device.type for c in copies for t in (*c.parameters(), *c.buffers())} == {"meta"}
    assert all(p.requires_grad for c in copies for p in c.parameters())
    assert next(model.parameters()).device.type == "cpu"
    x = torch.randn(5, 3, generator=gen)
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    want = model.eval()(x)
    got = torch.func.functional_call(copies[0].eval(), tensors, (x,))
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="meta"):
        copies[1].eval()(x)


def test_mesh_reads_give_each_shard_a_view_whose_gradient_reaches_the_tensor():
    mesh = _cpu_mesh(3)
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    reads = mesh.reads({"w": w})
    views = [r["w"] for r in reads]
    assert all(v is not w and v._base is w for v in views) and len({id(v) for v in views}) == 3
    (g,) = torch.autograd.grad(sum((k + 1) * v.sum() for k, v in enumerate(views)), [w])
    assert g.tolist() == [6.0, 6.0]


# ---------------------------------------------------------------------------
# the shard runner


def test_map_runs_each_shard_on_its_part_and_thread():
    mesh = _cpu_mesh()
    x = shard_batch(torch.arange(16.0), mesh)
    rep = replicate({"w": torch.tensor(2.0)}, mesh)

    def fn(part, r, k0):
        shard = M.current_shard()
        return shard.index, shard.rows, shard.global_rows, threading.current_thread().name, float(part.sum() * r["w"]) + k0

    out = mesh.map(fn, x, rep, 100)
    assert [o[0] for o in out] == list(range(SHARDS))
    assert {o[1:3] for o in out} == {(2, 16)}
    assert len({o[3] for o in out}) == SHARDS
    assert [o[4] for o in out] == [2 * (4 * k + 1) + 100 for k in range(SHARDS)]
    assert M.current_shard() is None


def test_all_sum_is_shard_ordered_and_differentiable():
    mesh = _cpu_mesh(4)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0], requires_grad=True)

    def fn(k):
        shard = M.current_shard()
        (s, n) = shard.all_sum((x[shard.index] * (shard.index + 1), 1))
        return s * (shard.index + 1), n

    out = mesh.map(fn, 0)
    assert [int(n) for _, n in out] == [4] * 4
    total = sum(v for v, _ in out)  # (sum_k (k+1) x_k) * (1 + 2 + 3 + 4)
    assert float(total.detach()) == 30.0 * 10.0
    (g,) = torch.autograd.grad(total, [x])
    assert g.tolist() == [10.0, 20.0, 30.0, 40.0]


def test_all_gather_keeps_every_round_under_thread_switching():
    """More shards than cores and a short switch interval: every shard must
    see every other shard's value of the same round, round after round
    (a slot overwritten before a slower shard read it breaks this)."""
    mesh = _cpu_mesh(16)
    rounds = 200

    def fn(_):
        shard = M.current_shard()
        return [shard.all_gather((r, shard.index)) for r in range(rounds)]

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        out = mesh.map(fn, 0)
    finally:
        sys.setswitchinterval(saved)
    assert time.perf_counter() - t0 < 60
    for seen in out:
        assert seen == [[(r, k) for k in range(16)] for r in range(rounds)]


def test_a_failing_shard_fails_the_run_without_waiting():
    """Shard 3 raises before the collective the others wait in: they are
    released at once (the barrier is aborted), and map raises shard 3's
    error, not the others' broken barrier."""
    mesh = _cpu_mesh()

    def fn(_):
        shard = M.current_shard()
        if shard.index == 3:
            raise ValueError("shard 3 failed")
        return shard.all_gather(shard.index)

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 3 failed"):
        mesh.map(fn, 0)
    assert time.perf_counter() - t0 < 0.1 * M.BARRIER_TIMEOUT


def test_a_collective_no_shard_completes_times_out(monkeypatch):
    monkeypatch.setattr(M, "BARRIER_TIMEOUT", 0.5)
    mesh = _cpu_mesh(4)

    def fn(_):
        shard = M.current_shard()
        return None if shard.index == 0 else shard.all_gather(1)  # shard 0 never meets

    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        mesh.map(fn, 0)
    assert time.perf_counter() - t0 < 30


# ---------------------------------------------------------------------------
# sharded IHMR-OPT


@pytest.fixture(scope="module")
def opt_inputs():
    model = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(model, batch=SHARDS, seed=1)
    return model, params, batch


def _sharded(opt_inputs, config):
    model, params, batch = opt_inputs
    mesh = _cpu_mesh()
    out, results = optimize_batch(replicate(model, mesh), shard_batch(params, mesh), shard_batch(batch, mesh),
                                  _strategy(opt_default[:2]), config)
    assert out.mesh is mesh and results.mesh is mesh
    return gather_to_host(out), gather_to_host(results)


def test_sharded_opt_matches_jax_sharded_opt(opt_inputs):
    jm = jax_synthetic()
    jp, jb = jax_make_opt_inputs(jm, batch=SHARDS, seed=1)
    mesh = jax_make_mesh()
    with mesh:
        _, jr = jax_optimize_batch(
            jax_replicate(jm, mesh), jax_shard_batch(jp, mesh), jax_shard_batch(jb, mesh),
            _strategy(jax_opt_default[:2]), JaxOptConfig(save_mid_freq=2, num_candidates=4, collision_backend="pallas"),
        )
    ref = jax_gather_to_host(jr)
    _, ours = _sharded(opt_inputs, OptConfig(save_mid_freq=2, num_candidates=4))
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == np.shape(ref[k]), k
        np.testing.assert_allclose(ours[k], ref[k], atol=OPT_TOL, rtol=0, err_msg=k)
    assert all(np.ndim(ours[k]) == 0 for k in BATCH_SCALARS)
    assert float(ref["collision_loss"].max()) > 0  # the exact final pass sees a collision


def test_sharded_sgd_matches_one_device(opt_inputs):
    config = OptConfig(save_mid_freq=2, num_candidates=4, optimizer="sgd")
    model, params, batch = opt_inputs
    one, one_results = optimize_batch(model, params, batch, _strategy(opt_default[:2]), config)
    out, results = _sharded(opt_inputs, config)
    for k, v in one.items():
        np.testing.assert_allclose(out[k], v.numpy(), atol=OPT_TOL, rtol=0, err_msg=k)
    for k, v in one_results.items():
        np.testing.assert_allclose(results[k], v.numpy(), atol=OPT_TOL, rtol=0, err_msg=k)


def test_shard_mean_loss_misses_one_device_sgd(opt_inputs, monkeypatch):
    """Each shard optimising its own batch mean: SGD's steps 8x too long."""
    config = OptConfig(save_mid_freq=2, num_candidates=4, optimizer="sgd")
    model, params, batch = opt_inputs
    one, _ = optimize_batch(model, params, batch, _strategy(opt_default[:2]), config)
    monkeypatch.setattr(TE, "_global_mean", lambda total: total)
    out, _ = _sharded(opt_inputs, config)
    gap = max(float(np.abs(out[k] - v.numpy()).max()) for k, v in one.items())
    assert gap > 100 * OPT_TOL, gap


def test_sharded_escalation_matches_one_device():
    """The two-pass escalation (SGD; pipeline.SHORT_COLLISION_RUNS'
    escalation run: pass 1 leaves one of the 4 interlocked samples in
    collision) over 4 shards of one sample."""
    model = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(model, batch=4, seed=2, variant="interlocked")
    strategy = (dataclasses.replace(opt_default[1], epoch=4),)
    config = OptConfig(save_mid_freq=2, escalate_collision=1e-6, optimizer="sgd")
    one, one_results = optimize_batch(model, params, batch, strategy, config)
    mesh = _cpu_mesh(4)
    out, results = optimize_batch(model, shard_batch(params, mesh), shard_batch(batch, mesh), strategy, config)
    results = gather_to_host(results)
    assert int(one_results["escalated"].sum()) == 1
    np.testing.assert_array_equal(results["escalated"], one_results["escalated"].numpy())
    for k, v in gather_to_host(out).items():
        np.testing.assert_allclose(v, one[k].numpy(), atol=OPT_TOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the readings behind the card's data-parallel bounds


def test_dp_bounds_readings_on_the_cpu():
    """``python -m ihmr_tpu_torch.dp_bounds`` at its ResNet-18 size on the
    CPU: the DP step within ``pipeline.DP_TOL`` of the one-device step, its
    repeats and its deterministic runs the same bits (the CPU's sums are
    fixed), and the planted shard-local statistics far outside the bounds.
    The planted race needs the card's streams: on the CPU it only reorders
    some sums and stays within the bounds."""
    from ihmr_tpu_torch import dp_bounds
    from ihmr_tpu_torch.pipeline import DP_TOL, dp_within

    out = dp_bounds.study("resnet18", torch.device("cpu"), races=1)
    assert all(dp_within(g, DP_TOL) for g in out["dp"]), out["dp"]
    assert all(v == 0.0 for g in out["dp_repeat"] for v in g.values()), out["dp_repeat"]
    assert out["deterministic_bits"] == dict(one=0.0, dp=0.0)
    assert all(dp_within(g, DP_TOL) for g in out["race"]), out["race"]
    assert not dp_within(out["local"][0], DP_TOL) and out["local"][0]["grad_l2"] > 100 * DP_TOL["grad_l2"]

"""IHMR-Baseline training in the port against the JAX package: each module,
then the slice with flax's stock BatchNorm (the slice with the Pallas
BatchNorm statistics and the eval step are in
``tests/test_torch_port_train_kernels.py``, so that the two JAX compiles of
``train_step`` run on two test workers).

K3 (``ihmr_tpu/ops/pallas_bn.py``) runs on the JAX side as on the CPU it
always does, in Pallas interpret mode; the port's ``bn_stats`` takes its
plain version on CPU tensors (the CUDA kernel is held against that plain
version by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).

The slice: ResNet-18 at 64x64, B=4 (the batch of ``tests/test_train.py``),
``TrainConfig(lr=1e-4)``, the port starting from the JAX state's weights
(``encoder_from_jax``). JAX's jitted ``train_step`` runs twice per
BatchNorm variant: flax's stock BN against ``bn_impl="stock"``, and with
``ihmr_tpu.models.resnet._BN_IMPL`` patched to "pallas" (read at trace
time, so compiled programs are dropped on both sides of the patch) against
``bn_impl="pallas"``. Bounds, with the largest gap measured over both
variants, 1 and 8 threads:

  * step-1 metrics 1e-5 relative (measured 1.3e-6);
  * step-1 gradients relative to each tensor's largest |g|, read from
    Adam's first moment (mu = 0.1 g after one step): 1e-4 for the 38
    tensors of layer3, layer4, fc1 and the head (measured 1.8e-5; every fp32
    run is within 1.7e-5 of a float64 run of the port there); 1e-1 for the
    30 of the stem, layer1
    and layer2. Those lie upstream of three ReLU inputs that are within fp32
    rounding of 0 (2.7e-7, 5.8e-7 and 9.6e-7 in float64, in layer1.1,
    layer2.0 and layer2.1), so fp32 rounding decides whether gradient flows
    through them: every fp32 run, JAX's or the port's, is 5.9e-2 off
    float64 there, and the fp32 runs differ by up to 1.1e-2 among
    themselves;
  * running statistics after step 1, 1e-5 (relative above 1; measured
    2.2e-6);
  * params after one Adam step within 1e-6 on >= 99.9% of entries and
    within 2 lr on all: a first Adam step moves every entry by lr times the
    sign of its gradient, so an entry whose gradient is near 0 may move
    either way (measured: 104 of 12.9M entries beyond 1e-6);
  * step-2 total loss 5e-4 relative (measured 9.8e-5). This is the noise
    floor of fp32 here: the port's fp32 step-2 loss is 1.7e-4 off its
    float64 run, JAX's 9.3e-5, and running the port's convolutions on
    channels-last instead of contiguous inputs alone moves it by 8.5e-5.

Nothing is held beyond step 2: BatchNorm over 16 rows makes this tiny batch
chaotic, and the two JAX variants themselves part by 0.35% at step 3 (165.07
vs 165.07, 229.37 vs 229.36, 97.71 vs 98.05). A JAX state after step 1,
carried over with ``encoder_from_jax`` and ``adam_from_optax``, continues in
the port: step-2 metrics 1e-5 relative.
"""

import contextlib
import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ihmr_tpu.models.resnet as JR
from flax import linen as fnn
from ihmr_tpu.data.synthetic import generate as jax_generate
from ihmr_tpu.losses import losses as JL
from ihmr_tpu.mano import layer as JLayer
from ihmr_tpu.mano.loader import mirror_mano_model as jax_mirror
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.models.encoder import InterHandEncoder as FlaxEncoder
from ihmr_tpu.models.encoder import build_mean_params as jax_mean_params
from ihmr_tpu.ops import pallas_bn
from ihmr_tpu.train import baseline as JB
from ihmr_tpu_torch.convert import _encoder_entries, adam_from_optax, encoder_from_jax
from ihmr_tpu_torch.data import BatchList, make_baseline_batch
from ihmr_tpu_torch.losses import hand_type_loss
from ihmr_tpu_torch.mano import mirror_mano_model, synthetic_mano_model, two_hand_decode
from ihmr_tpu_torch.models import InterHandEncoder, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.models.resnet import BatchNorm
from ihmr_tpu_torch.ops import bn_stats as K3
from ihmr_tpu_torch.refine.adam import Adam
from ihmr_tpu_torch.train import baseline as TB
from ihmr_tpu_torch.train import checkpoint as ckpt
from ihmr_tpu_torch.train import loops as TLoops
from ihmr_tpu_torch.train import mlp as TM
from ihmr_tpu_torch.train import profiling
from ihmr_tpu_torch.train.stats import OptTimeStat, TimeStat
from tests.torch_threads import one_torch_thread  # noqa: F401  (the bounds above hold at 1 and 8 threads)

B, SIZE, LR = 4, 64, 1e-4
T = lambda x: torch.as_tensor(np.array(x))


@contextlib.contextmanager
def jax_bn_impl(impl):
    """Trace the JAX ResNet with ``_BN_IMPL = impl``; compiled programs are
    dropped on entry and exit (the jitted steps cache on the same encoder)."""
    saved = JR._BN_IMPL
    JR._BN_IMPL = impl
    jax.clear_caches()
    try:
        yield
    finally:
        JR._BN_IMPL = saved
        jax.clear_caches()


def _jax_batch(model):
    """The batch of tests/test_train.py at B=4."""
    d = jax_generate(model, B, seed=0, noise=0.1)
    ones = jnp.ones((B, 42, 1), jnp.float32)
    rng = np.random.RandomState(0)
    return JB.BaselineBatch(
        img=jnp.asarray(rng.randn(B, SIZE, SIZE, 3).astype(np.float32)) * 0.1,
        hand_type_array=jnp.ones((B, 2)),
        hand_type_valid=jnp.ones((B, 1)),
        joints_2d=jnp.concatenate([d["gt_j2"], ones], axis=-1),
        joints_3d=jnp.concatenate([d["gt_j3"], ones], axis=-1),
        gt_pose_params=d["gt_pose"],
        gt_shape_params=d["gt_shape"],
        mano_params_weight=jnp.ones((B, 2)),
        hand_trans=jnp.concatenate([d["gt_trans"], jnp.ones((B, 1))], axis=-1)[:, None, :],
        do_flip=jnp.zeros((B,), jnp.int32),
    )


def _torch_batch(jb):
    return TB.BaselineBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(TB.BaselineBatch)})


def _np(tree):
    """Numpy copies (a donated JAX buffer may be reused under a view)."""
    return jax.tree_util.tree_map(np.array, tree)


def _by_torch_key(collection, tree):
    """A flax tree -> {torch state-dict key: value in the torch layout}."""
    return {key: value for _, key, value in _encoder_entries({collection: _np(tree)})}


def _init_variables(encoder, mean, rng):
    """Seeded flax variables without flax's init (which compiles for tens of
    seconds on the CPU): lecun-normal kernels, zero biases, unit BatchNorm
    scale, zero-mean unit-variance running statistics."""
    shapes = jax.eval_shape(encoder.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), mean)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return np.full(s.shape, 1.0 if name.endswith(("['scale']", "['var']")) else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


@pytest.fixture(scope="module")
def setup():
    model = jax_synthetic()
    config = JB.TrainConfig(lr=LR)
    encoder = FlaxEncoder(arch="resnet18")
    mean = jax_mean_params(np.zeros(48), np.zeros(10))
    variables = _init_variables(encoder, mean, np.random.RandomState(0))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JB.BaselineState(  # what JB.create_state builds around flax's init
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=JB.make_optimizer(config).init(params),
        mean_params=mean,
        epoch=jnp.asarray(0, jnp.int32),
    )
    # committed like the state train_step returns, so step 2 reuses step 1's program
    state = jax.device_put(state, jax.devices()[0])
    return dict(model=model, left=jax_mirror(model), config=config, encoder=encoder, state=state,
                batch=_jax_batch(model), mean=np.asarray(mean))


def _run_jax(setup, impl):
    """Two JAX train steps (one compile)."""
    enc, cfg, mr, ml, batch = (setup[k] for k in ("encoder", "config", "model", "left", "batch"))
    with jax_bn_impl(impl):
        # train_step donates its state: hand it copies
        s1, m1 = JB.train_step(enc, jax.tree_util.tree_map(jnp.copy, setup["state"]), batch, mr, ml, cfg)
        state1 = _np(s1)
        s2, m2 = JB.train_step(enc, s1, batch, mr, ml, cfg)
        return dict(state1=state1, metrics=[_np(m1), _np(m2)])


def _torch_state(variables, impl, mean):
    encoder = encoder_from_jax(variables, arch="resnet18", device="cpu", bn_impl=impl)
    return TB.create_state(encoder, T(mean), TB.TrainConfig(lr=LR))


def _run_torch(setup, impl):
    s = setup["state"]
    state = _torch_state({"params": _np(s.params), "batch_stats": _np(s.batch_stats)}, impl, setup["mean"])
    mr = synthetic_mano_model(device="cpu")
    ml = mirror_mano_model(mr)
    batch = _torch_batch(setup["batch"])
    cfg = TB.TrainConfig(lr=LR)
    out = dict(metrics=[])
    for step in range(2):
        _, m = TB.train_step(state, batch, mr, ml, cfg)
        out["metrics"].append({k: v.item() for k, v in m.items()})
        if step == 0:
            out["state1"] = {k: v.detach().clone().numpy() for k, v in state.encoder.state_dict().items()}
            out["adam_m1"] = {k: v.clone().numpy() for k, v in state.adam.m.items()}
    return out


@pytest.fixture(scope="module")
def stock(setup):
    return _run_jax(setup, "stock"), _run_torch(setup, "stock")


def _check_params(ours, ref_params):
    """Params after one Adam step: 1e-6 on >= 99.9% of entries, 2 lr (plus the
    rounding of p +- lr) on all."""
    diffs = np.concatenate([np.abs(ours[k] - v).reshape(-1) for k, v in ref_params.items()])
    assert len(ref_params) == 68  # every parameter of the resnet18 encoder
    assert np.mean(diffs <= 1e-6) >= 0.999, np.quantile(diffs, 0.999)
    assert diffs.max() <= 2 * LR * (1 + 1e-3), diffs.max()


# step-1 gradient bounds relative to each tensor's largest |g| (see the
# module docstring): tensors upstream of the ReLU kinks, and the others
GRAD_TOL_UPSTREAM, GRAD_TOL = 1e-1, 1e-4
UPSTREAM = re.compile(r"main_encoder\.(conv1|bn1|layer1|layer2)\.")
LOSS2_RTOL = 5e-4


def _check_step1(jax_out, torch_out):
    jm, tm = jax_out["metrics"][0], torch_out["metrics"][0]
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # Adam's first moment after one step is 0.1 x the step-1 gradient
    gaps = {}
    for k, ref in _by_torch_key("params", jax_out["state1"].opt_state.inner_state[0].mu).items():
        gaps[k] = float(np.abs(torch_out["adam_m1"][k] - ref).max() / np.abs(ref).max())
    upstream = {k: g for k, g in gaps.items() if UPSTREAM.match(k)}
    rest = {k: g for k, g in gaps.items() if k not in upstream}
    assert (len(upstream), len(rest)) == (30, 38)
    assert max(rest.values()) <= GRAD_TOL, max(rest.items(), key=lambda kv: kv[1])
    assert max(upstream.values()) <= GRAD_TOL_UPSTREAM, max(upstream.items(), key=lambda kv: kv[1])
    stats = _by_torch_key("batch_stats", jax_out["state1"].batch_stats)
    assert len(stats) == 40  # 20 BatchNorms x (mean, var)
    for k, v in stats.items():
        np.testing.assert_allclose(torch_out["state1"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    moved = max(np.abs(v - (1.0 if k.endswith("var") else 0.0)).max() for k, v in stats.items())
    assert moved > 1e-2  # the update is visible
    _check_params(torch_out["state1"], _by_torch_key("params", jax_out["state1"].params))
    np.testing.assert_allclose(torch_out["metrics"][1]["total_loss"], jax_out["metrics"][1]["total_loss"],
                               rtol=LOSS2_RTOL)


# ---------------------------------------------------------------------------
# modules


@pytest.mark.parametrize("shape", [(pallas_bn._BLOCK_ROWS * 2 + 37, 24), (3, 40)])
def test_bn_stats_plain_vs_pallas_rows(shape):
    """(rows, C) as the JAX function takes it: 2 full 512-row blocks and a
    masked tail, and a single short block; sums and the gradient."""
    x = (np.random.RandomState(0).randn(*shape) * 2 + 0.5).astype(np.float32)
    gs, gs2 = (np.random.RandomState(1).randn(2, shape[1])).astype(np.float32)
    ref = _np(jax.jit(pallas_bn.bn_stats)(jnp.asarray(x)))

    def weighted(v):
        s, s2 = pallas_bn.bn_stats(v)
        return jnp.sum(s * gs + s2 * gs2)

    ref_g = np.asarray(jax.jit(jax.grad(weighted))(jnp.asarray(x)))
    xt = T(x).requires_grad_(True)
    s, s2 = K3.bn_stats(xt)
    (s * T(gs) + s2 * T(gs2)).sum().backward()
    np.testing.assert_allclose(s.detach().numpy(), ref[0], rtol=1e-5, atol=1e-5 * np.abs(x).sum(0).max())
    np.testing.assert_allclose(s2.detach().numpy(), ref[1], rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_batch_moments_plain_vs_pallas_nchw(dtype):
    """An NCHW activation in the port, its NHWC transpose in JAX."""
    x = np.random.RandomState(2).randn(3, 16, 7, 11).astype(np.float32) + 1.0
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dtype)
    mean, var = _np(jax.jit(pallas_bn.batch_moments)(xj))
    xt = T(np.asarray(xj.astype(jnp.float32)).transpose(0, 3, 1, 2))
    if dtype != np.float32:
        xt = xt.to(torch.bfloat16)
    ours = K3.batch_moments(xt)
    np.testing.assert_allclose(ours[0].numpy(), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours[1].numpy(), var, rtol=1e-5, atol=1e-6)
    assert ours[0].dtype == torch.float32


def test_batch_moments_takes_jax_derivative_at_zero_variance():
    """A channel of (1, 1 + 2^-12) whose fp32 variance cancels to exactly 0:
    JAX's max(0, v) splits the gradient 0.5 / 0.5 there, and so must the
    port (clamp(min=0) passes all of it: twice JAX's gradient). Beside it a
    constant channel and an ordinary one. Every value is exact in fp32."""
    x = np.array([[1.0, 2.0, 0.5], [1.0 + 2.0**-12, 2.0, -1.5]], np.float32)  # (B=2, C=3)
    g_mean, g_var = np.array([[0.0, 1.0, 0.5], [1.0, 1.0, -2.0]], np.float32)

    def weighted(v):
        mean, var = pallas_bn.batch_moments(v)
        return jnp.sum(mean * g_mean + var * g_var)

    ref_var = np.asarray(jax.jit(pallas_bn.batch_moments)(jnp.asarray(x))[1])
    ref_g = np.asarray(jax.jit(jax.grad(weighted))(jnp.asarray(x)))
    xt = T(x).reshape(2, 3, 1, 1).requires_grad_(True)
    mean, var = K3.batch_moments(xt)
    (mean * T(g_mean) + var * T(g_var)).sum().backward()
    assert ref_var[0] == 0.0 and float(var.detach()[0]) == 0.0  # the cancellation case
    np.testing.assert_array_equal(var.detach().numpy(), ref_var)
    np.testing.assert_array_equal(xt.grad.reshape(2, 3).numpy(), ref_g)
    assert ref_g[1, 0] == 2.0**-14  # half of d var / dx = 2 (x - mean) / n


def test_bn_stats_cpu_path_counts_no_launch():
    K3.reset_launch_count()
    K3.bn_stats(torch.rand(2, 3, 4, 4))
    assert K3.launch_count == 0
    with pytest.raises(ValueError):
        K3.launch_plan((5,), 4)


@pytest.mark.parametrize("shape,size,aligned", [
    ((64, 64, 112, 112), 4, True), ((64, 2048, 7, 7), 4, True), ((64, 256, 56, 56), 2, True),
    ((3, 5, 7, 11), 4, True), ((64, 512, 14, 14), 4, False), ((1061, 24), 4, True),
])
def test_bn_stats_launch_plan_covers_every_run(shape, size, aligned):
    """Every run (one channel of one sample) goes to exactly one item (channel
    group, slice of the batch) of one grid of at most one wave of blocks; on
    the runs path a slice holds at least one round of loads a thread unless
    the batch is smaller, on the tiles path a group takes the whole batch."""
    p = K3.launch_plan(shape, size, aligned)
    width = 16 // size
    assert p.path in ("runs", "tiles") and 1 <= p.slices <= p.batch and 1 <= p.grid <= min(p.items, K3.SLOTS)
    if p.path == "runs":
        assert p.ct == 1 and p.vector == (aligned and p.hw % width == 0)
    else:
        assert p.ct * p.hw <= K3.THREADS * width and p.vector == (aligned and p.channels * p.hw % width == 0)
        assert p.slices == 1 and p.groups <= max(K3.SLOTS, -(-p.channels // p.ct))
    runs = sorted((b, c) for g in range(p.groups) for k in range(p.slices)
                  for b in range(k * p.rows, min(p.batch, (k + 1) * p.rows))
                  for c in range(g * p.ct, min(p.channels, (g + 1) * p.ct)))
    assert runs == [(b, c) for b in range(p.batch) for c in range(p.channels)]
    if p.path == "runs":  # slices: enough to fill the wave, but each at least the samples LOADS loads a thread cover
        round_rows = -(-K3.LOADS * K3.THREADS // (p.hw // (width if p.vector else 1)))
        assert p.rows >= min(p.batch, round_rows)
        assert p.slices >= max(1, min(p.batch // round_rows, K3.SLOTS // p.groups) // 2)


def _flax_bn(impl):
    cls = {"stock": fnn.BatchNorm, "pallas": JR.PallasStatsBatchNorm, "fused": JR.FusedStatsBatchNorm}[impl]
    return cls(use_running_average=False, momentum=0.9, epsilon=1e-5)


@pytest.mark.parametrize("impl", ["stock", "pallas", "fused"])
def test_train_mode_batchnorm_matches_flax(impl):
    """Output, updated running statistics and gradients of a train-mode BN
    over 2 x 2 x 2 = 8 rows, where torch's unbiased running variance
    (n / (n - 1) = 8 / 7) is far off flax's biased one."""
    rng = np.random.RandomState(3)
    C = 6
    x = (rng.randn(2, C, 2, 2) * 1.5 + 0.3).astype(np.float32)
    scale, bias = rng.rand(C).astype(np.float32) + 0.5, rng.randn(C).astype(np.float32)
    ra_mean, ra_var = rng.randn(C).astype(np.float32), rng.rand(C).astype(np.float32) + 0.5
    g = rng.randn(*x.shape).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def fwd(v, xs):
        y, upd = _flax_bn(impl).apply(v, xs, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g.transpose(0, 2, 3, 1))), (y, upd)

    (_, (y, upd)), (gv, gx) = jax.value_and_grad(fwd, argnums=(0, 1), has_aux=True)(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)))

    bn = BatchNorm(C, impl).train()
    with torch.no_grad():
        bn.weight.copy_(T(scale)), bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(ra_mean)), bn.running_var.copy_(T(ra_var))
    xt = T(x).requires_grad_(True)
    out = bn(xt)
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), gv["params"]["scale"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), gv["params"]["bias"], rtol=1e-4, atol=1e-5)

    # the trap: torch's own train mode updates the running variance unbiased
    stock = torch.nn.BatchNorm2d(C, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        stock.running_var.copy_(T(ra_var))
        stock(T(x))
    gap = np.abs(stock.running_var.numpy() - np.asarray(upd["batch_stats"]["var"]))
    assert gap.max() > 1e-2

    # eval mode is nn.BatchNorm2d's own path with the running statistics
    bn.eval()
    with torch.no_grad():
        ref_eval = torch.nn.functional.batch_norm(T(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, eps=1e-5)
        torch.testing.assert_close(bn(T(x)), ref_eval, rtol=0, atol=0)


def test_batchnorm_rejects_unknown_impl():
    with pytest.raises(ValueError):
        BatchNorm(4, "cudnn")


def test_hand_type_loss_matches_jax():
    rng = np.random.RandomState(4)
    gt = (rng.rand(5, 2) > 0.5).astype(np.float32)
    pred = np.concatenate([rng.rand(4, 2), [[0.0, 1.0]]]).astype(np.float32)  # clipped at both ends
    valid = (rng.rand(5, 1) > 0.3).astype(np.float32)
    ref = float(JL.hand_type_loss(*map(jnp.asarray, (gt, pred, valid))))
    np.testing.assert_allclose(hand_type_loss(T(gt), T(pred), T(valid)).item(), ref, rtol=1e-6)


def test_two_hand_decode_matches_jax(setup):
    rng = np.random.RandomState(5)
    pose = (rng.randn(3, 96) * 0.3).astype(np.float32)
    shape = (rng.randn(3, 20) * 0.5).astype(np.float32)
    trans = (rng.randn(3, 3) * 0.05).astype(np.float32)
    ref = _np(jax.jit(JLayer.two_hand_decode)(setup["model"], setup["left"], pose, shape, trans))
    mr = synthetic_mano_model(device="cpu")
    with torch.no_grad():
        ours = two_hand_decode(mr, mirror_mano_model(mr), T(pose), T(shape), T(trans))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def test_make_baseline_batch_matches_jax_construction(setup):
    ref = _jax_batch(setup["model"])
    ours = make_baseline_batch(synthetic_mano_model(device="cpu"), batch=B, image_size=SIZE, image_scale=0.1)
    for f in dataclasses.fields(TB.BaselineBatch):
        np.testing.assert_allclose(getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name)), atol=1e-5,
                                   err_msg=f.name)


@pytest.mark.parametrize("decay", ["cosine", "stage", "none"])
def test_learning_rate_for_epoch_matches_jax(decay):
    for epoch in range(0, 21):
        ours = TB.learning_rate_for_epoch(TB.TrainConfig(lr_decay_type=decay), epoch)
        ref = JB.learning_rate_for_epoch(JB.TrainConfig(lr_decay_type=decay), epoch)
        assert ours == pytest.approx(float(ref), rel=1e-12, abs=1e-20), epoch
    assert dataclasses.asdict(TB.TrainConfig()) == {
        f: getattr(JB.TrainConfig(), f) for f in dataclasses.asdict(TB.TrainConfig())
    }


# ---------------------------------------------------------------------------
# the slice


def test_train_step_matches_jax_stock_bn(stock):
    """flax's stock BN against bn_impl="stock"."""
    _check_step1(*stock)


def test_jax_state_continues_in_the_port(setup, stock):
    """JAX's state after step 1 (weights, BatchNorm statistics, optax state)
    carried into the port; the port's step 2 against JAX's."""
    jax_out, _ = stock
    s1 = jax_out["state1"]
    state = _torch_state({"params": s1.params, "batch_stats": s1.batch_stats}, "stock", setup["mean"])
    state.adam, state.lr = adam_from_optax(s1.opt_state, state.encoder)
    assert state.adam.t == 1 and state.lr == pytest.approx(LR)
    mr = synthetic_mano_model(device="cpu")
    _, m = TB.train_step(state, _torch_batch(setup["batch"]), mr, mirror_mano_model(mr), TB.TrainConfig(lr=LR))
    for k, v in jax_out["metrics"][1].items():
        np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, atol=1e-7, err_msg=k)
    bad = copy.copy(s1.opt_state)
    inner = bad.inner_state[0]._replace(mu={k: v for k, v in s1.opt_state.inner_state[0].mu.items() if k != "fc2"})
    with pytest.raises(KeyError):
        adam_from_optax(bad._replace(inner_state=(inner,) + tuple(bad.inner_state[1:])), state.encoder)


# ---------------------------------------------------------------------------
# loop, checkpoints and telemetry (port only)


class _Preempted(Exception):
    pass


class _StopAt(BatchList):
    """Replays its batches and raises when epoch ``stop`` begins."""

    stop = None

    def set_epoch(self, epoch):
        if epoch == self.stop:
            raise _Preempted


def _small_run(tmp, loader_cls, resume=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    encoder = InterHandEncoder("resnet18", bn_impl="pallas")
    init_encoder_weights(encoder, gen)
    mr = synthetic_mano_model(device="cpu")
    cfg = TB.TrainConfig(total_epoch=2, lr=1e-3)
    state = TB.create_state(encoder, build_mean_params(np.zeros(48), np.zeros(10), "cpu"), cfg)
    batches = [make_baseline_batch(mr, batch=2, image_size=32, seed=s) for s in (1, 2)]
    loader = loader_cls(batches)
    start = TLoops.resume_state(str(tmp), state, cfg) if resume else 1
    stats = []
    TLoops.train_baseline_loop(state, loader, mr, mirror_mano_model(mr), cfg, str(tmp), start_epoch=start,
                               is_main=True, epoch_stats=stats)
    return state, start, stats


def test_baseline_loop_resume_is_bit_equal(tmp_path):
    """Two epochs straight against epoch 1, a stop, and a resume from the
    ``latest`` checkpoint into a differently initialised state."""
    full, _, stats = _small_run(tmp_path / "a", BatchList)
    assert [s["steps"] for s in stats] == [2, 2] and all(np.isfinite(s["total_loss"]).all() for s in stats)

    class StopAt2(_StopAt):
        stop = 2

    with pytest.raises(_Preempted):
        _small_run(tmp_path / "b", StopAt2)
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["latest_info.pth", "latest_net_baseline.pth"]
    resumed, start, stats_b = _small_run(tmp_path / "b", BatchList, resume=True, seed=7)
    assert start == 2 and [s["epoch"] for s in stats_b] == [2]
    assert stats_b[0]["total_loss"] == stats[1]["total_loss"]
    for (k, a), b in zip(full.encoder.state_dict().items(), resumed.encoder.state_dict().values()):
        assert torch.equal(a, b), k
    assert resumed.adam.t == full.adam.t == 4 and resumed.lr == full.lr == 0.0
    assert TLoops.resume_state(str(tmp_path / "empty"), resumed, TB.TrainConfig()) == 1


def test_checkpoint_names_and_roundtrip(tmp_path):
    d = str(tmp_path)
    assert ckpt.network_path(d, "baseline", "latest").endswith("latest_net_baseline.pth")
    assert ckpt.network_path(d, "mlp", "latest", stage_id=3).endswith("latest_net_mlp_stage_03.pth")
    assert ckpt.info_path(d, "7", stage_id=0).endswith("7_info_stage_00.pth")
    enc = InterHandEncoder("resnet18")
    init_encoder_weights(enc, torch.Generator().manual_seed(0))
    path = ckpt.save_network(d, enc.state_dict(), "baseline", "3")
    other = InterHandEncoder("resnet18")
    ckpt.load_encoder(other, path)
    for (k, a), b in zip(enc.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    assert ckpt.load_network(d, "baseline", "nope") is None and ckpt.load_info(d, "nope") is None
    ckpt.save_info(d, {"epoch": 7, "adam": {"m": {"w": torch.ones(2)}}}, "latest", stage_id=1)
    info = ckpt.load_info(d, "latest", stage_id=1)
    assert info["epoch"] == 7 and torch.equal(info["adam"]["m"]["w"], torch.ones(2))
    extra = dict(enc.state_dict(), stray=torch.zeros(1))
    torch.save(extra, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError):
        ckpt.load_encoder(other, str(tmp_path / "extra.pth"))


def test_mlp_stage_checkpoints(tmp_path):
    from ihmr_tpu_torch.data import make_mlp_inputs
    from ihmr_tpu_torch.refine import MLPCaches, OptConfig, mlp_default

    mano = synthetic_mano_model(device="cpu")
    loader = BatchList([make_mlp_inputs(mano, batch=2, seed=0)])
    caches = MLPCaches(2, device="cpu")
    TM.warm_pass(mano, loader, caches, OptConfig())
    strategy = tuple(dataclasses.replace(mlp_default[i], epoch=1) for i in (0, 5))
    nets = TM.train_mlp_stages(mano, strategy, loader, caches, OptConfig(), is_main=True,
                               checkpoints_dir=str(tmp_path))
    for stage_id, net in enumerate(nets):
        saved = ckpt.load_network(str(tmp_path), "mlp", "latest", stage_id=stage_id)
        assert set(saved) == set(net.state_dict())
        for k, v in net.state_dict().items():
            assert torch.equal(saved[k], v), k
    assert sorted(p.name for p in tmp_path.iterdir()) == ["latest_net_mlp_stage_00.pth", "latest_net_mlp_stage_01.pth"]


def test_time_stats_and_profiling(capsys, tmp_path):
    ts = TimeStat(total_epoch=3, stage_id=2)
    ts.epoch_init(1)
    ts.stat_data_time()
    ts.stat_forward_time()
    ts.stat_visualize_time()
    ts.print_stat()
    assert capsys.readouterr().out.startswith("stage:02, epoch:001 time")
    ots = OptTimeStat(4, samples_per_iter=8)
    for _ in range(2):
        ots.opt_iter_start()
        ots.opt_iter_end()
    ots.print_stat()
    ots.print_stat(opt_complete=True)
    out = capsys.readouterr().out
    assert "Opt completes: 2/4" in out and "throughput" in out and "Opt completes in" in out
    assert ots.hands_per_sec > 0
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            pass
    assert len(timer.times) == 2 and timer.best <= timer.mean
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("step"):
            torch.ones(3).sum()
    assert prof is not None and (tmp_path / "prof" / "trace.json").exists()
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None


def test_adam_continues_an_optax_state():
    """Adam(lr_last=True), the optimizer adam_from_optax returns, takes one
    step from a carried optax state exactly as optax does."""
    import optax

    rng = np.random.RandomState(6)
    p = {"w": rng.randn(5).astype(np.float32)}
    g = {"w": rng.randn(5).astype(np.float32)}
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=3e-4)
    st = tx.init(p)
    upd, st = tx.update(g, st, p)
    upd, st2 = tx.update(g, st, p)
    adam = Adam({"w": T(p["w"])}, lr_last=True)
    adam.m, adam.v, adam.t = {"w": T(st.inner_state[0].mu["w"])}, {"w": T(st.inner_state[0].nu["w"])}, 1
    ours = adam.step({"w": T(p["w"])}, {"w": T(g["w"])}, float(np.asarray(st.hyperparams["learning_rate"])))
    np.testing.assert_allclose(ours["w"].numpy(), np.asarray(optax.apply_updates(p, upd)["w"]), rtol=0, atol=1e-9)

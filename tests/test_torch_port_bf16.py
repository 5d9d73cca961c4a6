"""The bf16 encoder (``InterHandEncoder(dtype=torch.bfloat16)``, the CLI's
``--bf16``) against the JAX package's ``InterHandEncoder(dtype=bfloat16)``.

flax's casts, found by running them: ``nn.Conv(dtype=bf16)`` and
``nn.Dense(dtype=bf16)`` cast input, kernel and bias to bf16 and return
bf16, the Dense rounding its product to bf16 before adding the bias;
``nn.BatchNorm(dtype=bf16)`` takes fp32 statistics and normalises in fp32
(the bf16 input promotes to the fp32 mean), rounding once to bf16 at the
end, in eval and in train mode; ``jnp.mean`` of bf16 accumulates in fp32.
The port follows these casts, not torch's autocast.

The reference is JAX's program compiled with XLA's
``xla_allow_excess_precision`` off. By default XLA's CPU compiler keeps a
convolution's fp32 result into the fused BatchNorm after it instead of
rounding it to bf16 first (83% of the stem BatchNorm's outputs then differ
from that module's run alone), so it rounds at fewer places than flax's
casts say; with the flag off, the eval-mode forward of this test agrees
with the port to 5.4e-7 (params) against a bf16-fp32 gap of 2.9e-3.

ResNet-18 at 64x64 with random weights and random BatchNorm statistics;
tolerances:

  * per module, on the same bf16 input: the stem convolution's and the
    first BatchNorm's bf16 outputs (eval and train mode) within 1 bf16 ulp
    of JAX's on >= 99.9% of values. Measured: the convolution 99.994%
    equal, 99.9996% within 1 ulp (fp32 sums in another order before the
    rounding); the BatchNorm 100% equal in eval mode, 99.984% equal and
    99.997% within 1 ulp in train mode (batch statistics summed in another
    order). A cast in the wrong place moves far more: bf16 normalisation
    arithmetic changes ~47% of the BatchNorm's values, a single rounding
    in fc1 ~25% of its outputs;
  * end to end, as a band: max |port bf16 - JAX bf16| of each output over
    max |JAX bf16 - JAX fp32|. Eval mode at most
    ``pipeline.BF16_STRICT_BAND`` (0.05), measured 0.0002 (params), 0.0004
    (hand type); an encoder computing in fp32 reads about 1, and one whose
    fc1 adds the bias before rounding its product 0.63 (params) and 0.35
    (hand type) (a mutation check). Train mode at most ``pipeline.BF16_BAND`` (2), measured 0.77,
    0.62 (train-mode statistics summed in another order flip bf16
    roundings, which then spread through the batch); the running
    statistics after one train-mode forward 0.73. Every convolution's,
    BatchNorm's and fc1's input is bf16 (``backbone_input_dtypes``);
  * one train step (stock BatchNorm) against JAX's bf16 ``train_step``,
    the band's fp32 end being the port's fp32 step (within 1e-5 of JAX's,
    tests/test_torch_port_train.py; a JAX fp32 step would be one more
    ~30 s compile): the step-1 gradients of all 68 tensors together within
    the band (measured 0.83); the share of params more than 1e-6 from
    JAX's after one Adam step at most 2x the share between JAX's bf16 step
    and the port's fp32 step (measured 3.88% against 3.76%: a first Adam
    step moves each entry by lr times the sign of its gradient, and bf16
    flips the sign of near-zero entries), all within 2 lr; the running
    statistics within the band (measured 0.62); each metric within 2^-8
    relative, bf16's precision (measured 2.1e-3 on joints_2d_loss). The
    band is no bound for these 8 scalars: their bf16-fp32 gap is a few
    samples' noise (joints_2d_loss 0.026 of 29.4), and the port-JAX gap
    measured 2.34 times it.

K3's plain version on bf16 activations: sums against the JAX kernel in
interpret mode (1e-5 of sum |x|, 1e-5 relative) and its gradient, which
rounds to bf16 as JAX's does (equal).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.models.encoder import InterHandEncoder as FlaxEncoder
from ihmr_tpu.models.encoder import build_mean_params as jax_mean_params
from ihmr_tpu.ops import pallas_bn
from ihmr_tpu.train import baseline as JB
from ihmr_tpu.mano.loader import mirror_mano_model as jax_mirror
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu_torch.convert import encoder_from_jax
from ihmr_tpu_torch.mano import mirror_mano_model, synthetic_mano_model
from ihmr_tpu_torch.ops import bn_stats as K3
from ihmr_tpu_torch.pipeline import BF16_BAND, BF16_STRICT_BAND, backbone_input_dtypes
from ihmr_tpu_torch.train import baseline as TB
from tests.test_torch_port_models import _randomize
from tests.test_torch_port_train import LR, _by_torch_key, _jax_batch, _np, _torch_batch
from tests.torch_threads import one_torch_thread  # noqa: F401

T = lambda x: torch.as_tensor(np.array(x))


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (int16) -> integers in the order of the values."""
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _ulps(ours: torch.Tensor, ref) -> np.ndarray:
    """|ours - ref| in bf16 ulps, element by element (ref: a JAX bf16 array)."""
    a = _ordered(ours.contiguous().view(torch.int16).numpy())
    b = _ordered(np.asarray(ref).view(np.int16))
    return np.abs(a - b)


def _band(test, ref16, ref32):
    """max |test - ref16| / max |ref16 - ref32|."""
    t, r16, r32 = (np.asarray(x, np.float64) for x in (test, ref16, ref32))
    return float(np.abs(t - r16).max() / np.abs(r16 - r32).max())


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    images = (rng.rand(4, 64, 64, 3).astype(np.float32) - 0.5) / 0.5
    mean = jax_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32))
    shapes = jax.eval_shape(FlaxEncoder(arch="resnet18").init, jax.random.PRNGKey(0), jnp.asarray(images), mean)
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes)), rng)
    return dict(images=images, mean=mean, variables=variables)


# XLA's CPU compiler may keep a value in fp32 where the program rounds it to
# bf16 (its default "excess precision"); the reference is compiled without
STRICT = {"xla_allow_excess_precision": False}


def _jax_forward(setup, dtype, train):
    """(params, hand_type, batch_stats or None, intermediates), compiled STRICT."""
    enc = FlaxEncoder(arch="resnet18", dtype=dtype)
    mutable = ["intermediates", "batch_stats"] if train else ["intermediates"]

    def run(v, x, m):
        return enc.apply(v, x, m, train=train, capture_intermediates=True, mutable=mutable)

    args = (setup["variables"], jnp.asarray(setup["images"]), setup["mean"])
    (params, hand_type), state = jax.jit(run).lower(*args).compile(compiler_options=STRICT)(*args)
    return params, hand_type, state.get("batch_stats"), state["intermediates"]["main_encoder"]


@pytest.fixture(scope="module", params=["eval", "train"])
def forwards(request, setup):
    train = request.param == "train"
    ref32 = _jax_forward(setup, jnp.float32, train)
    ref16 = _jax_forward(setup, jnp.bfloat16, train)
    encoder = encoder_from_jax(setup["variables"], arch="resnet18", device="cpu", dtype=torch.bfloat16)
    encoder.train(train)
    with torch.no_grad(), backbone_input_dtypes() as seen:
        ours = encoder(T(setup["images"]), T(setup["mean"]))
    return dict(train=train, ref32=ref32, ref16=ref16, ours=ours, encoder=encoder, dtypes=seen)


def test_stem_convolution_within_one_ulp(forwards, setup):
    inter = forwards["ref16"][3]
    ref = inter["conv1"]["__call__"][0]  # (B, H, W, 64) bf16
    conv = forwards["encoder"].main_encoder.conv1
    with torch.no_grad():
        ours = conv(T(setup["images"]).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    ulps = _ulps(ours.permute(0, 2, 3, 1), ref)
    assert np.mean(ulps <= 1) >= 0.999, (np.mean(ulps == 0), np.mean(ulps <= 1))


def test_batchnorm_within_one_ulp(forwards):
    """The first BatchNorm on JAX's own bf16 convolution output."""
    inter = forwards["ref16"][3]
    x = np.asarray(inter["conv1"]["__call__"][0]).transpose(0, 3, 1, 2)
    bn = copy.deepcopy(forwards["encoder"].main_encoder.bn1)  # train mode updates its statistics
    bn.train(forwards["train"])
    with torch.no_grad():
        ours = bn(torch.as_tensor(x.astype(np.float32)).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    ulps = _ulps(ours.permute(0, 2, 3, 1), inter["bn1"]["__call__"][0])
    assert np.mean(ulps <= 1) >= 0.999, (np.mean(ulps == 0), np.mean(ulps <= 1))


def test_encoder_forward_within_the_band(forwards):
    (p32, h32, s32, _), (p16, h16, s16, _) = forwards["ref32"], forwards["ref16"]
    params, hand_type = forwards["ours"]
    assert params.dtype == hand_type.dtype == torch.float32  # the feature and the head are fp32
    # 20 convolutions, 20 BatchNorms and fc1, each on a bf16 input
    assert len(forwards["dtypes"]) == 41 and set(forwards["dtypes"]) == {torch.bfloat16}
    assert np.abs(np.asarray(p16) - np.asarray(p32)).max() > 0  # the bf16 program really rounds
    # eval mode rounds where JAX's strict program does (an fp32 encoder reads
    # about 1); train mode's batch sums flip roundings (its band: BF16_BAND)
    band = BF16_BAND if forwards["train"] else BF16_STRICT_BAND
    assert _band(params.numpy(), p16, p32) <= band
    assert _band(hand_type.numpy(), h16, h32) <= band
    if forwards["train"]:
        ours = forwards["encoder"].state_dict()
        r16, r32 = _by_torch_key("batch_stats", s16), _by_torch_key("batch_stats", s32)
        keys = sorted(r16)
        cat = lambda d: np.concatenate([np.asarray(d[k]).reshape(-1) for k in keys])
        assert _band(cat({k: ours[k].numpy() for k in keys}), cat(r16), cat(r32)) <= BF16_BAND


@pytest.fixture(scope="module")
def train_steps(setup):
    """One bf16 train step in JAX and in the port, and one fp32 step in the
    port, from the same weights (stock BatchNorm)."""
    variables = setup["variables"]
    model = jax_synthetic()
    config = JB.TrainConfig(lr=LR)
    enc = FlaxEncoder(arch="resnet18", dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JB.BaselineState(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=JB.make_optimizer(config).init(params), mean_params=setup["mean"],
        epoch=jnp.asarray(0, jnp.int32),
    )
    jbatch = _jax_batch(model)
    args = (enc, jax.tree_util.tree_map(jnp.copy, state), jbatch, model, jax_mirror(model), config)
    s1, m1 = JB.train_step.lower(*args).compile(compiler_options=STRICT)(*args[1:5])
    ref = dict(metrics=_np(m1), params=_by_torch_key("params", _np(s1.params)),
               stats=_by_torch_key("batch_stats", _np(s1.batch_stats)),
               grads=_by_torch_key("params", _np(s1.opt_state.inner_state[0].mu)))
    mr = synthetic_mano_model(device="cpu")
    ml = mirror_mano_model(mr)
    batch = _torch_batch(jbatch)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        encoder = encoder_from_jax(variables, arch="resnet18", device="cpu", dtype=dtype)
        tstate = TB.create_state(encoder, T(setup["mean"]), TB.TrainConfig(lr=LR))
        _, m = TB.train_step(tstate, batch, mr, ml, TB.TrainConfig(lr=LR))
        out[name] = dict(metrics={k: v.item() for k, v in m.items()},
                         state={k: v.detach().numpy() for k, v in encoder.state_dict().items()},
                         grads={k: v.numpy() for k, v in tstate.adam.m.items()})
    return ref, out


def test_train_step_gradients_and_metrics(train_steps):
    ref, out = train_steps
    keys = sorted(ref["grads"])
    assert len(keys) == 68  # every parameter of the resnet18 encoder
    cat = lambda d: np.concatenate([np.asarray(d[k]).reshape(-1) for k in keys])
    # Adam's first moment after one step is 0.1 x the step-1 gradient
    assert _band(cat(out["bf16"]["grads"]), cat(ref["grads"]), cat(out["fp32"]["grads"])) <= BF16_BAND
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(out["bf16"]["metrics"][k], v, rtol=2.0**-8, atol=1e-7, err_msg=k)


def test_train_step_params_and_statistics(train_steps):
    ref, out = train_steps
    keys = sorted(ref["params"])
    far = lambda d: np.concatenate([np.abs(d[k] - ref["params"][k]).reshape(-1) for k in keys]) > 1e-6
    moved = lambda d: np.concatenate([np.abs(d[k] - ref["params"][k]).reshape(-1) for k in keys]).max()
    ours, fp32 = out["bf16"]["state"], out["fp32"]["state"]
    assert np.mean(far(ours)) <= BF16_BAND * np.mean(far(fp32)), (np.mean(far(ours)), np.mean(far(fp32)))
    assert moved(ours) <= 2 * LR * (1 + 1e-3)
    keys = sorted(ref["stats"])
    cat = lambda d: np.concatenate([np.asarray(d[k]).reshape(-1) for k in keys])
    assert _band(cat(ours), cat(ref["stats"]), cat(fp32)) <= BF16_BAND


@pytest.mark.parametrize("shape", [(pallas_bn._BLOCK_ROWS + 37, 24), (3, 40)])
def test_bn_stats_plain_version_on_bf16(shape):
    """K3's plain version on a bf16 (rows, C) input against the JAX kernel
    (interpret mode): fp32 sums, and the gradient cast back to bf16."""
    x = jnp.asarray((np.random.RandomState(0).randn(*shape) * 2 + 0.5).astype(np.float32)).astype(jnp.bfloat16)
    gs, gs2 = (np.random.RandomState(1).randn(2, shape[1])).astype(np.float32)
    ref = _np(jax.jit(pallas_bn.bn_stats)(x))

    def weighted(v):
        s, s2 = pallas_bn.bn_stats(v)
        return jnp.sum(s * gs + s2 * gs2)

    ref_g = jax.jit(jax.grad(weighted))(x)
    xt = torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16).requires_grad_(True)
    s, s2 = K3.bn_stats(xt)
    assert s.dtype == s2.dtype == torch.float32
    (s * T(gs) + s2 * T(gs2)).sum().backward()
    absum = np.abs(np.asarray(x.astype(jnp.float32))).sum(0)
    np.testing.assert_allclose(s.detach().numpy(), ref[0], rtol=0, atol=1e-5 * absum.max())
    np.testing.assert_allclose(s2.detach().numpy(), ref[1], rtol=1e-5)
    assert xt.grad.dtype == torch.bfloat16
    assert np.max(_ulps(xt.grad, ref_g)) <= 1

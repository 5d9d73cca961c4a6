"""Parity of the port's ResNet/encoder with the flax modules, through
``ihmr_tpu_torch.convert.encoder_from_jax``.

Forward: resnet18 encoder at B=2, 64x64 images, random weights AND random
BatchNorm statistics (so a wrong BN mapping cannot hide), rtol 1e-4 (fp32
convolutions summed in another order). resnet50: every flax variable maps
to a torch entry of the same shape and none is left over (no forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.models.encoder import InterHandEncoder as FlaxEncoder
from ihmr_tpu.models.encoder import build_mean_params as jax_mean_params
from ihmr_tpu_torch.convert import encoder_from_jax
from ihmr_tpu_torch.models import InterHandEncoder, build_mean_params, get_backbone, init_encoder_weights
from tests.torch_threads import one_torch_thread  # noqa: F401


def _randomize(tree, rng):
    """Random leaves of the same shapes; variances positive."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return out


def test_build_mean_params():
    rng = np.random.RandomState(0)
    pose, betas = rng.randn(48).astype(np.float32), rng.randn(10).astype(np.float32)
    np.testing.assert_array_equal(
        build_mean_params(pose, betas, device="cpu").numpy(), np.asarray(jax_mean_params(pose, betas))
    )
    if not torch.cuda.is_available():  # no silent CPU fallback
        with pytest.raises(RuntimeError):
            build_mean_params(pose, betas)


def test_resnet18_encoder_forward_parity():
    rng = np.random.RandomState(0)
    flax_model = FlaxEncoder(arch="resnet18")
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    mean = jax_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32))
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0), jnp.asarray(images), mean)
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes)), rng)
    ref_params, ref_type = jax.jit(flax_model.apply)(variables, jnp.asarray(images), mean)

    encoder = encoder_from_jax(variables, arch="resnet18", device="cpu")
    with torch.no_grad():
        params, hand_type = encoder(torch.as_tensor(images), torch.as_tensor(np.array(mean)))
    np.testing.assert_allclose(params.numpy(), np.asarray(ref_params), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hand_type.numpy(), np.asarray(ref_type), rtol=1e-4, atol=1e-6)


def test_resnet50_variables_cover_the_torch_encoder():
    flax_model = FlaxEncoder(arch="resnet50")
    shapes = jax.eval_shape(
        flax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), jnp.zeros((122,))
    )
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    encoder = encoder_from_jax(variables, arch="resnet50", device="cpu")
    n_flax = len(jax.tree_util.tree_leaves(variables))
    n_torch = sum(1 for k in encoder.state_dict() if not k.endswith("num_batches_tracked"))
    assert n_flax == n_torch == 273  # 53 convs, 53 BNs x 4, 4 dense x 2
    # a variable without a counterpart is refused
    variables["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        encoder_from_jax(variables, arch="resnet50", device="cpu")


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"])
def test_backbone_output_shape(arch):
    net = get_backbone(arch).eval()
    init_encoder_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net(torch.rand(1, 32, 32, 3))
    assert out.shape == (1, 1024) and torch.isfinite(out).all()


def test_encoder_seeded_init_is_deterministic():
    outs = []
    for _ in range(2):
        enc = InterHandEncoder("resnet18").eval()
        init_encoder_weights(enc, torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append(enc(torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)), torch.zeros(122)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)

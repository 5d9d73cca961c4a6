"""Weights and state carried across from the JAX package, as numpy arrays.

``encoder_from_jax`` maps a flax ``InterHandEncoder``'s variables
({"params": ..., "batch_stats": ...}, leaves converted to numpy) onto the
torch modules: conv kernels HWIO -> OIHW, Dense kernels (in, out) -> Linear
weights (out, in), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var. It is the inverse of the JAX package's torch importer
(``train/checkpoint.py::import_torch_resnet``).

``adam_from_optax`` carries the optimizer state of the JAX package's
baseline training (``optax.inject_hyperparams(optax.adam)``: count, mu, nu
and the injected learning rate) onto the encoder's parameter names, so a
JAX training state continues in the port.

``subnetwork_from_jax`` does the same for a flax ``SubNetwork`` (the MLP
stage network): each Dense kernel (in, out) becomes a Linear weight (out, in).

``mano_from_numpy`` builds the port's ``ManoModel`` from the JAX model's
arrays (``np.asarray`` of each field).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.mano.loader import model_from_arrays
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder, SubNetwork
from ihmr_tpu_torch.refine.adam import Adam

# flax head module -> torch submodule of InterHandEncoder
_HEAD = {"fc2": "feat_encoder.1", "regressor_ih": "regressor_ih.0", "hand_classifier": "hand_classifier.0"}
# flax leaf -> torch leaf (Conv/Dense kernel and bias, BatchNorm scale/bias/mean/var)
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _backbone_module(name: str) -> str:
    """flax backbone module name -> torch module path (torchvision naming)."""
    m = re.fullmatch(r"layer(\d+)_(\d+)", name)
    return f"layer{m.group(1)}.{m.group(2)}" if m else name


def _torch_key(path: tuple) -> str:
    """(collection, flax module path..., leaf) -> torch state-dict key."""
    _collection, *mods, leaf = path
    if mods and mods[0] == "main_encoder":
        names = [_backbone_module(x) for x in mods[1:]]
        names = [{"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(x, x) for x in names]
        module = ".".join(["main_encoder"] + names)
    elif len(mods) == 1 and mods[0] in _HEAD:
        module = _HEAD[mods[0]]
    else:
        raise KeyError(f"no torch counterpart for flax variable {'/'.join(path)}")
    if leaf not in _LEAF:
        raise KeyError(f"no torch counterpart for flax variable {'/'.join(path)}")
    return f"{module}.{_LEAF[leaf]}"


def _load_state(module: torch.nn.Module, entries) -> None:
    """Load (flax path, torch key, value) entries into ``module``; raises on
    a value whose shape does not fit and on any torch parameter or buffer
    (``num_batches_tracked`` aside) left without a flax variable."""
    state = module.state_dict()
    unset = {k for k in state if not k.endswith("num_batches_tracked")}
    for path, key, value in entries:
        if key not in state or tuple(state[key].shape) != value.shape:
            raise KeyError(
                f"flax {'/'.join(path)} {value.shape} does not fit torch {key} "
                f"{tuple(state[key].shape) if key in state else 'missing'}"
            )
        state[key] = torch.tensor(np.asarray(value, np.float32))
        unset.discard(key)
    if unset:
        raise KeyError(f"torch entries without a flax variable: {sorted(unset)}")
    module.load_state_dict(state)


def _encoder_entries(variables: Mapping):
    """(flax path, torch key, value in the torch layout) of every leaf of a
    flax encoder tree ({"params": ..., "batch_stats": ...})."""
    for path, value in _flatten(variables).items():
        if path[-1] == "kernel":
            # conv HWIO -> OIHW; dense (in, out) -> (out, in)
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        yield path, _torch_key(path), value


def encoder_from_jax(
    variables: Mapping,
    arch: str = "resnet50",
    device: DeviceLike = None,
    bn_impl: str = "stock",
    dtype: torch.dtype = torch.float32,
) -> InterHandEncoder:
    """A torch InterHandEncoder (eval mode, on ``device``, train-mode
    BatchNorm by ``bn_impl``, computing in ``dtype``) holding the flax
    encoder's weights, which are fp32 in either dtype. Raises on any flax
    variable without a counterpart and on any torch parameter or buffer left
    unset."""
    encoder = InterHandEncoder(arch, bn_impl=bn_impl, dtype=dtype)
    _load_state(encoder, _encoder_entries(variables))
    return encoder.to(resolve_device(device)).eval()


def adam_from_optax(opt_state: Any, encoder: InterHandEncoder) -> Tuple[Adam, float]:
    """(Adam over ``encoder``'s named parameters, learning rate) from the JAX
    baseline trainer's optimizer state, leaves as numpy: ``opt_state`` is
    optax's ``InjectHyperparamsState`` whose ``inner_state[0]`` is the
    ``ScaleByAdamState`` (count, mu, nu; mu and nu shaped like the flax
    params). Raises unless mu and nu cover every parameter exactly."""
    adam_state = opt_state.inner_state[0]
    params = dict(encoder.named_parameters())
    adam = Adam({}, lr_last=True)
    for name, tree in (("m", adam_state.mu), ("v", adam_state.nu)):
        moments = {}
        for path, key, value in _encoder_entries({"params": tree}):
            if key not in params or tuple(params[key].shape) != value.shape:
                raise KeyError(f"optax {name} leaf {'/'.join(path)} {value.shape} does not fit {key}")
            moments[key] = torch.tensor(np.asarray(value, np.float32), device=params[key].device)
        if set(moments) != set(params):
            raise KeyError(f"optax {name} leaves miss {sorted(set(params) - set(moments))}")
        setattr(adam, name, moments)
    adam.t = int(np.asarray(adam_state.count))
    return adam, float(np.asarray(opt_state.hyperparams["learning_rate"]))


def subnetwork_from_jax(variables: Mapping, device: DeviceLike = None) -> SubNetwork:
    """A torch SubNetwork (on ``device``) holding a flax SubNetwork's weights
    ({"params": {"fc1": {"kernel", "bias"}, ...}}). Raises on any flax
    variable without a counterpart and on any torch parameter left unset."""
    flat = _flatten(variables)
    if ("params", "regressor", "bias") not in flat:
        raise KeyError("flax SubNetwork variables have no params/regressor/bias")

    def entries():
        for path, value in flat.items():
            if len(path) != 3 or path[0] != "params" or path[2] not in ("kernel", "bias"):
                raise KeyError(f"no torch counterpart for flax variable {'/'.join(path)}")
            yield path, f"{path[1]}.{_LEAF[path[2]]}", value.T if path[2] == "kernel" else value

    net = SubNetwork(flat[("params", "regressor", "bias")].shape[0])
    _load_state(net, entries())
    return net.to(resolve_device(device))


def mano_from_numpy(
    v_template, shapedirs, posedirs, j_regressor, lbs_weights, faces,
    is_rhand: bool = True, device: DeviceLike = None,
) -> ManoModel:
    """The port's ManoModel from the JAX model's arrays."""
    arrays = dict(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_regressor, lbs_weights=lbs_weights, faces=faces,
    )
    return model_from_arrays(arrays, device, is_rhand=is_rhand)

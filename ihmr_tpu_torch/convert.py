"""Weights and state carried across from the JAX package, as numpy arrays.

``encoder_from_jax`` maps a flax ``InterHandEncoder``'s variables
({"params": ..., "batch_stats": ...}, leaves converted to numpy) onto the
torch modules: conv kernels HWIO -> OIHW, Dense kernels (in, out) -> Linear
weights (out, in), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var. It is the inverse of the JAX package's torch importer
(``train/checkpoint.py::import_torch_resnet``).

``subnetwork_from_jax`` does the same for a flax ``SubNetwork`` (the MLP
stage network): each Dense kernel (in, out) becomes a Linear weight (out, in).

``mano_from_numpy`` builds the port's ``ManoModel`` from the JAX model's
arrays (``np.asarray`` of each field).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.mano.loader import model_from_arrays
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder, SubNetwork

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


def encoder_from_jax(
    variables: Mapping, arch: str = "resnet50", device: DeviceLike = None
) -> InterHandEncoder:
    """A torch InterHandEncoder (eval mode, on ``device``) holding the flax
    encoder's weights. Raises on any flax variable without a counterpart and
    on any torch parameter or buffer left unset."""

    def entries():
        for path, value in _flatten(variables).items():
            if path[-1] == "kernel":
                # conv HWIO -> OIHW; dense (in, out) -> (out, in)
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            yield path, _torch_key(path), value

    encoder = InterHandEncoder(arch)
    _load_state(encoder, entries())
    return encoder.to(resolve_device(device)).eval()


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

"""Checkpoints with the reference's label scheme (port of
ihmr_tpu/train/checkpoint.py).

Weights go to ``{label}_net_{name}[_stage_{k:02d}].pth`` and the epoch and
optimizer state to ``{label}_info[_stage_{k:02d}].pth`` under one
directory; a ``latest`` label is rewritten every epoch. Each file is one
``torch.save`` of a dictionary of tensors (a module's ``state_dict``), read
back with ``weights_only=True`` onto the CPU.

These files do not interchange with the JAX package's checkpoints, which
are orbax directories of flax trees under the same names without a suffix
(orbax is not a dependency of the port); ``convert.encoder_from_jax`` and
``convert.adam_from_optax`` carry a JAX training state across instead. The
reference's own torch encoder checkpoints (``{epoch}_net_baseline.pth``)
have the port's state-dict names and load as they are (``load_encoder``,
strict).

``import_torch_resnet`` maps a torchvision-layout ResNet state dict (the
reference's pretrained backbone, ``--pretrain_weights``) onto the encoder's
backbone, as the JAX package's importer of the same name maps it onto the
flax ResNet.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn


def _suffix(stage_id: Optional[int]) -> str:
    return f"_stage_{stage_id:02d}" if stage_id is not None else ""


def network_path(ckpt_dir: str, name: str, label: str, stage_id: Optional[int] = None) -> str:
    return osp.join(osp.abspath(ckpt_dir), f"{label}_net_{name}{_suffix(stage_id)}.pth")


def info_path(ckpt_dir: str, label: str, stage_id: Optional[int] = None) -> str:
    return osp.join(osp.abspath(ckpt_dir), f"{label}_info{_suffix(stage_id)}.pth")


def _save(obj: Any, path: str) -> str:
    os.makedirs(osp.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return path


def _load(path: str) -> Optional[Any]:
    if not osp.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_network(ckpt_dir: str, state_dict: Dict[str, torch.Tensor], name: str, label: str,
                 stage_id: Optional[int] = None) -> str:
    return _save(_to_cpu(dict(state_dict)), network_path(ckpt_dir, name, label, stage_id))


def load_network(ckpt_dir: str, name: str, label: str, stage_id: Optional[int] = None) -> Optional[Dict]:
    """The saved state dict (on the CPU), or None when there is none."""
    return _load(network_path(ckpt_dir, name, label, stage_id))


def save_info(ckpt_dir: str, info: Dict, label: str, stage_id: Optional[int] = None) -> str:
    return _save(_to_cpu(info), info_path(ckpt_dir, label, stage_id))


def load_info(ckpt_dir: str, label: str, stage_id: Optional[int] = None) -> Optional[Dict]:
    return _load(info_path(ckpt_dir, label, stage_id))


def load_encoder(encoder: nn.Module, path: str) -> nn.Module:
    """Load an encoder state dict file (the port's or the reference's torch
    ``.pth``) into ``encoder``, strictly: every key must match."""
    encoder.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return encoder


def import_torch_resnet(
    pth_path_or_state: Union[str, Mapping[str, Any]],
    backbone_state: Mapping[str, torch.Tensor],
    strict: bool = False,
) -> Dict[str, torch.Tensor]:
    """``backbone_state`` (the encoder's ``main_encoder.state_dict()``) with
    every entry that a torchvision ResNet state dict (a ``.pth`` path or a
    mapping) supplies replaced, cast to the entry's dtype: convolutions,
    BatchNorm weight / bias / running statistics, downsample branches, and
    ``fc1.*`` onto the feature head. ``fc.*`` (torchvision's classifier) and
    ``num_batches_tracked`` are skipped; any other key, or one the backbone
    lacks, is unmatched, which raises under ``strict``. A shape that does
    not fit raises."""
    if isinstance(pth_path_or_state, str):
        state = torch.load(pth_path_or_state, map_location="cpu", weights_only=True)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
    else:
        state = dict(pth_path_or_state)
    out = {k: v.detach().clone() for k, v in backbone_state.items()}
    unmatched = []
    for key, value in state.items():
        if key.startswith("fc.") or key.endswith(".num_batches_tracked"):
            continue
        if key not in out:  # the port's backbone keys are torchvision's names
            unmatched.append(key)
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(out[key].shape):
            raise ValueError(f"torch {key} {tuple(value.shape)} does not fit the backbone's {tuple(out[key].shape)}")
        out[key] = value.detach().to(dtype=out[key].dtype, device=out[key].device).clone()
    if strict and unmatched:
        raise KeyError(f"unmatched torch keys: {unmatched}")
    return out

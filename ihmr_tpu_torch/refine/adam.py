"""Adam with bias correction, as the JAX package's engines compute it, and
the OPT engine's momentum SGD.

One state per optimised set of tensors: first and second moments start at
zero and the step count t runs on across calls (a stage of the OPT engine,
or a whole MLP stage whose learning rate changes per epoch, as optax's
``inject_hyperparams`` state does). Each step:

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2
    p = p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with the bias corrections 1 - b^t computed in fp32. The two JAX engines
round the last line differently: the OPT engine multiplies the corrected
first moment by the learning rate before the division; optax (the MLP
trainer) divides first and multiplies the quotient by the learning rate
(``lr_last=True``).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Union

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8

_B1_F32 = torch.tensor(B1, dtype=torch.float32)
_B2_F32 = torch.tensor(B2, dtype=torch.float32)


class Adam:
    """Adam state over a dict of tensors; ``step`` returns the updated dict."""

    def __init__(self, params: Dict[str, torch.Tensor], lr_last: bool = False):
        self.m = {k: torch.zeros_like(x) for k, x in params.items()}
        self.v = {k: torch.zeros_like(x) for k, x in params.items()}
        self.t = 0
        self.lr_last = lr_last

    @torch.no_grad()
    def step(
        self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float
    ) -> Dict[str, torch.Tensor]:
        self.t += 1
        c1, c2 = bias_factors(self.t, cuda=False).tolist()
        out = {}
        for k, p in params.items():
            self.m[k] = B1 * self.m[k] + (1 - B1) * grads[k]
            self.v[k] = B2 * self.v[k] + (1 - B2) * grads[k] ** 2
            m_hat, denom = self.m[k] / c1, torch.sqrt(self.v[k] / c2) + EPS
            out[k] = p - (lr * (m_hat / denom) if self.lr_last else lr * m_hat / denom)
        return out


def bias_factors(t: int, cuda: bool) -> torch.Tensor:
    """(2,) fp32 on the CPU: what ``Adam.step`` divides the moments by at its
    t-th step, 1 - b1^t and 1 - b2^t, as that division rounds on a card
    (``cuda``) or on the CPU. ``Adam.step`` divides by a Python float;
    PyTorch's CUDA true division by a host scalar multiplies by the scalar's
    fp32 reciprocal, so for a card these are the reciprocals (a device
    divisor would round otherwise) and ``adam_update_`` multiplies by them."""
    tt = torch.tensor(float(t), dtype=torch.float32)
    c = torch.stack([1.0 - _B1_F32**tt, 1.0 - _B2_F32**tt])
    return torch.tensor(1.0, dtype=torch.float32) / c if cuda else c


@functools.lru_cache(maxsize=None)
def bias_corrections(steps: int, device: torch.device) -> torch.Tensor:
    """(steps, 2) fp32 on ``device``: row t - 1 holds ``bias_factors(t)``
    for that device. Made once per length and device; never write into it."""
    rows = [bias_factors(t, device.type == "cuda") for t in range(1, steps + 1)]
    with torch.inference_mode(False):
        return torch.stack(rows).to(device)


@torch.no_grad()
def adam_update_(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    m: Dict[str, torch.Tensor],
    v: Dict[str, torch.Tensor],
    corr: Sequence[torch.Tensor],
    lr: Union[float, torch.Tensor],
    lr_last: bool = False,
) -> None:
    """One Adam step in place, for a captured CUDA graph: ``params``, ``m``
    and ``v`` are overwritten, and the step's bias corrections are read from
    the device (``corr[0]``, ``corr[1]``: a row of ``bias_corrections`` or
    tensors filled with ``bias_factors``), so that the step count need not
    be known when the graph is captured. The same kernels and rounding as
    ``Adam.step`` with the same ``lr_last``, whose own code serves every
    other caller: the OPT engine's order with a host ``lr``, or optax's
    (``lr_last=True``, the train step's), where ``lr`` may be a 0-dim fp32
    device tensor that holds the learning rate, so that a captured step
    reads the one set before each replay."""
    for k, p in params.items():
        torch.add(B1 * m[k], (1 - B1) * grads[k], out=m[k])
        torch.add(B2 * v[k], (1 - B2) * grads[k] ** 2, out=v[k])
        if p.is_cuda:
            m_hat, v_hat = m[k] * corr[0], v[k] * corr[1]
        else:
            m_hat, v_hat = m[k] / corr[0], v[k] / corr[1]
        if lr_last:
            torch.sub(p, lr * (m_hat / (torch.sqrt(v_hat) + EPS)), out=p)
        else:
            torch.sub(p, lr * m_hat / (torch.sqrt(v_hat) + EPS), out=p)


SGD_MOMENTUM = 0.9


class SGD:
    """SGD with momentum 0.9 and no dampening (torch's, and the JAX OPT
    engine's ``optimizer="sgd"``): buf = 0.9 buf + g, p = p - lr * buf, with
    buf starting at zero, so the first step takes buf = g exactly."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.buf = {k: torch.zeros_like(x) for k, x in params.items()}

    @torch.no_grad()
    def step(
        self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float
    ) -> Dict[str, torch.Tensor]:
        out = {}
        for k, p in params.items():
            self.buf[k] = SGD_MOMENTUM * self.buf[k] + grads[k]
            out[k] = p - lr * self.buf[k]
        return out

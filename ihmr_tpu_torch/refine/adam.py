"""Adam with bias correction, as the JAX package's engines compute it.

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

from typing import Dict

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
        t = torch.tensor(float(self.t), dtype=torch.float32)
        c1 = float(1.0 - _B1_F32**t)
        c2 = float(1.0 - _B2_F32**t)
        out = {}
        for k, p in params.items():
            self.m[k] = B1 * self.m[k] + (1 - B1) * grads[k]
            self.v[k] = B2 * self.v[k] + (1 - B2) * grads[k] ** 2
            m_hat, denom = self.m[k] / c1, torch.sqrt(self.v[k] / c2) + EPS
            out[k] = p - (lr * (m_hat / denom) if self.lr_last else lr * m_hat / denom)
        return out

"""Operations and bytes of IHMR's ResNet-50 encoder, from its shapes.

One multiply-add is 2 floating-point operations. A convolution of kernel
k x k from c_in to c_out channels over an h_out x w_out output does
c_out * h_out * w_out * c_in * k * k multiply-adds per image; a dense layer
n_in -> n_out does n_in * n_out. The training step's count is 3 x the
forward (the backward computes the input gradient and the weight gradient,
each as large as the forward), the usual model-FLOP convention; element-wise
work (BatchNorm, ReLU, adds, Adam) is not counted.
"""

from __future__ import annotations

from typing import List, Tuple

STAGES = (3, 4, 6, 3)
EXPANSION = 4


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def layers(image: int) -> Tuple[List[Tuple[int, int, int, int]], List[Tuple[int, int]]]:
    """-> (convolutions as (c_in, c_out, k, output side), BatchNorm inputs as
    (channels, side)), per image, in network order."""
    convs, bns = [], []
    s = _out(image, 7, 2, 3)
    convs.append((3, 64, 7, s))
    bns.append((64, s))
    s = _out(s, 3, 2, 1)  # max-pool
    cin = 64
    for i, n in enumerate(STAGES):
        width = 64 * 2**i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            s2 = _out(s, 3, stride, 1)
            convs += [(cin, width, 1, s), (width, width, 3, s2), (width, width * EXPANSION, 1, s2)]
            bns += [(width, s), (width, s2), (width * EXPANSION, s2)]
            if stride != 1 or cin != width * EXPANSION:
                convs.append((cin, width * EXPANSION, 1, s2))
                bns.append((width * EXPANSION, s2))
            cin, s = width * EXPANSION, s2
    return convs, bns


def dense_macs(params: int = 122, feature: int = 1024, iterations: int = 3) -> int:
    """fc1 (2048 -> 1024), fc2 (1024 -> 1024), the regressor (1024 + 122 ->
    122) ``iterations`` times, the handedness head (1024 -> 2)."""
    return 2048 * feature + feature * feature + iterations * (feature + params) * params + feature * 2


def forward_flops(image: int) -> int:
    """Operations of one image's forward pass."""
    convs, _ = layers(image)
    return 2 * (sum(ci * co * k * k * s * s for ci, co, k, s in convs) + dense_macs())


def train_flops(image: int) -> int:
    """Operations of one image in a training step: forward and backward."""
    return 3 * forward_flops(image)


def bn_input_bytes(batch: int, image: int, itemsize: int = 4) -> int:
    """Bytes of every BatchNorm input of one forward, each read once: what the
    batch-statistics kernel K3 must read in a training step."""
    _, bns = layers(image)
    return itemsize * batch * sum(c * s * s for c, s in bns)

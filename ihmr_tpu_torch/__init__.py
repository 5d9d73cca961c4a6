"""ihmr_tpu_torch: the PyTorch/CUDA port of ``ihmr_tpu`` for NVIDIA Hopper.

The JAX package ``ihmr_tpu`` stays beside this one as the reference; every
module here names its JAX counterpart and is held against it by the
``tests/test_torch_port_*.py`` parity tests. This package imports torch,
numpy and scipy only — never jax, flax, optax or ``ihmr_tpu``.

Layout mirrors the reference: ``core/`` (rotations, projection), ``mano/``
(model, synthetic loader, decode), ``losses/``, ``ops/`` (collision, the
exact-collision and nearest-centroid CUDA kernels, sources in ``csrc/``),
``refine/`` (schedules, Adam, the OPT engine and the MLP cascade),
``train/`` (MLP stage training, running loss averages), ``models/``
(ResNet, encoder, MLP stage network), ``data/`` (synthetic inputs),
``convert.py`` (weights from the JAX package) and ``pipeline.py`` (the OPT
workload of ``bench.py`` and the MLP workload, end to end).

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``ihmr_tpu_torch.device.resolve_device``).
"""

from ihmr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

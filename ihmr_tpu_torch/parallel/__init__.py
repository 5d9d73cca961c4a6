"""Multi-process helpers (port of ihmr_tpu/parallel/): ``dist``, the process
group and the file-pickle result gather. The JAX package's ``mesh`` module
(single-process SPMD over several devices) is not ported."""

from ihmr_tpu_torch.parallel import dist  # noqa: F401

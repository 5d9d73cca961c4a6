"""Parallelism (port of ihmr_tpu/parallel/): ``dist``, the process group and
the file-pickle result gather, and ``mesh``, data parallelism over the
devices of one process (a batch sharded over a mesh, one host thread and
CUDA stream per shard)."""

from ihmr_tpu_torch.parallel import dist  # noqa: F401
from ihmr_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    batch_sharding,
    gather_to_host,
    make_mesh,
    pad_to_multiple,
    replicate,
    replicated,
    shard_batch,
)

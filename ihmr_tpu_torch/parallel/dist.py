"""Multi-process initialization + result gather (port of
ihmr_tpu/parallel/dist.py).

``initialize`` reads the JAX package's arguments and environment variables
(``JAX_COORDINATOR_ADDRESS`` as host:port, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), so a launcher written for the JAX command line starts
the port's processes unchanged; with a coordinator it joins a
``torch.distributed`` process group over ``tcp://`` with the **gloo**
backend (host collectives: two ranks may share one card, which NCCL
refuses), without one it does nothing and returns (0, 1). The result
gather is the reference's file-pickle mechanism: each rank pickles its
Evaluator or MLP caches into a shared directory, a barrier, then the ranks
read each other's files.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Tuple

import torch.distributed as td

from ihmr_tpu_torch.utils import io_utils


def _world() -> Tuple[int, int]:
    if td.is_available() and td.is_initialized():
        return td.get_rank(), td.get_world_size()
    return 0, 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world_size).

    No-op single-process when no coordinator address is given or set (the
    reference's non-distributed mode; callers gate on rank <= 0)."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address and not (td.is_available() and td.is_initialized()):
        world = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0"))
        address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        td.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    return _world()


def barrier(name: str = "barrier"):
    """Cross-process sync point (the reference's dist.barrier()); ``name``
    labels it for the reader, as in the JAX package."""
    if _world()[1] > 1:
        td.barrier()


def sync_mlp_caches(caches, save_dir: str, rank: int, world_size: int):
    """Cross-rank MLP prediction-cache sync: each rank writes its cache,
    barrier, then folds every other rank's samples in (``MLPCaches.merge``).
    Single-process: no-op."""
    if world_size <= 1:
        return caches
    path = osp.join(save_dir, f"process_{max(rank, 0)}.pkl")
    io_utils.save_pkl(path, caches)
    barrier("sync_mlp_caches")
    for r in range(world_size):
        if r == max(rank, 0):
            continue
        other = io_utils.load_pkl(osp.join(save_dir, f"process_{r}.pkl"))
        caches.merge(other)
    return caches


def gather_evaluators(evaluator, save_dir: str, tag: str, rank: int, world_size: int):
    """Filesystem gather of per-rank Evaluators; rank 0 returns the merged
    evaluator (every rank's results in rank order), others return None."""
    path = osp.join(save_dir, f".{tag}_{max(rank, 0)}.pkl")
    io_utils.save_pkl(path, evaluator)
    barrier("gather_evaluators")
    if rank > 0:
        return None
    evaluator.clear()
    for r in range(world_size):
        p = osp.join(save_dir, f".{tag}_{r}.pkl")
        other = io_utils.load_pkl(p)
        evaluator.gather_pred(other.pred_results)
        os.remove(p)
    return evaluator

"""Two real processes through the port's ``parallel/dist.py`` on the CPU, as
``tests/test_dist_multiprocess.py`` runs the JAX package's.

The ranks meet over a ``torch.distributed`` gloo group started from the JAX
package's coordinator arguments (``initialize("127.0.0.1:PORT", 2, rank)``)
and exercise ``barrier``, the file-pickle Evaluator gather (rank 0 merges
every rank's results in rank order, the others get None), the MLP cache
sync (rank-strided fills union into a full cache, the other rank's entries
exact) and ``parallel.mesh.gather_to_host``, which stacks every rank's
result in rank order (JAX's ``process_allgather``). Each process has a time limit. Without a coordinator ``initialize``
is a no-op returning (0, 1), as the JAX package's.
"""

import os
import os.path as osp
import socket
import subprocess
import sys

from ihmr_tpu_torch.parallel import dist
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

_WORKER = r"""
import sys

sys.path.insert(0, sys.argv[4])
rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]

import torch

torch.set_num_threads(1)
from ihmr_tpu_torch.parallel import dist

r, w = dist.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
assert (r, w) == (rank, 2), (r, w)
dist.barrier("start")

from ihmr_tpu_torch.eval.evaluator import Evaluator

ev = Evaluator(data_list=[])
ev.gather_pred([{"img_path_relative": f"rank{rank}_{i}", "payload": rank * 100 + i} for i in range(3)])
merged = dist.gather_evaluators(ev, workdir, "gather_test", rank, w)
if rank == 0:
    got = [p["img_path_relative"] for p in merged.pred_results]
    assert got == [f"rank{r}_{i}" for r in range(2) for i in range(3)], got
    assert {p["img_path_relative"]: p["payload"] for p in merged.pred_results}["rank1_2"] == 102
    print("GATHER_OK")
else:
    assert merged is None

from ihmr_tpu_torch.refine.mlp_engine import _TRACKED, MLPCaches
from ihmr_tpu_torch.refine.schedule import PARAM_GROUP_DIMS

N = 8
caches = MLPCaches(num_data=N, device="cpu")
idx = torch.arange(rank, N, 2)
feat = idx[:, None].float().repeat(1, 1024)
params = {name: (idx[:, None] * 10 + d).float().repeat(1, d) for name, d in PARAM_GROUP_DIMS.items()}
losses = {k: idx.float() + j for j, k in enumerate(_TRACKED)}
caches.save(idx, feat, params, losses)
dist.barrier("saved")
caches = dist.sync_mlp_caches(caches, workdir, rank, w)
assert bool(caches.exists.all()), caches.exists
other = torch.arange(1 - rank, N, 2)
assert bool((caches.img_feat[other, 0] == other).all())
for name, d in PARAM_GROUP_DIMS.items():
    assert bool((caches.prev_params[name][other, 0] == other * 10 + d).all()), name
for j, k in enumerate(_TRACKED):
    assert bool((caches.prev_losses[k][other] == other + j).all()), k
print("CACHES_OK")

import numpy as np

from ihmr_tpu_torch.parallel import gather_to_host, make_mesh, shard_batch

mesh = make_mesh(["cpu"] * 2)
got = gather_to_host(shard_batch({"x": torch.arange(4.0) + 10 * rank}, mesh))
assert got["x"].shape == (2, 4), got
np.testing.assert_array_equal(got["x"], [[0, 1, 2, 3], [10, 11, 12, 13]])
got = gather_to_host((torch.tensor(rank, dtype=torch.int32),))
np.testing.assert_array_equal(got[0], [0, 1])
print("MESH_GATHER_OK")
dist.barrier("end")
print("WORKER_DONE")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gather_and_cache_sync(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(port), str(tmp_path), REPO], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
        assert "WORKER_DONE" in out and "CACHES_OK" in out and "MESH_GATHER_OK" in out
    assert "GATHER_OK" in outs[0][0]
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".gather_test")]  # rank 0 removed the files


def test_initialize_without_a_coordinator_is_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert dist.initialize() == (0, 1)
    dist.barrier("single")  # nothing to wait for
    caches = object()
    assert dist.sync_mlp_caches(caches, "/nonexistent", 0, 1) is caches

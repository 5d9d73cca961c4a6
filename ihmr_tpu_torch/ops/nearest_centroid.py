"""Streaming nearest-centroid selection: the Hopper kernel and its plain version.

Counterpart of ``ihmr_tpu/ops/pallas_collision.py::_nearest_kernel`` (the
TPU kernel K2, launched by ``nearest_centroid_pallas``). For every query it
returns the index of the triangle centroid c minimising |c|^2 - 2 q.c, in
fp32, with the TPU kernel's rules:

  * centroids are walked in 128-wide tiles, in order;
  * the rank is c2 - 2 * ((cx*qx + cy*qy) + cz*qz), each op rounded to fp32;
  * inside a tile, every centroid with rank <= the tile minimum is tied, and
    the tile's pick is the fp32 mean of the tied indices;
  * across tiles only a strictly smaller tile minimum replaces the best;
  * the output is that mean truncated to an integer;
  * queries are padded to a multiple of 128 by repeating query 0, centroids
    by repeating centroid 0 (masked by the true count).

The CUDA kernel is ``csrc/nearest_centroid.cu`` (built by
``ihmr_tpu_torch.build``). ``nearest_centroid_reference`` is the plain
PyTorch version of the same tile loop. The wrapper takes the plain version
only for CPU tensors; a CUDA tensor launches the kernel or raises. There is
no gradient: the index is a discrete choice, and the depth epilogue
(``ops/collision.py::pair_depths_fast``) differentiates through the chosen
triangle instead.
"""

from __future__ import annotations

import ctypes

import torch

Q_TILE = 128  # queries per block (one thread each)
T_TILE = 128  # centroids per tile
_BIG = 1e30

# launches of the CUDA kernel (incremented only where the kernel is launched)
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_inputs(query: torch.Tensor, centroid: torch.Tensor):
    """(N, V, 3) queries, (N, F, 3) centroids -> padded fp32 contiguous
    (N, Vp, 3) queries and (N, Fp, 4) rows (cx, cy, cz, |c|^2).

    |c|^2 is (cx*cx + cy*cy) + cz*cz, the order of the JAX wrapper's jitted
    ``jnp.sum(cT * cT, axis=0)``."""
    N, V, _ = query.shape
    F = centroid.shape[1]
    Vp, Fp = _round_up(V, Q_TILE), _round_up(F, T_TILE)
    q = query.float()
    c = centroid.float()
    q = torch.cat([q, q[:, :1].expand(N, Vp - V, 3)], dim=1).contiguous()
    c = torch.cat([c, c[:, :1].expand(N, Fp - F, 3)], dim=1)
    c2 = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) + c[..., 2] * c[..., 2]
    return q, torch.cat([c, c2[..., None]], dim=-1).contiguous()


def nearest_centroid_reference(q: torch.Tensor, cent: torch.Tensor, n_tri: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on padded inputs (``pad_inputs``):
    q (N, Vp, 3), cent (N, Fp, 4) -> (N, Vp) int32 index."""
    N, Vp, _ = q.shape
    best = torch.full((N, Vp), _BIG, dtype=torch.float32, device=q.device)
    best_idx = torch.zeros((N, Vp), dtype=torch.float32, device=q.device)
    big = torch.tensor(_BIG, dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    qx, qy, qz = (q[..., i, None] for i in range(3))  # (N, Vp, 1)
    for t in range(cent.shape[1] // T_TILE):
        tile = cent[:, None, t * T_TILE : (t + 1) * T_TILE]  # (N, 1, 128, 4)
        cx, cy, cz, c2 = tile.unbind(-1)
        rank = c2 - 2.0 * ((cx * qx + cy * qy) + cz * qz)  # (N, Vp, 128)
        ids = torch.arange(t * T_TILE, (t + 1) * T_TILE, device=q.device)
        rank = torch.where(ids < n_tri, rank, big)
        tile_min = rank.amin(-1)
        is_min = rank <= tile_min[..., None]
        count = torch.clamp(is_min.sum(-1).float(), min=1.0)
        tile_idx = torch.where(is_min, ids.float(), zero).sum(-1) / count
        better = tile_min < best
        best = torch.where(better, tile_min, best)
        best_idx = torch.where(better, tile_idx, best_idx)
    return best_idx.to(torch.int32)


def _launch_kernel(q: torch.Tensor, cent: torch.Tensor, n_tri: int) -> torch.Tensor:
    """Launch csrc/nearest_centroid.cu on padded CUDA inputs -> (N, Vp) int32."""
    from ihmr_tpu_torch.build import load_library

    global launch_count
    N, Vp, _ = q.shape
    Fp = cent.shape[1]
    for x, shape in ((q, (N, Vp, 3)), (cent, (N, Fp, 4))):
        if x.dtype != torch.float32 or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"kernel input must be contiguous fp32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError("kernel inputs must lie on one device")
    if Vp % Q_TILE or Fp % T_TILE or not 0 < n_tri <= Fp:
        raise ValueError(f"bad padded sizes Vp={Vp} Fp={Fp} n_tri={n_tri}")
    if cent.data_ptr() % 16:
        raise ValueError("centroid rows are read as float4 and must be 16-byte aligned")
    lib = load_library("nearest_centroid")
    fn = lib.ihmr_nearest_centroid_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    index = torch.empty((N, Vp), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), cent.data_ptr(), index.data_ptr(), N, Vp, Fp, n_tri, stream)
    if err != 0:
        raise RuntimeError(f"nearest_centroid kernel launch failed: cudaError {err}")
    launch_count += 1
    return index


def nearest_centroid(query: torch.Tensor, centroid: torch.Tensor) -> torch.Tensor:
    """(N, V, 3) queries, (N, F, 3) centroids -> (N, V) int64 index of each
    query's nearest centroid. Kernel on CUDA tensors, plain version on CPU
    tensors; no gradient."""
    if query.dim() != 3 or centroid.dim() != 3 or query.shape[-1] != 3 or centroid.shape[-1] != 3:
        raise ValueError(f"expected (N, V, 3) and (N, F, 3), got {tuple(query.shape)} {tuple(centroid.shape)}")
    if query.shape[0] != centroid.shape[0] or query.device != centroid.device:
        raise ValueError("queries and centroids need the same leading dim and device")
    V, F = query.shape[1], centroid.shape[1]
    with torch.no_grad():
        q, cent = pad_inputs(query.detach(), centroid.detach())
        if q.is_cuda:
            index = _launch_kernel(q, cent, F)
        elif q.device.type == "cpu":
            index = nearest_centroid_reference(q, cent, F)
        else:
            raise RuntimeError(f"no nearest-centroid implementation for device {q.device}")
    return index[:, :V].long()

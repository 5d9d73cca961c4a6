"""Exact point-to-mesh penetration depth: the Hopper kernel and its plain version.

Counterpart of ``ihmr_tpu/ops/pallas_collision.py::_kernel`` (the TPU kernel
K1, launched by ``_forward``; public entries ``penetration_depth_pallas`` and
``pair_depths_pallas``). For every query point and every triangle of the
other mesh it computes the exact squared distance (branchless Ericson region
selection) and the sign dot(q - closest, face normal); the depth is
sqrt(max(best d2, 1e-12)) where the tie-averaged dot is negative, else 0.

Semantics kept from the TPU kernel, because they decide the inside sign at
silhouette edges and which near-ties get aggregated:

  * triangles are walked in 128-wide tiles, in order;
  * inside a tile: the tile minimum, then the mean dot and mean q - closest
    over every triangle with d2 <= tile_min * (1 + 1e-3) + 1e-12;
  * across tiles: a tile with tile_min < best * (1 - 1e-3) replaces the
    accumulator, a tile with tile_min <= best * (1 + 1e-3) + 1e-12 adds to it;
  * a 128-query block skips a tile unless max over its queries of
    (best - lb^2) >= 0, lb being the distance to the tile's bounding sphere;
  * queries are padded to a multiple of 128 by repeating query 0, triangles
    by repeating triangle 0 (masked by the true count).

The CUDA kernel is ``csrc/exact_collision.cu`` (built by ``ihmr_tpu_torch.build``).
``exact_penetration_depth_reference`` is the plain PyTorch version of the same
tile-ordered algorithm, vectorised over (direction, query, tile triangle).
The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ihmr_tpu_torch.build import kernel_function

Q_TILE = 128  # queries padded to a multiple of this (the pruning group of a block)
T_TILE = 128  # triangles per tile
TIE_REL = 1e-3  # relative d2 tolerance of the tie set
_BIG = 1e30
_EPS = 1e-12

# launches of the CUDA kernel (incremented only where the kernel is launched,
# under the lock: the shard threads of parallel/mesh.py launch at once)
launch_count = 0
_count_lock = threading.Lock()


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_inputs(query: torch.Tensor, tri: torch.Tensor):
    """(N, V, 3), (N, F, 9) -> padded fp32 contiguous (N, Vp, 3), (N, Fp, 9),
    and the per-tile bounding spheres (N, Fp / 128, 4) = (cx, cy, cz, r)."""
    N, V, _ = query.shape
    F = tri.shape[1]
    Vp, Fp = _round_up(V, Q_TILE), _round_up(F, T_TILE)
    q = query.float()
    t = tri.float()
    q = torch.cat([q, q[:, :1].expand(N, Vp - V, 3)], dim=1).contiguous()
    t = torch.cat([t, t[:, :1].expand(N, Fp - F, 9)], dim=1).contiguous()
    # bounding sphere of each tile over all three vertices of its triangles:
    # centre = AABB centre, radius = farthest vertex
    verts = t.reshape(N, Fp // T_TILE, T_TILE * 3, 3)
    centre = (verts.amin(dim=2) + verts.amax(dim=2)) * 0.5  # (N, T, 3)
    diff = verts - centre[:, :, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    radius = torch.sqrt(d2.amax(dim=2))
    bounds = torch.cat([centre, radius[..., None]], dim=-1).contiguous()
    return q, t, bounds


def _safe_div(num, den):
    den = torch.where(den.abs() < _EPS, torch.where(den < 0, -_EPS, _EPS), den)
    return num / den


def tile_d2_dot(q, tri):
    """Elementwise core of the kernel: q (..., 3), tri (..., 9) broadcast
    against each other -> (d2, dot, dx, dy, dz), q - closest = (dx, dy, dz)."""
    qx, qy, qz = q.unbind(-1)
    ax, ay, az, bx, by, bz, cx, cy, cz = tri.unbind(-1)
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = qx - ax, qy - ay, qz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2_ = acx * apx + acy * apy + acz * apz
    bpx, bpy, bpz = qx - bx, qy - by, qz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz
    cpx, cpy, cpz = qx - cx, qy - cy, qz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz
    va = d3 * d6 - d5 * d4
    vb = d5 * d2_ - d1 * d6
    vc = d1 * d4 - d3 * d2_

    v_ab = _safe_div(d1, d1 - d3)
    v_ac = _safe_div(d2_, d2_ - d6)
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = _safe_div(torch.ones_like(va), va + vb + vc)
    v_f = vb * denom
    w_f = vc * denom

    px = ax + v_f * abx + w_f * acx
    py = ay + v_f * aby + w_f * acy
    pz = az + v_f * abz + w_f * acz
    # region predicates in priority order, the last match wins
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    px = torch.where(in_bc, bx + w_bc * (cx - bx), px)
    py = torch.where(in_bc, by + w_bc * (cy - by), py)
    pz = torch.where(in_bc, bz + w_bc * (cz - bz), pz)
    in_ac = (vb <= 0) & (d2_ >= 0) & (d6 <= 0)
    px = torch.where(in_ac, ax + v_ac * acx, px)
    py = torch.where(in_ac, ay + v_ac * acy, py)
    pz = torch.where(in_ac, az + v_ac * acz, pz)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    px = torch.where(in_ab, ax + v_ab * abx, px)
    py = torch.where(in_ab, ay + v_ab * aby, py)
    pz = torch.where(in_ab, az + v_ab * abz, pz)
    in_c = (d6 >= 0) & (d5 <= d6)
    px = torch.where(in_c, cx + 0 * px, px)
    py = torch.where(in_c, cy + 0 * py, py)
    pz = torch.where(in_c, cz + 0 * pz, pz)
    in_b = (d3 >= 0) & (d4 <= d3)
    px = torch.where(in_b, bx + 0 * px, px)
    py = torch.where(in_b, by + 0 * py, py)
    pz = torch.where(in_b, bz + 0 * pz, pz)
    in_a = (d1 <= 0) & (d2_ <= 0)
    px = torch.where(in_a, ax + 0 * px, px)
    py = torch.where(in_a, ay + 0 * py, py)
    pz = torch.where(in_a, az + 0 * pz, pz)

    dx, dy, dz = qx - px, qy - py, qz - pz
    d2 = dx * dx + dy * dy + dz * dz
    nx = aby * acz - abz * acy
    ny = abz * acx - abx * acz
    nz = abx * acy - aby * acx
    dot = dx * nx + dy * ny + dz * nz
    return d2, dot, dx, dy, dz


def exact_penetration_depth_reference(
    q: torch.Tensor, tri: torch.Tensor, bounds: torch.Tensor, n_tri: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on padded inputs (``pad_inputs``).

    q (N, Vp, 3), tri (N, Fp, 9), bounds (N, Fp/128, 4) -> (depth (N, Vp),
    dir (N, Vp, 3), evaluated (N, Vp/128, Fp/128) bool: the (query block,
    triangle tile) pairs the pruning rule let through)."""
    N, Vp, _ = q.shape
    n_qt, n_tt = Vp // Q_TILE, tri.shape[1] // T_TILE
    best = torch.full((N, Vp), _BIG, dtype=q.dtype, device=q.device)
    acc = torch.zeros((N, Vp, 4), dtype=q.dtype, device=q.device)  # dot, dx, dy, dz
    evaluated = torch.zeros((N, n_qt, n_tt), dtype=torch.bool, device=q.device)
    big = torch.tensor(_BIG, dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for t in range(n_tt):
        c = bounds[:, t]  # (N, 4)
        dd = q - c[:, None, :3]
        lb = torch.clamp(
            torch.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + dd[..., 2] * dd[..., 2])
            - c[:, None, 3],
            min=0.0,
        )
        need = (best - lb * lb).reshape(N, n_qt, Q_TILE).amax(-1) >= 0.0  # (N, n_qt)
        evaluated[:, :, t] = need
        tile = tri[:, None, t * T_TILE : (t + 1) * T_TILE]  # (N, 1, 128, 9)
        d2, dot, dx, dy, dz = tile_d2_dot(q[:, :, None, :], tile)  # (N, Vp, 128)
        valid = torch.arange(t * T_TILE, (t + 1) * T_TILE, device=q.device) < n_tri
        d2 = torch.where(valid, d2, big)
        tile_min = d2.amin(-1)  # (N, Vp)
        is_min = d2 <= (tile_min * (1.0 + TIE_REL) + 1e-12)[..., None]
        norm = torch.clamp(is_min.sum(-1).to(q.dtype), min=1.0)
        val = torch.stack(
            [torch.where(is_min, x, zero).sum(-1) for x in (dot, dx, dy, dz)], dim=-1
        ) / norm[..., None]
        better = tile_min < best * (1.0 - TIE_REL)
        tied = ~better & (tile_min <= best * (1.0 + TIE_REL) + 1e-12)
        new_best = torch.where(better, tile_min, torch.minimum(best, torch.where(tied, tile_min, big)))
        new_acc = torch.where(
            better[..., None], val, torch.where(tied[..., None], acc + val, acc)
        )
        need_q = need.repeat_interleave(Q_TILE, dim=1)  # (N, Vp)
        best = torch.where(need_q, new_best, best)
        acc = torch.where(need_q[..., None], new_acc, acc)
    dist = torch.sqrt(torch.clamp(best, min=1e-12))
    inside = acc[..., 0] < 0
    depth = torch.where(inside, dist, zero)
    scale = torch.where(inside, 1.0 / dist, zero)
    return depth, acc[..., 1:] * scale[..., None], evaluated


# the C entry point's arguments: query, tri, bounds, depth, dir, n, vp, fp, n_tri, stream
_FORWARD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch_kernel(q, tri, bounds, n_tri):
    """Launch csrc/exact_collision.cu on padded CUDA inputs."""
    global launch_count
    N, Vp, _ = q.shape
    Fp = tri.shape[1]
    for x, shape in ((q, (N, Vp, 3)), (tri, (N, Fp, 9)), (bounds, (N, Fp // T_TILE, 4))):
        if x.dtype != torch.float32 or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"kernel input must be contiguous fp32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError("kernel inputs must lie on one device")
    if Vp % Q_TILE or Fp % T_TILE or not 0 < n_tri <= Fp:
        raise ValueError(f"bad padded sizes Vp={Vp} Fp={Fp} n_tri={n_tri}")
    if bounds.data_ptr() % 16:
        raise ValueError("tile bounds are read as float4 and must be 16-byte aligned")
    fn = kernel_function("exact_collision", "ihmr_exact_collision_forward", _FORWARD_ARGS)
    depth = torch.empty((N, Vp), dtype=torch.float32, device=q.device)
    dirs = torch.empty((N, Vp, 3), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), tri.data_ptr(), bounds.data_ptr(), depth.data_ptr(), dirs.data_ptr(),
            N, Vp, Fp, n_tri, stream,
        )
    if err != 0:
        raise RuntimeError(f"exact_collision kernel launch failed: cudaError {err}")
    with _count_lock:
        launch_count += 1
    return depth, dirs


def kernel_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's division, ``_safe_div(num, den)``, elementwise on
    contiguous fp32 CUDA tensors of one shape: a check that its branch-free
    fast path rounds as an IEEE division does. Not on any path; not counted."""
    if not (num.is_cuda and den.device == num.device and num.shape == den.shape):
        raise ValueError("kernel_divide takes two CUDA tensors of one shape")
    num, den = num.float().contiguous(), den.float().contiguous()
    fn = kernel_function(
        "exact_collision", "ihmr_exact_collision_divide", [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    )
    out = torch.empty_like(num)
    with torch.cuda.device(num.device):
        err = fn(num.data_ptr(), den.data_ptr(), out.data_ptr(), num.numel(), torch.cuda.current_stream(num.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exact_collision divide check failed to launch: cudaError {err}")
    return out


def exact_penetration_depth_with_dir(query: torch.Tensor, tri: torch.Tensor):
    """(N, V, 3) queries against (N, F, 9) triangles -> (depth (N, V), unit
    inward direction (N, V, 3)). Kernel on CUDA tensors, plain version on
    CPU tensors; no gradient."""
    if query.dim() != 3 or tri.dim() != 3 or query.shape[-1] != 3 or tri.shape[-1] != 9:
        raise ValueError(f"expected (N, V, 3) and (N, F, 9), got {tuple(query.shape)} {tuple(tri.shape)}")
    if query.shape[0] != tri.shape[0] or query.device != tri.device:
        raise ValueError("query and triangles need the same leading dim and device")
    V, F = query.shape[1], tri.shape[1]
    with torch.no_grad():
        q, t, bounds = pad_inputs(query.detach(), tri.detach())
        if q.is_cuda:
            depth, dirs = _launch_kernel(q, t, bounds, F)
        elif q.device.type == "cpu":
            depth, dirs, _ = exact_penetration_depth_reference(q, t, bounds, F)
        else:
            raise RuntimeError(f"no exact-collision implementation for device {q.device}")
    return depth[:, :V], dirs[:, :V]


class _ExactDepth(torch.autograd.Function):
    """depth with the analytic gradient d depth / d q = dir (the unit inward
    direction at the closest point); the triangles get a zero gradient (the
    mesh side is detached, as in the reference's non-differentiable grid)."""

    @staticmethod
    def forward(ctx, query, tri):
        depth, dirs = exact_penetration_depth_with_dir(query, tri)
        ctx.save_for_backward(dirs)
        ctx.tri_shape = tri.shape
        return depth

    @staticmethod
    def backward(ctx, g):
        (dirs,) = ctx.saved_tensors
        g_tri = g.new_zeros(ctx.tri_shape) if ctx.needs_input_grad[1] else None
        return g[..., None] * dirs, g_tri


def exact_penetration_depth(query: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Differentiable exact depth: (N, V, 3), (N, F, 9) -> (N, V)."""
    return _ExactDepth.apply(query, tri)


def pair_depths_exact(
    right_verts: torch.Tensor,  # (B, V, 3)
    left_verts: torch.Tensor,  # (B, V, 3)
    faces_right: torch.Tensor,  # (F, 3)
    faces_left: torch.Tensor,  # (F, 3)
) -> torch.Tensor:
    """(B, 2V) depths [right verts into the left mesh | left verts into the
    right mesh], both directions in ONE launch (N = 2B)."""
    B = right_verts.shape[0]
    tri_l = left_verts.detach()[:, faces_left].reshape(B, -1, 9)
    tri_r = right_verts.detach()[:, faces_right].reshape(B, -1, 9)
    depth = exact_penetration_depth(
        torch.cat([right_verts, left_verts], dim=0), torch.cat([tri_l, tri_r], dim=0)
    )
    return torch.cat([depth[:B], depth[B:]], dim=1)

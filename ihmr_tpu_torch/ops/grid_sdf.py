"""The reference's in-loop collision field: a per-hand penetration grid,
sampled trilinearly (port of ihmr_tpu/ops/grid_sdf.py).

Per hand, a ``res``^3 lattice of points over a padded isotropic cube (the
hand's AABB, or the caller's box, e.g. the padded intersection of the two
hands' boxes, ``_focus_box``); the K-candidate penetration depth
(ops/collision.py::penetration_depth) at every lattice point gives a phi >= 0
field, 0 outside the mesh. phi at any query is the trilinear interpolation of
the grid inside a zero shell, differentiable in the query; the grid itself is
detached, as the reference's voxelization takes no gradient.

Arithmetic kept from the JAX package as XLA compiles it on the CPU, where
the two packages are compared:
  * the lattice coordinates are JAX's jitted ``linspace(-1, 1, res)``:
    i * fp32(1/(res-1)) (XLA turns the division by a constant into a product
    with its reciprocal), then -(1 - t) + t; ``torch.linspace`` rounds 20 of
    the 32 coordinates of res 32 differently;
  * the lattice points center + half * g, and the padded-grid coordinate
    u * (res - 1) + 1, are one fused multiply-add each (XLA's CPU backend
    contracts them); the port rounds once through float64;
  * the clip takes ``torch.maximum``/``torch.minimum``, which split the
    gradient at a tie as ``jnp.clip`` does (``torch.clamp`` gives 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ihmr_tpu_torch.ops.collision import penetration_depth

# (query row x face) pairs of one penetration-depth call in the grid build:
# the rank's fp32 temporaries take ~20 bytes a pair, so ~1.3 GB at peak
BUILD_CHUNK_PAIRS = 1 << 26


def lattice(res: int, device=None) -> torch.Tensor:
    """(res,) fp32 coordinates of JAX's jitted ``jnp.linspace(-1.0, 1.0, res)``."""
    n = res - 1
    step = torch.ones((), dtype=torch.float32) / n  # the fp32 reciprocal
    t = torch.arange(n, dtype=torch.float32, device=device) * step.to(device)
    lin = -(1.0 - t) + t
    return torch.cat([lin, torch.ones(1, dtype=torch.float32, device=device)])


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to fp32 (the product of two fp32 is exact in
    float64), as XLA's contracted multiply-add computes it."""
    return (a.double() * b.double() + c.double()).float()


def _chunked_depth(pts: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor, num_candidates: int) -> torch.Tensor:
    """(B, P) ``penetration_depth`` of (B, P, 3) points, in calls of at most
    ``BUILD_CHUNK_PAIRS`` (row x face) pairs, whole samples where they fit,
    else row slices of one sample. Rows are independent, so every chunking
    gives the same bits."""
    B, P, _ = pts.shape
    rows = max(1, BUILD_CHUNK_PAIRS // faces.shape[0])
    if P <= rows:
        per = max(1, rows // P)
        return torch.cat(
            [penetration_depth(pts[i:i + per], verts[i:i + per], faces, num_candidates) for i in range(0, B, per)]
        )
    return torch.cat(
        [
            torch.cat(
                [penetration_depth(pts[i:i + 1, s:s + rows], verts[i:i + 1], faces, num_candidates)
                 for s in range(0, P, rows)],
                dim=1,
            )
            for i in range(B)
        ]
    )


@torch.no_grad()
def build_penetration_grid(
    verts: torch.Tensor,  # (B, Vm, 3)
    faces: torch.Tensor,  # (F, 3)
    res: int = 32,
    pad: float = 0.2,
    num_candidates: int = 8,
    box: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (phi (B, res, res, res), cube centre (B, 3), cube half-extent (B,)).

    The cube is the hand's AABB grown to its largest side times (1 + pad),
    or the caller's ``box=(centre, half)``. Detached. The build is chunked
    (``BUILD_CHUNK_PAIRS``) so its peak memory does not grow with the batch:
    one hand of one sample at res 32 and 1538 faces ranks 50.4M pairs."""
    verts = verts.detach()
    if box is not None:
        center, half = box
    else:
        vmin, vmax = verts.amin(dim=1), verts.amax(dim=1)
        center = 0.5 * (vmin + vmax)
        half = 0.5 * (vmax - vmin).amax(dim=-1) * (1.0 + pad)
    lin = lattice(res, verts.device)
    g = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(1, -1, 3)  # (1, res^3, 3)
    pts = _fma(half[:, None, None], g, center[:, None, :])  # (B, res^3, 3)
    phi = _chunked_depth(pts, verts, faces, num_candidates)
    return phi.reshape(-1, res, res, res), center, half


def trilinear_sample(
    grid: torch.Tensor,  # (B, res, res, res)
    center: torch.Tensor,  # (B, 3)
    half: torch.Tensor,  # (B,)
    q: torch.Tensor,  # (B, V, 3)
) -> torch.Tensor:
    """(B, V) trilinearly interpolated phi at the queries, 0 outside the cube
    (the grid is padded with a zero shell and the coordinates clipped to it).
    Differentiable in ``q``; eight flat gathers at fixed corner offsets."""
    B, res = grid.shape[0], grid.shape[1]
    P = res + 2
    g = torch.nn.functional.pad(grid.detach(), (1, 1, 1, 1, 1, 1)).reshape(B, -1)  # (B, P^3)
    u = (q - center[:, None, :]) / (2.0 * half)[:, None, None] + 0.5  # [0, 1] inside the cube
    x = _fma(u, torch.full_like(u, res - 1), torch.ones_like(u))  # padded-grid coordinates
    lo = torch.zeros((), dtype=x.dtype, device=x.device)
    hi = torch.tensor(res + 1 - 1.0 - 1e-6, dtype=x.dtype, device=x.device)
    x = torch.minimum(torch.maximum(x, lo), hi)  # jnp.clip, with its tie gradient
    x0 = torch.floor(x)
    f = x - x0
    i0 = x0.long()
    base = (i0[..., 0] * P + i0[..., 1]) * P + i0[..., 2]  # (B, V)

    def at(dx, dy, dz):
        return torch.gather(g, 1, base + ((dx * P + dy) * P + dz))

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


@torch.no_grad()
def _focus_box(
    mesh_self: torch.Tensor,  # (B, Vm, 3) the hand being voxelized
    mesh_other: torch.Tensor,  # (B, Vm, 3) the hand whose vertices sample phi
    pad: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centre (B, 3), half (B,)) of the padded isotropic cube over the
    INTERSECTION of the two hands' AABBs: a vertex that penetrates this hand
    lies in both boxes. Its half-width is floored at 2% of this hand's
    extent, so boxes that do not overlap give a tiny cube at the gap."""
    lo_s, hi_s = mesh_self.amin(dim=1), mesh_self.amax(dim=1)
    lo_o, hi_o = mesh_other.amin(dim=1), mesh_other.amax(dim=1)
    lo = torch.maximum(lo_s, lo_o)
    hi = torch.minimum(hi_s, hi_o)
    center = 0.5 * (lo + hi)
    width = (hi - lo).amax(dim=-1)
    floor = 0.02 * (hi_s - lo_s).amax(dim=-1)
    half = 0.5 * torch.maximum(width, floor) * (1.0 + pad)
    return center, half


def pair_grids(
    mesh_r: torch.Tensor,  # (B, 778, 3)
    mesh_l: torch.Tensor,  # (B, 778, 3)
    faces_right: torch.Tensor,
    faces_left: torch.Tensor,
    res: int = 32,
    num_candidates: int = 8,
    face_subsample: int = 1,
    focus: bool = False,
):
    """Both hands' grids: ((grid_l, c_l, h_l), (grid_r, c_r, h_r)); grid_l is
    sampled by RIGHT queries and vice versa. ``face_subsample`` builds each
    field from every k-th (Morton-sorted) face over the full vertex array;
    ``focus`` places each lattice over ``_focus_box`` instead of the whole
    hand."""
    if face_subsample > 1:
        faces_right = faces_right[::face_subsample]
        faces_left = faces_left[::face_subsample]
    box_l = _focus_box(mesh_l, mesh_r) if focus else None
    box_r = _focus_box(mesh_r, mesh_l) if focus else None
    return (
        build_penetration_grid(mesh_l, faces_left, res, num_candidates=num_candidates, box=box_l),
        build_penetration_grid(mesh_r, faces_right, res, num_candidates=num_candidates, box=box_r),
    )


def pair_depths_grid(query_r: torch.Tensor, query_l: torch.Tensor, grids) -> torch.Tensor:
    """(B, 2*Vq) trilinear phi of live queries against ``pair_grids``' fields."""
    (g_l, c_l, h_l), (g_r, c_r, h_r) = grids
    return torch.cat([trilinear_sample(g_l, c_l, h_l, query_r), trilinear_sample(g_r, c_r, h_r, query_l)], dim=1)

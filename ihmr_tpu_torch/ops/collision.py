"""Interpenetration loss between two hand meshes (port of
ihmr_tpu/ops/collision.py, all backends but the 2-level hierarchy).

  * in the refinement loop: nearest-centroid face selection
    (``nearest_face_indices`` / ``pair_indices``, the JAX package's bf16 rank)
    and the exact depth against the selected triangles, either at the current
    positions (``pair_depths_at``) or at block-frozen ones (``pair_tris_at``
    then ``pair_depths_at_tris``);
  * the K-candidate depth (``penetration_depth``, the ``"xla"`` backend):
    the K nearest centroids by the same rank, each refined exactly, with the
    tie-set pseudonormal inside test; K=1 takes the argmin face alone;
  * the reference's grid field (``"grid"``, ops/grid_sdf.py);
  * the final metric: ``collision_loss`` with the exact kernel
    (ops/exact_collision.py, the port of the TPU kernel K1), ANDed with the
    ray-parity inside test (``ray_parity_inside``);
  * the MLP training loop: ``collision_loss(backend="fast")``, each query's
    nearest-centroid triangle (ops/nearest_centroid.py, the port of the TPU
    kernel K2) and the exact depth against that one triangle
    (``pair_depths_fast``).

Outputs follow the reference triple: (batch-mean loss, per-sample loss (B,),
per-vertex origin-scale depths (B, 2*Vq)), vertex order [right | left].
Not ported: the 2-level hierarchy (``loop_collision_cluster``) and the merged
payload builder ``pair_select_tris`` (an environment switch of the JAX engine).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ihmr_tpu_torch.ops.exact_collision import pair_depths_exact
from ihmr_tpu_torch.ops.nearest_centroid import nearest_centroid

_EPS = 1e-12
# relative squared-distance tolerance of the pseudonormal tie set (the
# K-candidate depth and the exact kernel)
_TIE_REL = 1e-3


def point_triangle_closest(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Closest point on triangle(s) to point(s): p (..., 3), tri (..., 3, 3).

    Branchless Ericson region test with safe denominators (differentiable)."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe_div(num, den):
        den = torch.where(den.abs() < _EPS, torch.where(den < 0, -_EPS, _EPS), den)
        return num / den

    v_ab = safe_div(d1, d1 - d3)
    p_ab = a + v_ab[..., None] * ab
    v_ac = safe_div(d2, d2 - d6)
    p_ac = a + v_ac[..., None] * ac
    v_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    p_bc = b + v_bc[..., None] * (c - b)
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    p_face = a + (vb * denom)[..., None] * ab + (vc * denom)[..., None] * ac

    # region predicates in priority order, the last match wins
    out = p_face
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    out = torch.where(in_bc[..., None], p_bc, out)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = torch.where(in_ac[..., None], p_ac, out)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = torch.where(in_ab[..., None], p_ab, out)
    in_c = (d6 >= 0) & (d5 <= d6)
    out = torch.where(in_c[..., None], c, out)
    in_b = (d3 >= 0) & (d4 <= d3)
    out = torch.where(in_b[..., None], b, out)
    in_a = (d1 <= 0) & (d2 <= 0)
    out = torch.where(in_a[..., None], a, out)
    return out


def _shell_depth(dist: torch.Tensor, inside: torch.Tensor, margin: float) -> torch.Tensor:
    """Depth with an outward shell: max(0, margin - signed_dist); margin=0 is
    the plain inside-only depth."""
    if margin == 0.0:
        return torch.where(inside, dist, torch.zeros_like(dist))
    signed = torch.where(inside, -dist, dist)
    return torch.maximum(margin - signed, torch.zeros_like(signed))  # jnp.maximum's tie gradient


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to bf16 (nearest even) and back."""
    return x.to(torch.bfloat16).float()


def _centroids(tri: torch.Tensor) -> torch.Tensor:
    """(..., F, 3, 3) -> (..., F, 3) as jitted JAX computes ``jnp.mean(tri,
    axis=-2)``: (a + b + c) * fp32(1/3)."""
    return ((tri[..., 0, :] + tri[..., 1, :]) + tri[..., 2, :]) * (1.0 / 3.0)


def _centroid_rank(query: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(B, V, F) rank |c|^2 - 2 q.c of every query against every centroid of
    the (B, F, 3, 3) triangles, with the arithmetic the JAX package's jitted
    bf16 rank compiles to: centroids as (a + b + c) * fp32(1/3), operands
    rounded to bf16, products and sums in fp32, and |c|^2, q.c and the rank
    each rounded to bf16 (XLA keeps the products and sums inside its fusions
    in fp32; rounding after every op, as eager JAX does, picks another face
    for ~3% of queries). No gradient."""
    cb = _bf16(_centroids(tri.detach()))  # (B, F, 3)
    qb = _bf16(query.detach())
    c2 = _bf16((cb[..., 0] * cb[..., 0] + cb[..., 1] * cb[..., 1]) + cb[..., 2] * cb[..., 2])
    q, c = qb[:, :, None, :], cb[:, None, :, :]
    qc = _bf16((q[..., 0] * c[..., 0] + q[..., 1] * c[..., 1]) + q[..., 2] * c[..., 2])  # (B, V, F)
    return _bf16(c2[:, None, :] - 2.0 * qc)


def _min_k_indices(rank: torch.Tensor, k: int) -> torch.Tensor:
    """(..., F) bf16-valued fp32 rank -> (..., k) indices of the k smallest,
    ascending, equal ranks taken lowest index first. The key packs the
    rank's order-preserving integer image above the index, so every key is
    distinct and ``topk`` has one answer on any device. (JAX's
    ``approx_min_k`` returns the same k values; under ties its CPU fallback
    sort may keep other indices.)"""
    bits = rank.contiguous().view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()  # monotone in the float value
    key = ordered * rank.shape[-1] + torch.arange(rank.shape[-1], device=rank.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def nearest_face_indices(
    query: torch.Tensor,  # (B, V, 3)
    mesh_verts: torch.Tensor,  # (B, Vm, 3)
    faces: torch.Tensor,  # (F, 3)
) -> torch.Tensor:
    """(B, V) nearest-centroid face index by the bf16 rank of
    ``_centroid_rank``; ties go to the first index. Selection only, no
    gradient."""
    return _centroid_rank(query, mesh_verts.detach()[:, faces]).argmin(dim=-1)


def penetration_depth(
    query: torch.Tensor,  # (B, V, 3)
    mesh_verts: torch.Tensor,  # (B, Vm, 3)
    faces: torch.Tensor,  # (F, 3), outward winding
    num_candidates: int = 8,
    margin: float = 0.0,
) -> torch.Tensor:
    """(B, V) penetration depth of each query into the other hand's closed
    mesh: 0 outside, or the outward shell of ``_shell_depth`` when
    ``margin`` > 0. The mesh side is detached, the query side differentiable.

    The ``num_candidates`` nearest centroids by the bf16 rank are refined
    exactly (point-triangle distance). K=1 takes the argmin face and its
    normal's sign. K>1 takes the least distance over the candidates and the
    pseudonormal test over the TIE SET, the candidates within a relative
    ``_TIE_REL`` of the least squared distance: at a silhouette edge or
    vertex both adjacent faces tie and a single face's normal would give the
    wrong sign."""
    tri = mesh_verts.detach()[:, faces]  # (B, F, 3, 3)
    rank = _centroid_rank(query, tri)
    if num_candidates == 1:
        idx = rank.argmin(dim=-1)  # (B, V)
        tri_best = torch.gather(tri, 1, idx[..., None, None].expand(-1, -1, 3, 3))
        return _depth_at_tris_single(query, tri_best, margin)
    idx = _min_k_indices(rank, num_candidates)  # (B, V, K)
    B, V, K = idx.shape
    tri_k = torch.gather(tri, 1, idx.reshape(B, V * K)[..., None, None].expand(-1, -1, 3, 3))
    return _depth_over_candidates(query, tri_k.reshape(B, V, K, 3, 3), margin)


def _depth_over_candidates(query: torch.Tensor, tri_k: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """(B, V, 3) queries, (B, V, K, 3, 3) candidate triangles -> (B, V): the
    least exact distance over the candidates, signed by the tie-set
    pseudonormal test."""
    q = query[:, :, None, :]
    closest = point_triangle_closest(q, tri_k)  # (B, V, K, 3)
    diff = q - closest
    dist2 = (diff * diff).sum(-1)  # (B, V, K)
    d2_best = dist2.amin(dim=-1)  # ties share the gradient, as jnp.min's
    dist = torch.sqrt(torch.maximum(d2_best, torch.full_like(d2_best, _EPS)))
    normal_k = torch.linalg.cross(tri_k[..., 1, :] - tri_k[..., 0, :], tri_k[..., 2, :] - tri_k[..., 0, :])
    dot_k = (diff * normal_k).sum(-1)
    tie = dist2 <= d2_best[..., None] * (1.0 + _TIE_REL) + _EPS
    inside = torch.where(tie, dot_k, torch.zeros_like(dot_k)).sum(-1) < 0
    return _shell_depth(dist, inside, margin)


def _pair_depths(
    right_verts: torch.Tensor,  # (B, 778, 3)
    left_verts: torch.Tensor,  # (B, 778, 3)
    faces_right: torch.Tensor,
    faces_left: torch.Tensor,
    num_candidates: int,
    query_subsample: int = 1,
    margin: float = 0.0,
) -> torch.Tensor:
    """(B, 2*Vq) K-candidate depths: right verts into the left mesh, then left
    verts into the right mesh. ``query_subsample`` strides the queries only;
    the mesh side stays the full vertex array the faces index."""
    s = query_subsample
    return torch.cat(
        [
            penetration_depth(right_verts[:, ::s], left_verts, faces_left, num_candidates, margin),
            penetration_depth(left_verts[:, ::s], right_verts, faces_right, num_candidates, margin),
        ],
        dim=1,
    )


def pair_indices(query_r, query_l, mesh_r, mesh_l, faces_right, faces_left):
    """Nearest-face selections for both directions: right queries against the
    FULL left mesh and vice versa -> (idx_r, idx_l), each (B, Vq)."""
    return (
        nearest_face_indices(query_r, mesh_l, faces_left),
        nearest_face_indices(query_l, mesh_r, faces_right),
    )


def pair_tris_at(mesh_r, mesh_l, faces_right, faces_left, idx_r, idx_l):
    """The selected triangles' positions for both directions, (B, Vq, 3, 3)
    each, detached: the block-frozen payload of the refinement loop."""

    def build(mesh, faces, idx):
        tri = mesh.detach()[:, faces].reshape(mesh.shape[0], -1, 9)  # (B, F, 9)
        sel = torch.gather(tri, 1, idx[..., None].expand(-1, -1, 9))
        return sel.reshape(idx.shape[0], idx.shape[1], 3, 3)

    return build(mesh_l, faces_left, idx_r), build(mesh_r, faces_right, idx_l)


def penetration_depth_at(
    query: torch.Tensor,  # (B, V, 3)
    mesh_verts: torch.Tensor,  # (B, Vm, 3)
    faces: torch.Tensor,  # (F, 3)
    idx: torch.Tensor,  # (B, V) face index per query
    margin: float = 0.0,
) -> torch.Tensor:
    """(B, V) depth against the GIVEN face per query at the mesh's current
    positions: the K=1 refinement with the selection factored out, so a
    selection can be reused over steps while the faces track the mesh. The
    mesh side is detached."""
    tri = mesh_verts.detach()[:, faces]  # (B, F, 3, 3)
    tri_best = torch.gather(tri, 1, idx[..., None, None].expand(-1, -1, 3, 3))
    return _depth_at_tris_single(query, tri_best, margin)


def pair_depths_at(query_r, query_l, mesh_r, mesh_l, faces_right, faces_left, idx_r, idx_l, margin: float = 0.0):
    """(B, 2*Vq) depths at given face selections, both directions: right
    queries against the FULL left mesh and vice versa."""
    return torch.cat(
        [
            penetration_depth_at(query_r, mesh_l, faces_left, idx_r, margin),
            penetration_depth_at(query_l, mesh_r, faces_right, idx_l, margin),
        ],
        dim=1,
    )


def _depth_at_tris_single(query: torch.Tensor, tri_best: torch.Tensor, margin: float = 0.0):
    """(..., V, 3) live queries vs (..., V, 3, 3) pre-built triangles -> (..., V)."""
    closest = point_triangle_closest(query, tri_best)
    diff = query - closest
    d2 = (diff * diff).sum(-1)
    dist = torch.sqrt(torch.maximum(d2, torch.full_like(d2, _EPS)))  # jnp.maximum's tie gradient
    normal = torch.linalg.cross(tri_best[..., 1, :] - tri_best[..., 0, :], tri_best[..., 2, :] - tri_best[..., 0, :])
    inside = (diff * normal).sum(-1) < 0
    return _shell_depth(dist, inside, margin)


def pair_depths_at_tris(query_r, query_l, tri_r, tri_l, margin: float = 0.0) -> torch.Tensor:
    """(B, 2*Vq) depths of live queries against block-frozen triangles."""
    return torch.cat(
        [_depth_at_tris_single(query_r, tri_r, margin), _depth_at_tris_single(query_l, tri_l, margin)],
        dim=1,
    )


def pair_depths_fast(
    right_verts: torch.Tensor,  # (B, V, 3)
    left_verts: torch.Tensor,  # (B, V, 3)
    faces_right: torch.Tensor,  # (F, 3)
    faces_left: torch.Tensor,  # (F, 3)
    query_subsample: int = 1,
) -> torch.Tensor:
    """(B, 2Vq) single-candidate depths (``_pair_depths_fast`` of the JAX
    package): every ``query_subsample``-th query's nearest-centroid triangle
    of the other hand, both directions in ONE launch of the nearest-centroid
    kernel (N = 2B), then the exact depth against that triangle.
    Differentiable in the queries only; the mesh side is detached."""
    B, s = right_verts.shape[0], query_subsample
    tri = torch.cat([left_verts.detach()[:, faces_left], right_verts.detach()[:, faces_right]])  # (2B, F, 3, 3)
    query = torch.cat([right_verts[:, ::s], left_verts[:, ::s]])  # (2B, Vq, 3)
    idx = nearest_centroid(query.detach(), _centroids(tri))  # (2B, Vq)
    tri_b = torch.gather(tri, 1, idx[..., None, None].expand(-1, -1, 3, 3))  # (2B, Vq, 3, 3)
    depth = _depth_at_tris_single(query, tri_b)
    return torch.cat([depth[:B], depth[B:]], dim=1)


# fixed irregular ray direction of the parity test, and its face chunk
_PARITY_DIR = (0.57738027, 0.57725433, 0.57745315)
_PARITY_CHUNK = 128


def ray_parity_inside(
    query: torch.Tensor,  # (B, V, 3)
    mesh_verts: torch.Tensor,  # (B, Vm, 3)
    faces: torch.Tensor,  # (F, 3)
) -> torch.Tensor:
    """(B, V) bool: odd number of ray crossings (Möller-Trumbore, fixed ray).

    Removes the phantom depths every local nearest-face sign test reads on
    self-intersecting poses. The barycentrics are affine in the query for a
    fixed ray: with p = d x e2, m = e1 x d, n = e1 x e2,
    u = (q.p - v0.p)/det, v = (q.m - v0.m)/det, t = (q.n - v0.n)/det, so each
    128-face chunk is three fp32 plane products plus compares. The products
    are written out elementwise so they stay exact fp32 on any device."""
    query = query.detach()
    tri = mesh_verts.detach()[:, faces]  # (B, F, 3, 3)
    B, F = tri.shape[0], tri.shape[1]
    chunk = _PARITY_CHUNK
    pad = (-F) % chunk
    if pad:
        tri = torch.cat([tri, tri.new_zeros(B, pad, 3, 3)], dim=1)
    d = torch.tensor(_PARITY_DIR, dtype=query.dtype, device=query.device)
    v0, v1, v2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    p = torch.linalg.cross(d.expand_as(e2), e2)
    m = torch.linalg.cross(e1, d.expand_as(e1))
    n = torch.linalg.cross(e1, e2)
    det = (e1 * p).sum(-1)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    cu = (v0 * p).sum(-1)
    cv = (v0 * m).sum(-1)
    ct = (v0 * n).sum(-1)

    qx, qy, qz = (query[..., i, None] for i in range(3))  # (B, V, 1)

    def plane(vec):  # (B, C, 3) -> (B, V, C)
        return qx * vec[:, None, :, 0] + qy * vec[:, None, :, 1] + qz * vec[:, None, :, 2]

    crossings = torch.zeros(query.shape[:2], dtype=torch.int32, device=query.device)
    for s in range(0, tri.shape[1], chunk):
        sl = slice(s, s + chunk)
        invc = inv[:, None, sl]
        u = (plane(p[:, sl]) - cu[:, None, sl]) * invc
        v = (plane(m[:, sl]) - cv[:, None, sl]) * invc
        t = (plane(n[:, sl]) - ct[:, None, sl]) * invc
        hit = ok[:, None, sl] & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        crossings += hit.sum(-1, dtype=torch.int32)
    return (crossings % 2) == 1


def pair_parity_filter(depths, right_verts, left_verts, faces_right, faces_left, query_subsample: int = 1):
    """AND (B, 2Vq) depths with the ray-parity inside test of both directions
    (every ``query_subsample``-th query against the full other mesh)."""
    s = query_subsample
    inside = torch.cat(
        [
            ray_parity_inside(right_verts[:, ::s], left_verts, faces_left),
            ray_parity_inside(left_verts[:, ::s], right_verts, faces_right),
        ],
        dim=1,
    )
    return depths * inside.to(depths.dtype)


def pair_aabb_scale(right_verts: torch.Tensor, left_verts: torch.Tensor) -> torch.Tensor:
    """(B, 1): half the max extent of the two-hand AABB, detached."""
    allv = torch.cat([right_verts, left_verts], dim=1).detach()
    extent = allv.amax(dim=1) - allv.amin(dim=1)
    return torch.clamp(0.5 * extent.amax(dim=-1, keepdim=True), min=1e-6)


def depths_to_loss(
    depths: torch.Tensor,  # (B, 2*Vq)
    right_verts: torch.Tensor,
    left_verts: torch.Tensor,
    hand_type_array: torch.Tensor,  # (B, 2)
    robustifier: Optional[float] = None,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depths -> (mean loss, per-sample loss, depths): normalise by the AABB
    scale (or a given frozen one), square, optional Geman-McClure, sum per
    sample, zero non-interacting samples (sum(hand_type) <= 1.5)."""
    if scale is None:
        scale = pair_aabb_scale(right_verts, left_verts)
    d_norm = depths / scale
    per_vert = d_norm * d_norm
    if robustifier is not None:
        rho2 = float(robustifier) ** 2
        per_vert = rho2 * per_vert / (per_vert + rho2)
    per_sample = per_vert.sum(dim=-1)
    interacting = (hand_type_array.sum(dim=-1) > 1.5).to(per_sample.dtype)
    per_sample = per_sample * interacting
    return per_sample.mean(), per_sample, depths


def collision_loss(
    right_verts: torch.Tensor,  # (B, 778, 3)
    left_verts: torch.Tensor,  # (B, 778, 3)
    faces_right: torch.Tensor,  # (F, 3)
    faces_left: torch.Tensor,  # (F, 3)
    hand_type_array: torch.Tensor,  # (B, 2)
    robustifier: Optional[float] = None,
    num_candidates: int = 8,
    backend: str = "auto",
    query_subsample: int = 1,
    margin: float = 0.0,
    parity_filter: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-contract collision loss.

    ``backend``: "auto" and "pallas" both mean the exact kernel K1 (its plain
    version on CPU tensors; the JAX package's TPU branch), which runs at
    full sampling only; "xla" the K-candidate depth (``penetration_depth``,
    ``num_candidates``); "grid" the reference's 32^3 field
    (ops/grid_sdf.py, its default knobs); "fast" the in-loop
    single-candidate path (``pair_depths_fast``, the kernel K2), which needs
    ``num_candidates=1`` and follows the JAX package's TPU branch on every
    device, where it takes no margin. ``query_subsample`` strides the
    queries of each direction, never the mesh. ``margin`` (an outward shell,
    ``_shell_depth``) applies to "xla" and "fast" only. ``parity_filter``
    ANDs the depths with ``ray_parity_inside``."""
    s = query_subsample
    if margin != 0.0 and backend not in ("xla", "fast"):
        raise ValueError(f"margin shell is implemented for the xla/fast nearest-face paths, not {backend}")
    if backend == "fast":
        if num_candidates != 1:
            raise ValueError(f"backend 'fast' is single-candidate; got num_candidates={num_candidates}")
        depths = pair_depths_fast(right_verts, left_verts, faces_right, faces_left, s)
    elif backend in ("auto", "pallas"):
        if s != 1:
            raise ValueError("the exact metrics kernel always runs at full sampling (query_subsample=1)")
        depths = pair_depths_exact(right_verts, left_verts, faces_right, faces_left)
    elif backend == "grid":
        from ihmr_tpu_torch.ops.grid_sdf import pair_depths_grid, pair_grids

        grids = pair_grids(right_verts, left_verts, faces_right, faces_left)
        depths = pair_depths_grid(right_verts[:, ::s], left_verts[:, ::s], grids)
    elif backend == "xla":
        depths = _pair_depths(right_verts, left_verts, faces_right, faces_left, num_candidates, s, margin)
    else:
        raise NotImplementedError(f"collision backend {backend!r} is not ported")
    if parity_filter:
        depths = pair_parity_filter(depths, right_verts, left_verts, faces_right, faces_left, s)
    return depths_to_loss(depths, right_verts, left_verts, hand_type_array, robustifier)

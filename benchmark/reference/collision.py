"""Plain interpenetration depths for the benchmark's reference.

  * ``closest_point``: the closest point of a triangle to a point (Ericson's
    region test, branch-free, safe denominators), differentiable in the point;
  * ``nearest_faces``: each query's nearest face by its centroid, ranked as
    IHMR's refinement ranks it: operands, |c|^2, q.c and |c|^2 - 2 q.c each
    rounded to bfloat16, the first least rank winning;
  * ``depth_single``: the depth of each query against one given triangle,
    the sign from that triangle's normal;
  * ``exact_depth``: the depth of each query against every triangle of the
    other mesh, walked in 128-triangle tiles in order: a tile's minimum and
    the mean sign over the triangles within 1e-3 (relative) of it; across
    tiles a tile more than 1e-3 nearer replaces the running one and a tile
    within 1e-3 adds to it; a 128-query block skips a tile its bounding
    sphere proves too far. It also returns each query's least squared
    distance, which ``counts/exact_collision.py`` needs;
  * ``ray_parity``: inside by an odd count of crossings of one fixed ray.
"""

from __future__ import annotations

import torch

EPS = 1e-12
TIE = 1e-3
TILE = 128
RAY = (0.57738027, 0.57725433, 0.57745315)


def _sdiv(n, d):
    return n / torch.where(d.abs() < EPS, torch.where(d < 0, -EPS, EPS), d)


def closest_point(p, a, b, c):
    """p, a, b, c (..., 3) -> the closest point of triangle abc to p."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    den = _sdiv(torch.ones_like(va), va + vb + vc)
    out = a + (vb * den)[..., None] * ab + (vc * den)[..., None] * ac
    regions = (
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), b + _sdiv(d4 - d3, (d4 - d3) + (d5 - d6))[..., None] * (c - b)),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + _sdiv(d2, d2 - d6)[..., None] * ac),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + _sdiv(d1, d1 - d3)[..., None] * ab),
        ((d6 >= 0) & (d5 <= d6), c.expand_as(out)),
        ((d3 >= 0) & (d4 <= d3), b.expand_as(out)),
        ((d1 <= 0) & (d2 <= 0), a.expand_as(out)),
    )
    for mask, point in regions:  # the last region that holds wins
        out = torch.where(mask[..., None], point, out)
    return out


def _bf(x):
    return x.to(torch.bfloat16).float()


@torch.no_grad()
def nearest_faces(query, verts, faces):
    """(B, V, 3) queries, (B, Vm, 3) mesh, (F, 3) faces -> (B, V) face index."""
    tri = verts[:, faces]
    cent = ((tri[..., 0, :] + tri[..., 1, :]) + tri[..., 2, :]) * (1.0 / 3.0)
    cb, qb = _bf(cent), _bf(query)
    c2 = _bf((cb[..., 0] * cb[..., 0] + cb[..., 1] * cb[..., 1]) + cb[..., 2] * cb[..., 2])
    q, c = qb[:, :, None, :], cb[:, None, :, :]
    qc = _bf((q[..., 0] * c[..., 0] + q[..., 1] * c[..., 1]) + q[..., 2] * c[..., 2])
    return _bf(c2[:, None, :] - 2.0 * qc).argmin(-1)


def gather_tris(verts, faces, idx):
    """(B, Vm, 3), (F, 3), (B, V) -> (B, V, 3, 3) the selected triangles, detached."""
    tri = verts.detach()[:, faces].reshape(verts.shape[0], -1, 9)
    return torch.gather(tri, 1, idx[..., None].expand(-1, -1, 9)).reshape(idx.shape[0], idx.shape[1], 3, 3)


def depth_single(query, tri):
    """(B, V, 3) live queries vs (B, V, 3, 3) triangles -> (B, V) depth, 0 outside."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    diff = query - closest_point(query, a, b, c)
    d2 = (diff * diff).sum(-1)
    dist = torch.sqrt(torch.maximum(d2, torch.full_like(d2, EPS)))
    inside = (diff * torch.linalg.cross(b - a, c - a)).sum(-1) < 0
    return torch.where(inside, dist, torch.zeros_like(dist))


def aabb_scale(rv, lv):
    """(B, 1): half the largest extent of the two hands' bounding box, detached."""
    allv = torch.cat([rv, lv], 1).detach()
    return torch.clamp(0.5 * (allv.amax(1) - allv.amin(1)).amax(-1, keepdim=True), min=1e-6)


def _tile(q, t, k, F):
    """Squared distances and sign dots of every query against tile ``k``."""
    tt = t[:, None, k * TILE:(k + 1) * TILE]  # (N, 1, 128, 9)
    a, b, c = tt[..., 0:3], tt[..., 3:6], tt[..., 6:9]
    qq = q[:, :, None, :]
    diff = qq - closest_point(qq, a, b, c)
    d2 = (diff * diff).sum(-1)
    dot = (diff * torch.linalg.cross(b - a, c - a)).sum(-1)
    valid = torch.arange(k * TILE, (k + 1) * TILE, device=q.device) < F
    return torch.where(valid, d2, torch.full_like(d2, 1e30)), dot


@torch.no_grad()
def exact_depth(query, tri):
    """(N, V, 3) queries vs (N, F, 9) triangles -> (depth (N, V), least squared
    distance (N, V), ambiguous (N, V)); no gradient. A query's sign is
    ambiguous where a triangle within twice the tie tolerance of its least
    distance has a sign dot against the decision: rounding can then move
    that triangle into or out of the tie set and flip the sign."""
    N, V, _ = query.shape
    F = tri.shape[1]
    Vp, Fp = -(-V // TILE) * TILE, -(-F // TILE) * TILE
    q = torch.cat([query, query[:, :1].expand(N, Vp - V, 3)], 1)
    t = torch.cat([tri, tri[:, :1].expand(N, Fp - F, 9)], 1)
    tv = t.reshape(N, Fp // TILE, TILE * 3, 3)
    centre = (tv.amin(2) + tv.amax(2)) * 0.5
    radius = torch.sqrt(((tv - centre[:, :, None]) ** 2).sum(-1).amax(2))
    best = torch.full((N, Vp), 1e30, dtype=q.dtype, device=q.device)
    acc = torch.zeros((N, Vp), dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for k in range(Fp // TILE):
        lb = torch.clamp(torch.sqrt(((q - centre[:, k, None]) ** 2).sum(-1)) - radius[:, k, None], min=0.0)
        need = ((best - lb * lb).reshape(N, Vp // TILE, TILE).amax(-1) >= 0).repeat_interleave(TILE, 1)
        d2, dot = _tile(q, t, k, F)
        tmin = d2.amin(-1)
        tie = d2 <= (tmin * (1.0 + TIE) + EPS)[..., None]
        val = torch.where(tie, dot, zero).sum(-1) / torch.clamp(tie.sum(-1).to(q.dtype), min=1.0)
        better = tmin < best * (1.0 - TIE)
        tied = ~better & (tmin <= best * (1.0 + TIE) + EPS)
        nb = torch.where(better, tmin, torch.minimum(best, torch.where(tied, tmin, torch.full_like(tmin, 1e30))))
        na = torch.where(better, val, torch.where(tied, acc + val, acc))
        best = torch.where(need, nb, best)
        acc = torch.where(need, na, acc)
    inside = acc < 0
    ambiguous = torch.zeros_like(inside)
    for k in range(Fp // TILE):
        d2, dot = _tile(q, t, k, F)
        band = d2 <= (best * (1.0 + 2 * TIE) + EPS)[..., None]
        ambiguous |= (band & torch.where(inside[..., None], dot >= 0, dot < 0)).any(-1)
    depth = torch.where(inside, torch.sqrt(torch.clamp(best, min=EPS)), zero)
    return depth[:, :V], best[:, :V], ambiguous[:, :V]


@torch.no_grad()
def ray_parity(query, verts, faces):
    """(B, V, 3), (B, Vm, 3), (F, 3) -> (B, V) bool, inside by crossing parity."""
    tri = verts[:, faces]
    v0, e1, e2 = tri[:, :, 0], tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0]
    d = query.new_tensor(RAY).expand_as(e1)
    p, m, n = torch.linalg.cross(d, e2), torch.linalg.cross(e1, d), torch.linalg.cross(e1, e2)
    det = (e1 * p).sum(-1)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    count = torch.zeros(query.shape[:2], dtype=torch.int32, device=query.device)
    for s in range(0, tri.shape[1], TILE):
        sl = slice(s, s + TILE)

        def plane(vec):  # written out, as the port's test computes it
            x, y, z = (query[..., i, None] for i in range(3))
            w = vec[:, sl]
            c0 = (v0[:, sl] * w).sum(-1)[:, None]
            return x * w[:, None, :, 0] + y * w[:, None, :, 1] + z * w[:, None, :, 2] - c0

        iv = inv[:, None, sl]
        u, v, t = plane(p) * iv, plane(m) * iv, plane(n) * iv
        count += (ok[:, None, sl] & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)).sum(-1, dtype=torch.int32)
    return count % 2 == 1

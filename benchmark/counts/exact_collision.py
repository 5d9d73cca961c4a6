"""Operations and bytes of the exact penetration depth (the port's kernel K1),
counted from what the inputs need, whatever implements it.

Per (query, triangle) pair, the closest point and the sign take
``FLOP_PER_PAIR`` = 78 operations: the query minus each corner (9), the six
dot products d1..d6 of Ericson's region test (30), the three barycentric
determinants va, vb, vc (9), the closest point of the face region (17: its
denominator 3, two weights 2, three coordinates of a + v ab + w ac 12), the
squared distance to it (8), and the sign's dot product with the face normal
(5). Per-triangle terms (edges, normal) are not counted per pair.

Which pairs are needed: triangles come in tiles of 128 and queries in
blocks of 128, and a tile's bounding sphere proves it no nearer than
lb = max(0, |q - centre| - radius). A (block, tile) pair must be evaluated
when some query of the block has lb^2 <= its least squared distance to the
whole mesh (``pairs_needed``); the count takes the real queries and
triangles of each such pair. It depends on the meshes only, not on the
order in which an implementation visits tiles.

Bytes: the queries (N, V, 3) and triangles (N, F, 9) read once, the depth
(N, V) and the unit direction (N, V, 3) written once, float32.
"""

from __future__ import annotations

import torch

FLOP_PER_PAIR = 78
TILE = 128


@torch.no_grad()
def pairs_needed(query: torch.Tensor, tri: torch.Tensor, best_d2: torch.Tensor) -> int:
    """query (N, V, 3), tri (N, F, 9), best_d2 (N, V) -> needed pairs."""
    N, V, _ = query.shape
    F = tri.shape[1]
    nt = -(-F // TILE)
    Fp = nt * TILE
    t = torch.cat([tri, tri[:, :1].expand(N, Fp - F, 9)], 1).reshape(N, nt, TILE * 3, 3)
    centre = (t.amin(2) + t.amax(2)) * 0.5
    radius = torch.sqrt(((t - centre[:, :, None]) ** 2).sum(-1).amax(2))  # (N, nt)
    nq = -(-V // TILE)
    total = 0
    for b in range(nq):
        q = query[:, b * TILE:(b + 1) * TILE]  # (N, <=128, 3)
        lb = torch.clamp(torch.sqrt(((q[:, :, None] - centre[:, None]) ** 2).sum(-1)) - radius[:, None], min=0.0)
        need = ((best_d2[:, b * TILE:(b + 1) * TILE, None] - lb * lb) >= 0).any(1)  # (N, nt)
        tris = torch.full((nt,), TILE, dtype=torch.int64, device=query.device)
        tris[-1] = F - (nt - 1) * TILE
        total += int((need.to(torch.int64) * tris).sum()) * q.shape[1]
    return total


def bytes_moved(n: int, v: int, f: int) -> int:
    return 4 * (n * v * 3 + n * f * 9 + n * v * 4)

"""Adversarial inputs for the exact-collision (K1) and nearest-centroid (K2)
kernels, made from a seed with numpy.

Each case holds the kernel to its plain version where the tie and pruning
rules decide the answer: exact ties across a tile boundary, degenerate
triangles, ragged triangle counts, queries on the mesh's own vertices (d2 =
0, many ties), and a block whose every tile after the first is pruned; for
K2, exact ties inside one tile and across tiles, and an odd centroid count.
``chip_smoke.py`` and the CUDA tests run them against the kernels, the CPU
tests against the plain versions' mirrors.

    exact_cases(device)    -> [(label, query (N, V, 3), triangles (N, F, 9))]
    nearest_cases(device)  -> [(label, query (N, V, 3), centroids (N, F, 3), picks or None)]

The main paths' own inputs at full width are here too, for timing:

    exact_main_inputs(device)    K1 on the OPT path's final pass, B=128 hands
    nearest_main_inputs(device)  K2 on an MLP train step, B=128 hands
    RESNET50_BN                  K3's inputs in a ResNet-50 training step
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.mano.loader import _convex_hull_faces, _fibonacci_sphere


# the 12 distinct BatchNorm input shapes of a ResNet-50 (v1.5: stride on the
# 3x3) training step at 224x224, per sample (C, H, W) -> how many of its 53
# BatchNorms take that shape
RESNET50_BN = {
    (64, 112, 112): 1, (64, 56, 56): 6, (256, 56, 56): 4, (128, 56, 56): 1, (128, 28, 28): 7, (512, 28, 28): 5,
    (256, 28, 28): 1, (256, 14, 14): 11, (1024, 14, 14): 7, (512, 14, 14): 1, (512, 7, 7): 5, (2048, 7, 7): 4,
}


def _hand_pair(mano, rv, lv):
    """(query (2B, V, 3), triangles (2B, F, 9)): right vertices into the left
    mesh, then left vertices into the right mesh, as pair_depths_exact."""
    B = rv.shape[0]
    faces_r, faces_l = mano.faces, mano.faces.flip(-1)
    q = torch.cat([rv, lv]).contiguous()
    tri = torch.cat([lv[:, faces_l].reshape(B, -1, 9), rv[:, faces_r].reshape(B, -1, 9)]).contiguous()
    return q, tri


def exact_main_inputs(device, batch: int = 128, seed: int = 0):
    """K1's inputs on the OPT path: both directions of ``make_opt_inputs``
    hands (778 vertices, 1538 faces) -> (query (2B, 778, 3), tri (2B, 1538, 9))."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.refine import forward

    mano = synthetic_mano_model(device=device)
    params, _ = make_opt_inputs(mano, batch=batch, seed=seed)
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, params)
    return _hand_pair(mano, rv, lv)


def nearest_main_inputs(device, batch: int = 128, seed: int = 100):
    """K2's inputs on the MLP path: both directions of ``make_mlp_inputs``
    hands -> (query (2B, 778, 3), centroids (2B, 1538, 3))."""
    from ihmr_tpu_torch.data import make_mlp_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.ops.collision import _centroids
    from ihmr_tpu_torch.refine import forward
    from ihmr_tpu_torch.refine.mlp_engine import seed_from_backbone

    mano = synthetic_mano_model(device=device)
    batch_ = make_mlp_inputs(mano, batch=batch, seed=seed)
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, seed_from_backbone(batch_))
    q, tri = _hand_pair(mano, rv, lv)
    return q, _centroids(tri.reshape(tri.shape[0], -1, 3, 3)).contiguous()


def sphere_triangles(n_points: int) -> np.ndarray:
    """(2 n_points - 4, 9) outward triangles of the unit Fibonacci sphere."""
    pts = _fibonacci_sphere(n_points)
    return pts[_convex_hull_faces(pts)].reshape(-1, 9)


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)


def exact_cases(device, seed: int = 0) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
    rng = np.random.RandomState(seed)
    cases = []

    tri = sphere_triangles(400)  # 796 triangles
    # triangle 127 again at 128: an exact tie across the first tile boundary
    tie = np.concatenate([tri[:128], tri[127:128], tri[128:]])
    centre = tie[127].reshape(3, 3).mean(0)
    q = centre + rng.randn(2, 300, 3) * 0.05
    cases.append(("tie across a tile boundary", _t(q, device), _t(np.broadcast_to(tie, (2,) + tie.shape), device)))

    # zero-area, collinear and repeated-vertex triangles among valid ones
    deg = tri.copy().reshape(-1, 3, 3)
    deg[0::7, 1] = deg[0::7, 2] = deg[0::7, 0]  # a point
    deg[1::7, 2] = deg[1::7, 0] + 2.0 * (deg[1::7, 1] - deg[1::7, 0])  # collinear
    deg[2::7, 1] = deg[2::7, 0]  # a = b
    deg[3::7, 2] = deg[3::7, 1]  # b = c
    q = rng.randn(2, 500, 3) * 0.7
    q[:, :40] = deg[0:280:7, 0]  # on degenerate points
    q[:, 40:80] = (deg[1:281:7, 0] + deg[1:281:7, 1]) * 0.5  # on collinear segments
    cases.append(("degenerate triangles", _t(q, device), _t(np.broadcast_to(deg.reshape(-1, 9), (2, deg.shape[0], 9)), device)))

    # ragged triangle counts: one triangle, one past a tile, a MANO hand's 1538
    for n_tri, n_points in ((1, 400), (129, 400), (1538, 771)):
        t = sphere_triangles(n_points)[:n_tri]
        q = rng.randn(2, 200, 3) * 0.8
        cases.append((f"n_tri={n_tri}", _t(q, device), _t(np.broadcast_to(t, (2,) + t.shape), device)))

    # queried with its own vertices: d2 = 0 to every incident triangle
    pts = _fibonacci_sphere(200)
    t = pts[_convex_hull_faces(pts)].reshape(-1, 9)
    cases.append(("own vertices", _t(np.stack([pts, pts * 0.999]), device), _t(np.stack([t, t]), device)))

    # every tile after the first is pruned: tile 0 around the origin, the
    # other tiles 50 units away, all queries near the origin
    t = sphere_triangles(400)[:512].reshape(-1, 3, 3) * 0.1
    t[128:] += np.array([50.0, 0.0, 0.0])
    q = rng.randn(2, 256, 3) * 0.05
    cases.append(("pruned after the first tile", _t(q, device), _t(np.broadcast_to(t.reshape(-1, 9), (2, 512, 9)), device)))
    return cases


def division_operands(device, n: int = 1 << 24, seed: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num, den) fp32 for the exact-collision kernel's division check: both
    signs, magnitudes log-uniform over [2^-70, 2^70] (inside and outside its
    fast path's [2^-50, 2^50]), exact zeros, and denominators under the 1e-12
    clamp."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw():
        mag = torch.exp2(torch.rand(n, generator=gen, device=device) * 140.0 - 70.0)
        sign = torch.where(torch.rand(n, generator=gen, device=device) < 0.5, -1.0, 1.0)
        return (mag * sign).float()

    num, den = draw(), draw()
    num[: n // 64] = 0.0
    den[n // 64 : n // 32] *= 1e-13 / den[n // 64 : n // 32].abs().clamp_min(1e-30)  # |den| ~ 1e-13: clamped
    num[n // 32 : n // 16] = 1.0  # the face's 1 / (va + vb + vc)
    return num, den


def nearest_cases(device, seed: int = 1) -> List[Tuple[str, torch.Tensor, torch.Tensor, Optional[Tuple[int, ...]]]]:
    rng = np.random.RandomState(seed)
    cases = []
    target = np.array([0.1, -0.2, 0.3])
    cent = rng.rand(4, 300, 3) * 5 + 5
    cent[0, [3, 10]] = target  # one tile: the mean index, (3 + 10) / 2 -> 6
    cent[1, [5, 200]] = target  # two tiles: the first stays -> 5
    cent[2, [130, 131, 140, 260]] = target  # tile 1 ties, tile 2 ignored: (130 + 131 + 140) / 3 -> 133
    cent[3, [299]] = target  # the last, ragged tile -> 299
    q = target + (rng.rand(4, 20, 3) - 0.5) * 0.02
    cases.append(("planted ties", _t(q, device), _t(cent, device), (6, 5, 133, 299)))

    t = sphere_triangles(400)[:-1].reshape(-1, 3, 3)  # an odd centroid count, 795
    sphere_cent = t.mean(1)
    q = rng.randn(3, 400, 3) * 0.6
    q[0, :100] = sphere_cent[:100]  # on centroids
    cases.append(("odd centroid count", _t(q, device), _t(np.broadcast_to(sphere_cent, (3,) + sphere_cent.shape), device), None))

    # centroids on a coarse grid: many exact ties, inside tiles and across them
    cent = rng.randint(0, 4, size=(2, 701, 3)).astype(np.float64) * 0.25
    q = rng.randint(0, 4, size=(2, 300, 3)) * 0.25 + (rng.rand(2, 300, 3) - 0.5) * np.array([0.0, 0.0, 0.1])
    cases.append(("grid duplicates", _t(q, device), _t(cent, device), None))
    return cases

"""The redesigned kernels' arithmetic, mirrored in torch and held to the plain versions.

The CUDA kernels ``csrc/exact_collision.cu`` (K1) and ``csrc/nearest_centroid.cu``
(K2) have no CPU mode. Their designs change how the work is done, not what
it computes, and these tests check the claims that make the change exact:

* K1 region first: resolving the six region predicates to one region and
  computing only that region's closest point (one division) gives ``d2``,
  ``dot`` and ``q - closest`` with the same bits as ``tile_d2_dot``; on a
  vertex region with a coordinate of -0 the values are equal and only the
  sign of a zero may differ.
* K1 candidates: the running-threshold marks of one pass over a tile, also
  when capped at the threshold of best's threshold, hold the plain
  version's tie set of a tile that can change the result, and keeping the
  marked triangles with d2 <= the final threshold gives that set exactly;
  the whole kernel loop (pruning vote, capped marks, the skip of a tile
  that changes nothing, tie sums in index order, across-tile merge) gives
  the plain version's depths and inside signs exactly.
* K2: the minimum of each tile, the first tile with the smallest, and a
  second walk of that tile (from a per-lane offset) for the sum and count
  of the tied indices give the plain version's indices.
* K3 (``csrc/bn_stats.cu``): the launch plan covers every (sample, channel)
  once, with 16-byte loads, aligned spans and one wave of blocks at every
  BatchNorm shape of a ResNet-50 step; the two paths' work split and
  summation order (the runs path's load streams, rounds, accumulators,
  block tree and slice combine; the tiles path's channel-group spans, row
  groups, column attribution and per-channel warp trees) hold the plain
  version's sums within 1e-5 (sum x relative to sum |x|, sum x^2 relative:
  fp32 sums in another order; the kernel fuses each square into its sum,
  mirrored through float64) on the 12 shapes at B=2 in fp32 and bf16, a
  ragged (3, 5, 7, 11), a (rows, C) matrix, a C that is no multiple of the
  channel tile and an unaligned base; on integer data, where every order is
  exact, bit for bit.

Each mirror is written op for op in fp32 torch, so it rounds as the kernel
(built with --fmad=false) does. Tolerance: bits equal, except the direction
(a tie-set mean, summed here in index order as in the kernel and by
``torch.sum`` in the plain version): 1e-4 where both are inside, as
``chip_smoke.py`` holds the kernel.
"""

import numpy as np
import pytest
import torch

from ihmr_tpu_torch import kernel_cases
from ihmr_tpu_torch.ops import bn_stats as K3
from ihmr_tpu_torch.ops import exact_collision as K
from ihmr_tpu_torch.ops import nearest_centroid as NC
from tests.torch_threads import one_torch_thread  # noqa: F401

TIE_HI, TIE_LO, EPS, BIG = 1.0 + K.TIE_REL, 1.0 - K.TIE_REL, 1e-12, 1e30


def bits(x):
    return x.contiguous().view(torch.int32)


def region_first(q, tri):
    """csrc/exact_collision.cu::closest: (d2, dot, dx, dy, dz)."""
    qx, qy, qz = q.unbind(-1)
    ax, ay, az, bx, by, bz, cx, cy, cz = tri.unbind(-1)
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    cbx, cby, cbz = cx - bx, cy - by, cz - bz
    nx, ny, nz = aby * acz - abz * acy, abz * acx - abx * acz, abx * acy - aby * acx
    apx, apy, apz = qx - ax, qy - ay, qz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2_ = acx * apx + acy * apy + acz * apz
    bpx, bpy, bpz = qx - bx, qy - by, qz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz
    cpx, cpy, cpz = qx - cx, qy - cy, qz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2_ - d1 * d6, d1 * d4 - d3 * d2_
    d43, d56 = d4 - d3, d5 - d6

    in_bc = (va <= 0) & (d43 >= 0) & (d56 >= 0)
    in_ac = (vb <= 0) & (d2_ >= 0) & (d6 <= 0)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_a = (d1 <= 0) & (d2_ <= 0)
    vert = in_a | in_b | in_c
    on_ab = ~vert & in_ab
    on_ac = ~vert & ~in_ab & in_ac
    on_bc = ~vert & ~in_ab & ~in_ac & in_bc
    face = ~(vert | in_ab | in_ac | in_bc)

    num = torch.where(on_ab, d1, torch.where(on_ac, d2_, torch.where(on_bc, d43, torch.ones_like(d1))))
    den = torch.where(on_ab, d1 - d3, torch.where(on_ac, d2_ - d6, torch.where(on_bc, d43 + d56, (va + vb) + vc)))
    r = K._safe_div(num, den)
    s = torch.where(vert, torch.zeros_like(r), torch.where(face, vb * r, r))
    w = vc * r
    use_b = on_bc | (vert & ~in_a & in_b)
    use_c = vert & ~in_a & ~in_b
    p = []
    for a_, b_, c_, ab_, ac_, cb_ in ((ax, bx, cx, abx, acx, cbx), (ay, by, cy, aby, acy, cby), (az, bz, cz, abz, acz, cbz)):
        base = torch.where(use_c, c_, torch.where(use_b, b_, a_))
        edge = torch.where(on_ac, ac_, torch.where(on_bc, cb_, ab_))
        pt = base + s * edge
        p.append(torch.where(face, pt + w * ac_, pt))
    dx, dy, dz = qx - p[0], qy - p[1], qz - p[2]
    d2 = dx * dx + dy * dy + dz * dz
    return d2, dx * nx + dy * ny + dz * nz, dx, dy, dz


def _pairs(kind, rng):
    """(q (P, 3), tri (P, 9)) float32 pairs of one kind."""
    n = 100_000
    if kind == "random":
        tri = rng.randn(n, 9) * rng.choice([0.01, 0.1, 1.0], size=(n, 1)) + rng.randn(n, 1, 3).repeat(3, 1).reshape(n, 9)
        q = tri[:, :3] + rng.randn(n, 3) * rng.choice([0.001, 0.05, 1.0], size=(n, 1))
    elif kind == "degenerate":
        t = rng.randn(n, 3, 3) * 0.2
        k = np.arange(n) % 5
        t[k == 0, 1] = t[k == 0, 2] = t[k == 0, 0]  # a point
        t[k == 1, 2] = t[k == 1, 0] + 2.0 * (t[k == 1, 1] - t[k == 1, 0])  # collinear, c beyond b
        t[k == 2, 1] = t[k == 2, 0]  # a = b
        t[k == 3, 2] = t[k == 3, 1]  # b = c
        t[k == 4, 2] = t[k == 4, 0] + 0.5 * (t[k == 4, 1] - t[k == 4, 0])  # collinear, c between
        tri = t.reshape(n, 9)
        q = t[:, 0] + rng.randn(n, 3) * rng.choice([0.0, 1e-4, 0.1], size=(n, 1))
    else:  # queries on vertices, edge midpoints and centroids, and just off them
        t = rng.randn(n, 3, 3) * 0.2 + rng.randn(n, 1, 3)
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        spots = np.stack([a, b, c, (a + b) * 0.5, (b + c) * 0.5, (a + c) * 0.5, (a + b + c) / 3.0], 1)
        q = spots[np.arange(n), np.arange(n) % 7] + rng.randn(n, 3) * rng.choice([0.0, 1e-6], size=(n, 1))
        tri = t.reshape(n, 9)
    return torch.tensor(q, dtype=torch.float32), torch.tensor(tri, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["random", "degenerate", "on features"])
def test_region_first_is_bit_equal(kind):
    q, tri = _pairs(kind, np.random.RandomState(["random", "degenerate", "on features"].index(kind)))
    ours, ref = region_first(q, tri), K.tile_d2_dot(q, tri)
    for name, a, b in zip(("d2", "dot", "dx", "dy", "dz"), ours, ref):
        assert torch.isfinite(b).all(), name
        assert torch.equal(bits(a), bits(b)), (name, int((bits(a) != bits(b)).sum()))


def test_region_first_negative_zero_vertex():
    # vertex coordinates of -0: the value is the plain version's, and d2 keeps its bits
    tri = torch.tensor([[-0.0, -0.0, -0.0, 1.0, -0.0, -0.0, -0.0, 1.0, -0.0]] * 3)
    q = torch.tensor([[-0.0, -0.0, -0.0], [-0.5, -0.5, -0.0], [-0.0, -0.0, 0.3]])
    ours, ref = region_first(q, tri), K.tile_d2_dot(q, tri)
    assert torch.equal(bits(ours[0]), bits(ref[0]))
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def tie_threshold(x):
    return x * TIE_HI + EPS


def tile_marks(d2, valid, cap=None):
    """Pass 1 of a tile: (tile minimum, marks) of d2 (R, 128), triangles >=
    valid masked; marks d2 <= tie_threshold(running minimum) and d2 <= cap."""
    tmin = torch.full(d2.shape[:1], BIG)
    cap = torch.full(d2.shape[:1], BIG) if cap is None else cap
    marks = torch.zeros(d2.shape, dtype=torch.bool)
    for k in range(valid):
        tmin = torch.minimum(tmin, d2[:, k])
        marks[:, k] = d2[:, k] <= torch.minimum(tie_threshold(tmin), cap)
    return tmin, marks


def _tie_sets(d2, valid, cap=None):
    tmin, marks = tile_marks(d2, valid, cap)
    kept = marks & (d2 <= (tmin * TIE_HI + EPS)[:, None])
    masked = torch.where(torch.arange(d2.shape[1]) < valid, d2, torch.tensor(BIG))
    ref_min = masked.amin(-1)
    is_min = masked <= (ref_min * TIE_HI + EPS)[:, None]
    return tmin, ref_min, marks, kept, is_min


def _d2_tiles(kind, rng):
    r = 512
    if kind == "random":
        return torch.tensor(rng.rand(r, 128) * 10 ** rng.uniform(-8, 2, size=(r, 1)), dtype=torch.float32)
    d2 = torch.tensor(rng.rand(r, 128) + 0.5, dtype=torch.float32)
    m = torch.tensor(rng.rand(r) * 0.1 + 0.01, dtype=torch.float32)
    pos = torch.tensor(np.argsort(rng.rand(r, 128), axis=1)[:, :5])  # five distinct places a row
    rows = torch.arange(r)[:, None]
    if kind == "exact ties":
        d2[rows, pos[:, :4]] = m[:, None]
    else:  # d2 at exactly the final threshold, before and after the minimum, and one step above it
        at = m * TIE_HI + EPS
        d2[rows[:, 0], pos[:, 0]] = m
        d2[rows[:, 0], pos[:, 1]] = at
        d2[rows[:, 0], pos[:, 2]] = at
        d2[rows[:, 0], pos[:, 3]] = torch.nextafter(at, torch.tensor(1.0))
        d2[rows[:, 0], pos[:, 4]] = m
    return d2


@pytest.mark.parametrize("kind", ["random", "exact ties", "at 1.001x"])
@pytest.mark.parametrize("valid", [128, 1, 127])
def test_candidate_marks_hold_the_tie_set(kind, valid):
    d2 = _d2_tiles(kind, np.random.RandomState(valid))
    tmin, ref_min, marks, kept, is_min = _tie_sets(d2, valid)
    assert torch.equal(tmin, ref_min)
    assert bool((marks | ~is_min).all())  # every tie-set member is marked
    assert torch.equal(kept, is_min)
    assert int(marks.sum(-1).float().mean()) <= 12  # a few candidates, not the tile
    if kind == "at 1.001x" and valid == 128:
        assert int(is_min.sum()) >= 3 * d2.shape[0]  # the minimum and both triangles at the threshold


@pytest.mark.parametrize("kind", ["random", "exact ties", "at 1.001x"])
def test_capped_marks_hold_the_tie_set_of_a_tile_that_matters(kind):
    # the kernel caps the marks at tie_threshold(tie_threshold(best)); a tile
    # matters when its minimum is <= tie_threshold(best)
    rng = np.random.RandomState(7)
    d2 = _d2_tiles(kind, rng)
    ref_min = d2.amin(-1)
    # best around the tile minimum: some tiles tie or beat it, some do not
    best = ref_min * torch.tensor(rng.uniform(0.998, 1.2, size=ref_min.shape), dtype=torch.float32)
    best[::5] = ref_min[::5]
    best[1::5] = BIG  # the first tile evaluated
    best[2::5] = ref_min[2::5] * 0.9  # the tile changes nothing
    cap = tie_threshold(tie_threshold(best))
    tmin, _, marks, kept, is_min = _tie_sets(d2, 128, cap)
    matters = tmin <= tie_threshold(best)
    assert int(matters.sum()) >= d2.shape[0] // 2 and not bool(matters.all())
    assert bool((marks | ~is_min)[matters].all())
    assert torch.equal(kept[matters], is_min[matters])


def kernel_mirror(q, tri, bounds, n_tri):
    """csrc/exact_collision.cu's loop on padded inputs -> (depth, dir, evaluated)."""
    N, Vp, _ = q.shape
    n_qt, n_tt = Vp // K.Q_TILE, tri.shape[1] // K.T_TILE
    best = torch.full((N, Vp), BIG)
    acc = torch.zeros((N, Vp, 4))
    evaluated = torch.zeros((N, n_qt, n_tt), dtype=torch.bool)
    for t in range(n_tt):
        c = bounds[:, t]
        dd = q - c[:, None, :3]
        lb = torch.clamp(torch.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + dd[..., 2] * dd[..., 2]) - c[:, None, 3], min=0.0)
        need = ((best - lb * lb) >= 0).reshape(N, n_qt, K.Q_TILE).any(-1)
        evaluated[:, :, t] = need
        valid = min(K.T_TILE, n_tri - t * K.T_TILE)
        hits = [region_first(q, tri[:, None, t * K.T_TILE + k]) for k in range(valid)]
        thr_best = tie_threshold(best)
        tmin, marks = tile_marks(torch.stack([h[0] for h in hits], -1).reshape(N * Vp, valid), valid,
                                 tie_threshold(thr_best).reshape(-1))
        tmin, marks = tmin.reshape(N, Vp), marks.reshape(N, Vp, valid)
        matters = tmin <= thr_best  # else neither better nor tied: the kernel skips pass 2
        marks = marks & matters[..., None]
        thr = tie_threshold(tmin)
        cnt = torch.zeros((N, Vp))
        sums = torch.zeros((N, Vp, 4))
        for k in range(valid):  # the marked ones, in index order
            keep = marks[..., k] & (hits[k][0] <= thr)
            cnt = torch.where(keep, cnt + 1.0, cnt)
            sums = torch.where(keep[..., None], sums + torch.stack(hits[k][1:], -1), sums)
        val = sums / torch.clamp(cnt, min=1.0)[..., None]
        better = tmin < best * TIE_LO
        tied = ~better & (tmin <= best * TIE_HI + EPS)
        new_best = torch.where(better, tmin, torch.minimum(best, torch.where(tied, tmin, torch.tensor(BIG))))
        new_acc = torch.where(better[..., None], val, torch.where(tied[..., None], acc + val, acc))
        need_q = need.repeat_interleave(K.Q_TILE, dim=1)
        best = torch.where(need_q, new_best, best)
        acc = torch.where(need_q[..., None], new_acc, acc)
    dist = torch.sqrt(torch.clamp(best, min=1e-12))
    inside = acc[..., 0] < 0
    depth = torch.where(inside, dist, torch.zeros(()))
    return depth, acc[..., 1:] * torch.where(inside, 1.0 / dist, torch.zeros(()))[..., None], evaluated


EXACT_CASES = [label for label, _, _ in kernel_cases.exact_cases("cpu")]


@pytest.fixture(scope="module")
def exact_cases():
    return {label: (q, tri) for label, q, tri in kernel_cases.exact_cases("cpu")}


@pytest.mark.parametrize("label", EXACT_CASES)
def test_kernel_loop_matches_plain_version(exact_cases, label):
    q, tri = exact_cases[label]
    qp, tp, bounds = K.pad_inputs(q, tri)
    depth, dirs, evaluated = kernel_mirror(qp, tp, bounds, tri.shape[1])
    ref, ref_dirs, ref_evaluated = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    assert torch.equal(evaluated, ref_evaluated)
    assert torch.equal(depth, ref)
    both = (depth > 0) & (ref > 0)
    gap = (dirs - ref_dirs)[both].abs()
    assert gap.numel() == 0 or float(gap.max()) <= 1e-4
    if label == "pruned after the first tile":
        assert bool(ref_evaluated[:, :, 0].all()) and not bool(ref_evaluated[:, :, 1:].any())
    if label == "own vertices":
        assert float(ref[0].abs().max()) == 0.0 and bool((ref[1] > 0).all())  # on the mesh / just inside


def nearest_mirror(q, cent, n_tri):
    """csrc/nearest_centroid.cu's loop on padded inputs -> (N, Vp) int32: the
    minimum of each tile, the first tile whose minimum is the smallest, then
    that tile walked again for the indices of the ranks equal to it, summed
    from a per-query offset (the kernel starts each lane elsewhere)."""
    N, Vp, _ = q.shape
    qx, qy, qz = q.unbind(-1)

    def rank(k):
        cx, cy, cz, c2 = (v[:, None] for v in cent[:, k].unbind(-1))
        return c2 - 2.0 * ((cx * qx + cy * qy) + cz * qz)

    best = torch.full((N, Vp), BIG)
    best_tile = torch.zeros((N, Vp), dtype=torch.int64)
    for t0 in range(0, n_tri, NC.T_TILE):
        tmin = torch.full((N, Vp), BIG)
        for k in range(t0, min(t0 + NC.T_TILE, n_tri)):
            tmin = torch.minimum(tmin, rank(k))
        lower = tmin < best
        best = torch.where(lower, tmin, best)
        best_tile = torch.where(lower, torch.tensor(t0 // NC.T_TILE), best_tile)
    start = best_tile * NC.T_TILE
    count = torch.clamp(n_tri - start, max=NC.T_TILE)
    off = torch.arange(Vp) % count  # the kernel's lane offset, here per query
    total = torch.zeros((N, Vp))
    cnt = torch.zeros((N, Vp))
    ranks = torch.stack([rank(j) for j in range(n_tri)], -1)  # (N, Vp, n_tri)
    for i in range(NC.T_TILE):
        live = i < count
        k = start + (off + i) % count
        hit = live & (ranks.gather(-1, k[..., None])[..., 0] == best)
        total = torch.where(hit, total + k.float(), total)
        cnt = torch.where(hit, cnt + 1.0, cnt)
    return (total / torch.clamp(cnt, min=1.0)).to(torch.int32)


@pytest.mark.parametrize("label", [c[0] for c in kernel_cases.nearest_cases("cpu")])
def test_nearest_tile_minima_match_plain_version(label):
    _, q, cent, picks = next(c for c in kernel_cases.nearest_cases("cpu") if c[0] == label)
    qp, cp = NC.pad_inputs(q, cent)
    ours = nearest_mirror(qp, cp, cent.shape[1])
    ref = NC.nearest_centroid_reference(qp, cp, cent.shape[1])
    assert torch.equal(ours, ref)
    if picks is not None:
        V = q.shape[1]
        for n, pick in enumerate(picks):
            assert bool((ref[n, :V] == pick).all()), (n, ref[n, :V].tolist())


# K3: csrc/bn_stats.cu's work split and summation order, mirrored in fp32 torch

RESNET50_BN = kernel_cases.RESNET50_BN
K3_WARPS = K3.THREADS // 32


def _warp_tree(a):
    """A shfl_down tree over the last axis (32 lanes): lane 0's value."""
    for off in (16, 8, 4, 2, 1):
        a = a[..., :off] + a[..., off:2 * off]
    return a[..., 0]


def _seq(a, dim):
    """0 + a[0] + a[1] + ... along ``dim``, in fp32, in that order."""
    out = torch.zeros_like(a.select(dim, 0))
    for i in range(a.shape[dim]):
        out = out + a.select(dim, i)
    return out


def _fma(a, b, c):
    """a * b + c rounded once to fp32 (through float64, where a * b is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _seq_squares(a, dim):
    """q = fma(a[i], a[i], q) for i along ``dim`` in order, from 0."""
    out = torch.zeros_like(a.select(dim, 0))
    for i in range(a.shape[dim]):
        v = a.select(dim, i)
        out = _fma(v, v, out)
    return out


def _pairwise(a):
    """csrc/bn_stats.cu::add_values' sum of a load's lanes (last axis)."""
    t = list(a.unbind(-1))
    w = 1
    while w < len(t):
        for l in range(0, len(t) - w, 2 * w):
            t[l] = t[l] + t[l + w]
        w *= 2
    return t[0]


def _block_sum(v):
    """csrc/bn_stats.cu::block_sum over the last axis (the block's threads)."""
    return _seq(_warp_tree(v.reshape(*v.shape[:-1], K3_WARPS, 32)), -1)


def _combine_runs(part, slices):
    """One warp over each row's slice partials (lane l takes l, l + 32, ...),
    then a tree."""
    if slices == 1:
        return part[:, 0]
    k = -(-slices // 32) * 32
    lanes = torch.cat([part, part.new_zeros(part.shape[0], k - slices)], 1).reshape(part.shape[0], -1, 32)
    return _warp_tree(_seq(lanes, 1))


def bn_runs_mirror(xf, p, elem):
    """The runs path: per item (channel, slice) the slice's rows x (hw / U)
    loads numbered as one range, load j taken by thread j % T in round
    j // (L T) as its stream (j // T) % L (L = LOADS / 2); each load's lanes
    summed pairwise and its squares fused one by one into the stream's
    accumulator (stream m into m % 2), rounds in order; the two accumulators
    added, the block's threads by block_sum; the slices' partials by warp 0."""
    B, C, hw, T, L = p.batch, p.channels, p.hw, K3.THREADS, K3.LOADS // 2  # loads a round
    U = 16 // elem if p.vector else 1  # elements a load
    rows = torch.zeros((p.slices * p.rows, C, hw))
    rows[:B] = xf.reshape(B, C, hw)
    data = rows.reshape(p.slices, p.rows, C, hw).permute(2, 0, 1, 3).reshape(C, p.slices, -1, U)
    n = data.shape[2]
    data = torch.cat([data, data.new_zeros(C, p.slices, -(-n // (L * T)) * L * T - n, U)], 2)
    data = data.reshape(C, p.slices, -1, L // 2, 2, T, U)  # (item..., round, m // 2, m % 2, thread, lane)
    data = data.permute(0, 1, 4, 5, 2, 3, 6).reshape(C, p.slices, 2, T, -1, U)  # loads of an accumulator in order
    s = _seq(_pairwise(data), 4)
    q = _seq_squares(data.reshape(C, p.slices, 2, T, -1), 4)
    return tuple(_combine_runs(_block_sum(a[:, :, 0] + a[:, :, 1]), p.slices) for a in (s, q))


def bn_tiles_mirror(xf, p, elem):
    """The tiles path: per group of ct channels over the whole batch, its
    span of ct * hw columns in each sample, cut into 16-byte slots (W lanes
    each); row group rg = t // slots of the block's THREADS // slots sums
    samples rg, rg + row_groups, ... in order (masked columns and samples add
    0), squares fused one by one; the row groups' columns added in row-group
    order; then channel ch of the group as lanes over its hw columns (lane l
    takes l, l + 32, ...) and a warp tree."""
    B, C, hw, ct = p.batch, p.channels, p.hw, p.ct
    W = 16 // elem
    slots = -(-ct * hw // W)
    row_groups = K3.THREADS // slots
    n = -(-B // row_groups)
    span = torch.zeros((n * row_groups, p.groups * ct, hw))
    span[:B, :C] = xf.reshape(B, C, hw)
    span = span.reshape(n, row_groups, p.groups, ct * hw).permute(2, 0, 1, 3)  # (groups, n, row group, cols)
    out = []
    for cols in (_seq(span, 1), _seq_squares(span, 1)):
        cols = _seq(cols, 1).reshape(p.groups, ct, hw)  # the row groups in order
        k = -(-hw // 32) * 32
        lanes = torch.cat([cols, cols.new_zeros(p.groups, ct, k - hw)], -1).reshape(p.groups, ct, -1, 32)
        out.append(_warp_tree(_seq(lanes, 2)).reshape(-1)[:C])
    return tuple(out)


def bn_mirror(x, aligned=True):
    """(the launch plan, the mirror's (sums, sums of squares)) of ``x``."""
    p = K3.launch_plan(tuple(x.shape), x.element_size(), aligned)
    mirror = bn_runs_mirror if p.path == "runs" else bn_tiles_mirror
    return p, mirror(x.float(), p, x.element_size())


K3_SHAPES = [(2, *s) for s in RESNET50_BN] + [(3, 5, 7, 11), (1061, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_bn_stats_mirror_matches_plain_version(shape, dtype):
    """Each channel's sums within 1e-5 of the plain version's (sum x relative
    to sum |x|, sum x^2 relative), both paths and the masked walk of an
    unaligned base; on integer data, where every order of fp32 sums is exact,
    equal: every element is counted once, in its own channel."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=gen) * 2.0 + 0.5).to(dtype)
    whole = torch.randint(-8, 9, shape, generator=gen).to(dtype)
    ref = K3.bn_stats_reference(x)
    dims = (0,) + tuple(range(2, x.dim()))
    scale = x.float().abs().sum(dims)
    for aligned in (True, False):
        p, (s, s2) = bn_mirror(x, aligned)
        assert p.vector == (aligned and (p.hw if p.path == "runs" else p.channels * p.hw) % (16 // x.element_size()) == 0)
        assert float(((s - ref[0]).abs() / scale).max()) <= 1e-5
        assert float(((s2 - ref[1]).abs() / ref[1]).max()) <= 1e-5
        _, (ws, ws2) = bn_mirror(whole, aligned)
        wref = K3.bn_stats_reference(whole)
        assert torch.equal(ws, wref[0]) and torch.equal(ws2, wref[1])


def test_bn_stats_mirror_ragged_channel_tail():
    """C not a multiple of the channel tile: the last group is shorter and
    its masked columns add nothing."""
    x = torch.randint(-8, 9, (4, 1025, 14, 14)).float()
    p = K3.launch_plan(tuple(x.shape), 4)
    assert p.path == "tiles" and p.channels % p.ct != 0 and p.vector
    _, (s, s2) = bn_mirror(x)
    ref = K3.bn_stats_reference(x)
    assert torch.equal(s, ref[0]) and torch.equal(s2, ref[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_stats_plan_of_a_training_step(dtype):
    """The 53 BatchNorms of a ResNet-50 step at B=64: each one launch of one
    grid with 16-byte loads, at most one wave of blocks, every (sample,
    channel) in exactly one item; on the tiles path each group's span starts
    16-byte aligned in every sample and is a whole number of vectors."""
    es = torch.tensor([], dtype=dtype).element_size()
    width = 16 // es
    assert sum(RESNET50_BN.values()) == 53
    for (C, H, W), _n in RESNET50_BN.items():
        p = K3.launch_plan((64, C, H, W), es)
        assert p.vector, p
        assert 1 <= p.grid <= K3.SLOTS and p.grid == min(p.items, K3.SLOTS), p
        assert p.groups * p.ct >= C > (p.groups - 1) * p.ct
        assert p.slices * p.rows >= 64 > (p.slices - 1) * p.rows
        if p.path == "tiles":
            assert p.ct * p.hw <= K3.THREADS * width and p.slices == 1 and p.rows == 64 and p.groups <= K3.SLOTS
            starts = [(b * C * p.hw + g * p.ct * p.hw) * es for b in range(64) for g in range(p.groups)]
            assert all(s % 16 == 0 for s in starts)
            assert all(min(p.ct, C - g * p.ct) * p.hw % width == 0 for g in range(p.groups))
            # 7x7 and 14x14 (and 28x28 in neither dtype: its runs are whole vectors of more than 1 KB)
            assert H <= 14 and p.scratch_floats == 0
        else:
            assert p.ct == 1 and p.hw % width == 0 and H >= 28
            assert p.scratch_floats == (2 * p.items if p.slices > 1 else 0) and p.groups == C


@pytest.mark.parametrize("shape", [(64, 2048, 7, 7), (8, 256, 14, 14), (64, 64, 112, 112), (3, 5, 7, 11)])
def test_bn_stats_plan_of_an_unaligned_base_masks(shape):
    """A base that is not 16-byte aligned takes the masked scalar walk of the
    same path and grid."""
    for es in (4, 2):
        a, u = K3.launch_plan(shape, es, True), K3.launch_plan(shape, es, False)
        assert not u.vector and u._replace(vector=a.vector) == a

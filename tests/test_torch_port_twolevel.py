"""The 2-level hierarchy (``penetration_depth_2level``,
``collision_loss(backend="2level")``) and the merged payload builder
(``pair_select_tris``) against the JAX package's own functions, jitted.

Inputs: the synthetic hand's Morton-sorted faces, B=4 hand pairs of the
standard and the interlocked OPT families (seed 0), every face (1538) and
every second face (769, the in-loop set), queries at strides 1 and 2. The
groups: 8 (the JAX default; 1538 and 769 leave 6 and 7 padded members), 7
and 2 (no padding at 1538). Each query's selected triangle must be the one
JAX's refinement reads (captured from inside JAX's program), the depths
within 1e-6 and the losses within 1e-6 relative; ``pair_select_tris``'s
triangles bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.ops import collision as JC
from ihmr_tpu.refine.opt_engine import forward as jax_forward
from ihmr_tpu_torch.ops import collision as TC
from tests.torch_threads import one_torch_thread  # noqa: F401

T = lambda x: torch.as_tensor(np.array(x))
CASES = [(8, 1, 1), (8, 2, 2), (7, 2, 1), (2, 1, 2)]  # (group, face stride, query stride)


@pytest.fixture(scope="module", params=["standard", "interlocked"])
def hands(request):
    model = jax_synthetic()
    params, _ = jax_make_opt_inputs(model, batch=4, seed=0, variant=request.param)
    rv, lv, _, _ = jax.jit(jax_forward)(model, params)
    faces = np.asarray(model.faces)
    return np.asarray(rv), np.asarray(lv), faces, np.ascontiguousarray(faces[:, ::-1])


def _jax_depth_and_tris(query, mesh, faces, group):
    """JAX's penetration_depth_2level over the batch, jitted, with the
    triangle its refinement reads captured from inside the program."""
    captured = []
    closest = JC.point_triangle_closest

    def spy(p, tri):
        captured.append(tri)
        return closest(p, tri)

    def fn(q, m):
        def one(qi, mi):
            captured.clear()
            return JC.penetration_depth_2level(qi, mi, jnp.asarray(faces), group), captured[-1]

        return jax.vmap(one)(q, m)

    JC.point_triangle_closest = spy
    try:
        depth, tri = jax.jit(fn)(query, mesh)
    finally:
        JC.point_triangle_closest = closest
    return np.asarray(depth), np.asarray(tri)


@pytest.mark.parametrize("group,fsub,sub", CASES, ids=[f"g{g}-f{f}-q{s}" for g, f, s in CASES])
def test_two_level_selection_and_depth_match_jax(hands, group, fsub, sub):
    rv, lv, faces_r, faces_l = hands
    fr, fl = faces_r[::fsub], faces_l[::fsub]
    for query, mesh, faces in ((rv[:, ::sub], lv, fl), (lv[:, ::sub], rv, fr)):
        ref_depth, ref_tri = _jax_depth_and_tris(query, mesh, faces, group)
        tri = T(mesh)[:, T(faces)]
        idx = TC.nearest_faces_2level(T(query), tri, group)
        ours_tri = tri[torch.arange(len(query))[:, None], idx].numpy()
        assert np.array_equal(ours_tri, ref_tri), f"{(ours_tri != ref_tri).any(axis=(-1, -2)).sum()} selections differ"
        assert int(idx.max()) < len(faces)
        ours = TC.penetration_depth_2level(T(query), T(mesh), T(faces), group).numpy()
        np.testing.assert_allclose(ours, ref_depth, atol=1e-6, rtol=0)


@pytest.mark.parametrize("group,fsub,sub", CASES, ids=[f"g{g}-f{f}-q{s}" for g, f, s in CASES])
def test_two_level_collision_loss_matches_jax(hands, group, fsub, sub):
    rv, lv, faces_r, faces_l = hands
    args = (rv, lv, faces_r[::fsub], faces_l[::fsub], np.array([[1, 1], [1, 1], [1, 0], [1, 1]], np.float32))
    ref = JC.collision_loss(*map(jnp.asarray, args), backend="2level", cluster_group=group, query_subsample=sub,
                            robustifier=0.3)
    ours = TC.collision_loss(*map(T, args), backend="2level", cluster_group=group, query_subsample=sub,
                             robustifier=0.3)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(ours[0]), float(ref[0]), rtol=1e-6)
    assert ours[2].shape == (4, 2 * len(range(0, 778, sub)))


def test_two_level_depth_takes_query_gradients_only(hands):
    rv, lv, faces_r, _ = hands
    q, m = T(lv[:, ::2]).requires_grad_(True), T(rv).requires_grad_(True)
    TC.penetration_depth_2level(q, m, T(faces_r), 8).sum().backward()
    assert m.grad is None and q.grad is not None and bool(torch.isfinite(q.grad).all())
    with pytest.raises(ValueError):
        TC.penetration_depth_2level(q, m, T(faces_r), 0)


@pytest.mark.parametrize("fsub,sub", [(2, 2), (1, 1)])
def test_pair_select_tris_matches_jax_bit_for_bit(hands, fsub, sub):
    rv, lv, faces_r, faces_l = hands
    args = (rv[:, ::sub], lv[:, ::sub], rv, lv, faces_r[::fsub], faces_l[::fsub])
    ref_r, ref_l = jax.jit(JC.pair_select_tris)(*map(jnp.asarray, args))
    ours_r, ours_l = TC.pair_select_tris(*map(T, args))
    assert np.array_equal(ours_r.numpy(), np.asarray(ref_r)) and np.array_equal(ours_l.numpy(), np.asarray(ref_l))
    # the same faces the default pair (pair_indices + pair_tris_at) picks on almost every query
    idx = TC.pair_indices(*map(T, args))
    default_r, _ = TC.pair_tris_at(T(rv), T(lv), T(faces_r[::fsub]), T(faces_l[::fsub]), *idx)
    assert (default_r.numpy() == ours_r.numpy()).all(axis=(-1, -2)).mean() >= 0.99

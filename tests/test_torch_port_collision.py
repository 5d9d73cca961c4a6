"""Parity of the port's collision ops and exact-collision kernel with the JAX package.

The JAX side of the exact kernel runs as ``tests/test_pallas_collision.py``
runs it on the CPU: ``penetration_depth_pallas`` / ``collision_loss(backend=
"pallas")`` in Pallas interpret mode. On the CPU the port's wrapper takes the
plain PyTorch version (``exact_penetration_depth_reference``); the CUDA
kernel itself is held against that plain version on the card by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.

Tolerances: exact depths 1e-5 absolute (fp32, sums in another order); inside
sign equal on >= 99.9% of queries (an exact tie of the tie-set dot could flip
it); ray parity bool-equal; nearest-face selection (a bf16 rank) equal on
>= 99% of queries since near-ties may pick other faces, and depths at the
same faces 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.ops import collision as JC
from ihmr_tpu.ops.pallas_collision import _forward as pallas_forward
from ihmr_tpu.ops.pallas_collision import penetration_depth_pallas
from ihmr_tpu.refine.opt_engine import forward as jax_forward
from ihmr_tpu_torch.ops import collision as TC
from ihmr_tpu_torch.ops import exact_collision as K
from tests.test_collision import icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

T = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def hands():
    """Two interacting synthetic hand pairs (the standard OPT inputs, B=2)."""
    model = jax_synthetic()
    params, _ = jax_make_opt_inputs(model, batch=2, seed=0)
    rv, lv, _, _ = jax.jit(jax_forward)(model, params)
    faces = np.asarray(model.faces)
    return np.asarray(rv), np.asarray(lv), faces, np.ascontiguousarray(faces[:, ::-1])


def _sphere_case(n_faces_pts, n_query, seed):
    verts, faces = icosphere(1.0, n=n_faces_pts)
    q = (np.random.RandomState(seed).randn(n_query, 3) * 0.6).astype(np.float32)
    return q, verts[faces].reshape(-1, 9).astype(np.float32)


def _check_depths(ours, ref, dirs=None, ref_dirs=None):
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert np.mean((ours > 0) == (ref > 0)) >= 0.999
    if dirs is not None:
        both = (ours > 0) & (ref > 0)
        np.testing.assert_allclose(dirs[both], ref_dirs[both], atol=1e-4)


@pytest.mark.parametrize("pts,n_query,seed", [(200, 128, 0), (150, 77, 2), (400, 300, 3)])
def test_exact_plain_vs_pallas_sphere(pts, n_query, seed):
    """Icosphere, including query and face counts that are not multiples of 128."""
    q, tri = _sphere_case(pts, n_query, seed)
    ref, ref_dirs = pallas_forward(jnp.asarray(q), jnp.asarray(tri))
    depth, dirs = K.exact_penetration_depth_with_dir(T(q)[None], T(tri)[None])
    _check_depths(depth[0].numpy(), np.asarray(ref), dirs[0].numpy(), np.asarray(ref_dirs))


def test_exact_plain_vs_pallas_hands(hands):
    rv, lv, faces_r, faces_l = hands
    args = [jnp.asarray(a) for a in (rv, lv, faces_r, faces_l)]
    ref = np.asarray(JC.collision_loss(*args, jnp.ones((2, 2)), backend="pallas")[2])
    ours = K.pair_depths_exact(T(rv), T(lv), T(faces_r), T(faces_l)).numpy()
    assert ours.shape == ref.shape == (2, 1556)
    assert (ref > 0).sum() > 20  # the standard inputs do interpenetrate
    _check_depths(ours, ref)


def test_exact_gradient_matches_jax(hands):
    rv, lv, _, faces_l = hands
    q = rv[0]
    tri = lv[0][faces_l].reshape(-1, 9)
    g_ref = np.asarray(
        jax.grad(lambda x: jnp.sum(penetration_depth_pallas(x, jnp.asarray(tri)) ** 2))(jnp.asarray(q))
    )
    qt = T(q)[None].requires_grad_(True)
    trit = T(tri)[None].requires_grad_(True)
    (K.exact_penetration_depth(qt, trit) ** 2).sum().backward()
    np.testing.assert_allclose(qt.grad[0].numpy(), g_ref, atol=1e-5)
    assert float(trit.grad.abs().max()) == 0.0  # mesh side detached


def test_cpu_path_does_not_count_launches():
    q, tri = _sphere_case(200, 64, 5)
    K.reset_launch_count()
    K.exact_penetration_depth(T(q)[None], T(tri)[None])
    assert K.launch_count == 0


def test_exact_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        K.exact_penetration_depth_with_dir(torch.zeros(1, 5, 3), torch.zeros(1, 4, 3))
    with pytest.raises(ValueError):
        K.exact_penetration_depth_with_dir(torch.zeros(2, 5, 3), torch.zeros(1, 4, 9))


def test_ray_parity_inside_equal(hands):
    rv, lv, faces_r, faces_l = hands
    refs = []
    for q, mesh, faces in ((rv, lv, faces_l), (lv, rv, faces_r)):
        ref = np.stack([np.asarray(JC.ray_parity_inside(*map(jnp.asarray, (q[b], mesh[b], faces)))) for b in range(2)])
        np.testing.assert_array_equal(TC.ray_parity_inside(T(q), T(mesh), T(faces)).numpy(), ref)
        refs.append(ref)
    assert np.any(refs) and not np.all(refs)


def test_point_triangle_closest():
    rng = np.random.RandomState(4)
    p = rng.randn(256, 3).astype(np.float32)
    tri = rng.randn(256, 3, 3).astype(np.float32)
    np.testing.assert_allclose(
        TC.point_triangle_closest(T(p), T(tri)).numpy(),
        np.asarray(JC.point_triangle_closest(jnp.asarray(p), jnp.asarray(tri))),
        atol=1e-5,
    )


def test_nearest_face_selection_and_frozen_depths(hands):
    """The in-loop payload: stride-2 queries, stride-2 faces (both directions),
    against the jitted JAX selection the engine runs."""
    rv, lv, faces_r, faces_l = hands
    fr, fl = faces_r[::2], faces_l[::2]
    qr, ql = rv[:, ::2], lv[:, ::2]
    j = [jnp.asarray(a) for a in (qr, ql, rv, lv, fr, fl)]
    ref_idx = [np.asarray(i) for i in jax.jit(JC.pair_indices)(*j)]  # as the engine runs it
    ours_idx = [i.numpy() for i in TC.pair_indices(*(T(a) for a in (qr, ql, rv, lv, fr, fl)))]
    for o, r in zip(ours_idx, ref_idx):
        assert o.shape == r.shape
        assert np.mean(o == r) >= 0.99
    # depths at the same (JAX-chosen) faces
    ref_tris = JC.pair_tris_at(jnp.asarray(rv), jnp.asarray(lv), jnp.asarray(fr), jnp.asarray(fl), *map(jnp.asarray, ref_idx))
    ours_tris = TC.pair_tris_at(T(rv), T(lv), T(fr), T(fl), *(T(i) for i in ref_idx))
    for o, r in zip(ours_tris, ref_tris):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for margin in (0.0, 0.005):
        ref_d = np.asarray(JC.pair_depths_at_tris(jnp.asarray(qr), jnp.asarray(ql), *ref_tris, margin=margin))
        ours_d = TC.pair_depths_at_tris(T(qr), T(ql), *ours_tris, margin=margin).numpy()
        np.testing.assert_allclose(ours_d, ref_d, atol=1e-5)


def test_aabb_scale_and_depths_to_loss(hands):
    rv, lv, _, _ = hands
    depths = np.abs(np.random.RandomState(6).randn(2, 1556)).astype(np.float32) * 0.01
    hand_type = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    for rob in (None, 0.5):
        ref = JC.depths_to_loss(*map(jnp.asarray, (depths, rv, lv, hand_type)), rob)
        ours = TC.depths_to_loss(*map(T, (depths, rv, lv, hand_type)), rob)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5)
    np.testing.assert_allclose(
        TC.pair_aabb_scale(T(rv), T(lv)).numpy(), np.asarray(JC.pair_aabb_scale(jnp.asarray(rv), jnp.asarray(lv)))
    )


def test_collision_loss_with_parity_filter(hands):
    rv, lv, faces_r, faces_l = hands
    hand_type = np.ones((2, 2), np.float32)
    ref = JC.collision_loss(
        *map(jnp.asarray, (rv, lv, faces_r, faces_l, hand_type)), backend="pallas", parity_filter=True
    )
    ours = TC.collision_loss(*map(T, (rv, lv, faces_r, faces_l, hand_type)), backend="auto", parity_filter=True)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), atol=1e-5)
    # the 2-level hierarchy at its default group ("xla" and "grid" are held to
    # JAX in tests/test_torch_port_kcandidate.py and _grid.py, the hierarchy's
    # selections in tests/test_torch_port_twolevel.py)
    ref = JC.collision_loss(*map(jnp.asarray, (rv, lv, faces_r, faces_l, hand_type)), backend="2level")
    ours = TC.collision_loss(*map(T, (rv, lv, faces_r, faces_l, hand_type)), backend="2level")
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), atol=1e-6)

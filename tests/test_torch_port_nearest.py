"""Parity of the port's nearest-centroid selection (the TPU kernel K2) and the
in-loop ``collision_loss(backend="fast")`` with the JAX package.

The JAX side of K2 runs as on the CPU it always does: ``nearest_centroid_pallas``
in Pallas interpret mode. On the CPU the port's wrapper takes the plain
PyTorch version (``nearest_centroid_reference``); the CUDA kernel is held
against that plain version on the card by ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``.

On the CPU, JAX's ``collision_loss(backend="fast")`` does not run K2: it takes
a bf16 single-candidate rank instead, which picks another face for about a
third of the queries. The port follows the TPU branch (K2's semantics) on
every device, so these tests route the JAX side through that branch with
``jax_tpu_branch``: the module attribute ``ihmr_tpu.ops.collision.jax`` is
swapped for a namespace whose ``devices()`` reports a TPU, while
``pallas_collision`` still asks the real ``jax.devices()`` and so still
interprets the kernel. The JAX package itself is not changed.

Tolerances: indices exactly equal (the same fp32 rank arithmetic and tie
rules on both sides, measured 0 differences); depths at the chosen faces
1e-5 absolute; the loss and per-sample losses 1e-5 relative; the gradient
with respect to the vertices 1e-5 absolute.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_mlp_inputs as jax_make_mlp_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.ops import collision as JC
from ihmr_tpu.ops.pallas_collision import nearest_centroid_pallas
from ihmr_tpu.refine.mlp_engine import seed_from_backbone as jax_seed
from ihmr_tpu.refine.opt_engine import forward as jax_forward
from ihmr_tpu_torch.ops import collision as TC
from ihmr_tpu_torch.ops import nearest_centroid as NC
from tests.test_collision import icosphere

T = lambda x: torch.as_tensor(np.array(x))


@contextlib.contextmanager
def jax_tpu_branch():
    """Run ``ihmr_tpu.ops.collision`` as if on a TPU (see the module docstring).
    Compiled programs are dropped on entry and exit, so no trace of the other
    branch is reused."""

    class _TPUJax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def devices(*_args, **_kwargs):
            return [types.SimpleNamespace(platform="tpu")]

    JC.jax = _TPUJax()
    jax.clear_caches()
    try:
        yield
    finally:
        JC.jax = jax
        jax.clear_caches()


@pytest.fixture(scope="module")
def hands():
    """The MLP workload's seed hands (make_mlp_inputs, B=2, seed 0)."""
    model = jax_synthetic()
    batch = jax_make_mlp_inputs(model, batch=2, seed=0)
    rv, lv, _, _ = jax.jit(jax_forward)(model, jax_seed(batch))
    faces = np.asarray(model.faces)
    return np.asarray(rv), np.asarray(lv), faces, np.ascontiguousarray(faces[:, ::-1])


_jax_nearest = jax.jit(jax.vmap(nearest_centroid_pallas))


def _both(q, cent):
    """(N, V, 3), (N, F, 3) numpy -> (JAX indices, port indices)."""
    ref = np.asarray(_jax_nearest(jnp.asarray(q), jnp.asarray(cent)))
    ours = NC.nearest_centroid(T(q), T(cent)).numpy()
    return ref, ours


def test_nearest_plain_vs_pallas_hands(hands):
    """Both directions of both samples; centroids as the JAX path computes them."""
    rv, lv, faces_r, faces_l = hands
    tri = np.concatenate([lv[:, faces_l], rv[:, faces_r]])  # (2B, F, 3, 3)
    cent = np.asarray(jax.jit(lambda t: jnp.mean(t, axis=2))(tri))
    np.testing.assert_array_equal(TC._centroids(T(tri)).numpy(), cent)
    ref, ours = _both(np.concatenate([rv, lv]), cent)
    assert ours.shape == ref.shape == (4, 778)
    np.testing.assert_array_equal(ours, ref)


def test_nearest_plain_vs_pallas_icosphere():
    """77 queries (not a multiple of 128) against an odd face count."""
    verts, faces = icosphere(1.0, n=150)
    faces = faces[:-1]  # 295 faces
    cent = verts[faces].mean(1)[None].astype(np.float32)
    q = (np.random.RandomState(2).randn(1, 77, 3) * 0.6).astype(np.float32)
    ref, ours = _both(q, cent)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dup,expect", [((3, 10), 6), ((5, 200), 5)])
def test_planted_ties(dup, expect):
    """An exact tie inside a tile gives the mean of the tied indices, cut to
    int ((3 + 10) / 2 -> 6); across tiles the first tile's pick stays (a
    later tile must be strictly better)."""
    rng = np.random.RandomState(7)
    cent = rng.uniform(5.0, 10.0, (1, 300, 3)).astype(np.float32)
    target = np.array([0.1, -0.2, 0.3], np.float32)
    cent[0, list(dup)] = target
    q = (target + rng.uniform(-0.01, 0.01, (1, 20, 3))).astype(np.float32)
    ref, ours = _both(q, cent)
    np.testing.assert_array_equal(ref, expect)
    np.testing.assert_array_equal(ours, expect)


def test_cpu_path_does_not_count_launches(hands):
    rv, lv, _, faces_l = hands
    NC.reset_launch_count()
    NC.nearest_centroid(T(rv), TC._centroids(T(lv[:, faces_l])))
    assert NC.launch_count == 0


def test_nearest_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        NC.nearest_centroid(torch.zeros(1, 5, 3), torch.zeros(1, 4, 9))
    with pytest.raises(ValueError):
        NC.nearest_centroid(torch.zeros(2, 5, 3), torch.zeros(1, 4, 3))


def test_fast_collision_loss_and_gradient_match_jax_tpu_branch(hands):
    rv, lv, faces_r, faces_l = hands
    hand_type = np.ones((2, 2), np.float32)
    jargs = [jnp.asarray(a) for a in (faces_r, faces_l, hand_type)]

    def jloss(r, l):
        out = JC.collision_loss(r, l, *jargs, num_candidates=1, backend="fast")
        return out[0], out

    with jax_tpu_branch():
        (_, ref), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(rv), jnp.asarray(lv)
        )
        ref, ref_grads = jax.tree_util.tree_map(np.asarray, (ref, ref_grads))

    r, l = T(rv).requires_grad_(True), T(lv).requires_grad_(True)
    ours = TC.collision_loss(r, l, *map(T, (faces_r, faces_l, hand_type)), num_candidates=1, backend="fast")
    ours[0].backward()
    assert ref[1][0] > 0  # sample 0 interpenetrates
    np.testing.assert_allclose(ours[0].item(), ref[0], rtol=1e-5)
    np.testing.assert_allclose(ours[1].detach().numpy(), ref[1], rtol=1e-5)
    np.testing.assert_allclose(ours[2].detach().numpy(), ref[2], atol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), ref_grads[0], atol=1e-5)
    np.testing.assert_allclose(l.grad.numpy(), ref_grads[1], atol=1e-5)
    assert float(np.abs(ref_grads[0]).max()) > 1e-3  # a gradient that is there to compare
    with pytest.raises(ValueError):
        TC.collision_loss(r, l, *map(T, (faces_r, faces_l, hand_type)), backend="fast")

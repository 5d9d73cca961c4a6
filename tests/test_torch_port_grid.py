"""The reference's grid field (``ihmr_tpu_torch/ops/grid_sdf.py``) against the
JAX package's ``ops/grid_sdf.py`` on the same numpy inputs (the hands of
``make_opt_inputs(variant="interlocked", batch=2, seed=0)``; JAX jitted, as
the engine runs it).

Bounds and measured gaps:
  * the lattice of ``jnp.linspace(-1, 1, res)`` bit for bit at res 8, 24,
    32 (``torch.linspace`` rounds 20 of the 32 coordinates at res 32 off
    by one place);
  * the grid build at K=1 (argmin face on both sides), whole-hand and
    focused boxes, every 4th face: centres and half-widths bit for bit,
    phi within 1e-6 at every lattice point (measured <= 3.7e-9); at K>1
    the candidate sets differ under bf16 rank ties (see
    tests/test_torch_port_kcandidate.py);
  * ``_focus_box`` bit for bit, overlapping or not;
  * ``trilinear_sample``: values within 1e-6 of JAX's (XLA's CPU backend
    fuses the interpolation's multiply-adds, the port does not), gradients
    within 1e-5 of the largest entry, for queries inside the cube, outside
    it (clipped: below the cube the zero shell, above it the last lattice
    node, as JAX clips) and exactly on the clip bound (JAX's clip gives half
    the gradient there, ``torch.clamp`` would give all);
  * ``collision_loss(backend="grid")``: the JAX package's default build
    (res 32, K=8, full faces) at B=1: the trilinear depths within 1e-6 on
    >= 95% of the queries (K=8 ties may move lattice values; measured: all
    of them) and the loss within 5% relative (measured 3e-6);
  * a build chunked into many calls gives the unchunked bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.ops import collision as JC
from ihmr_tpu.ops import grid_sdf as JG
from ihmr_tpu.refine.opt_engine import forward as jax_forward
from ihmr_tpu_torch.ops import collision as TC
from ihmr_tpu_torch.ops import grid_sdf as TG
from tests.torch_threads import one_torch_thread  # noqa: F401


def T(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def hands():
    model = jax_synthetic()
    params, _ = jax_make_opt_inputs(model, batch=2, seed=0, variant="interlocked")
    rv, lv, _, _ = jax.jit(lambda p: jax_forward(model, p))(params)
    faces = np.asarray(model.faces)
    return np.asarray(rv), np.asarray(lv), faces, np.ascontiguousarray(faces[:, ::-1])


@pytest.mark.parametrize("res", [8, 24, 32])
def test_lattice_is_jax_linspace_bit_for_bit(res):
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, res))())
    np.testing.assert_array_equal(TG.lattice(res).numpy(), want)
    if res == 32:
        assert (torch.linspace(-1.0, 1.0, res).numpy() != want).sum() == 20


@pytest.mark.parametrize("focus", [False, True])
def test_pair_grids_match_jax(hands, focus):
    rv, lv, faces_r, faces_l = hands
    kw = dict(res=8, num_candidates=1, face_subsample=4, focus=focus)
    want = jax.jit(lambda r, l: JG.pair_grids(r, l, faces_r, faces_l, **kw))(rv, lv)
    got = TG.pair_grids(T(rv), T(lv), T(faces_r), T(faces_l), **kw)
    for (wg, wc, wh), (gg, gc, gh) in zip(want, got):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        print(f"grid (focus={focus}): phi {np.abs(gg.numpy() - np.asarray(wg)).max():.3g} from JAX, "
              f"{(np.asarray(wg) > 0).mean():.3f} of lattice points inside")
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=0, atol=1e-6)
        assert (np.asarray(wg) > 0).any()


def test_focus_box_matches_jax(hands):
    rv, lv, _, _ = hands
    apart = lv + np.float32(1.0)  # boxes that do not overlap: the floored cube
    for other in (lv, apart):
        want = jax.jit(jax.vmap(JG._focus_box))(rv, other)
        got = TG._focus_box(T(rv), T(other))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _trilinear_case():
    """A res-9 grid, centre 0 and half 0.5, so x = 8 (q + 0.5) + 1 is exact:
    q = -0.625 lands on the clip bound x = 0."""
    rng = np.random.RandomState(3)
    grid = rng.rand(2, 9, 9, 9).astype(np.float32)
    center = np.zeros((2, 3), np.float32)
    half = np.full((2,), 0.5, np.float32)
    q = (rng.rand(2, 300, 3).astype(np.float32) - 0.5) * 1.6  # inside and outside the cube
    q[:, :20, 0] = -0.625  # on the bound
    return grid, center, half, q


def test_trilinear_values_and_gradients_match_jax():
    grid, center, half, q = _trilinear_case()
    sample = jax.vmap(JG.trilinear_sample)
    want = np.asarray(jax.jit(sample)(grid, center, half, q))
    want_grad = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(sample(grid, center, half, a) ** 2)))(q))
    query = T(q).requires_grad_(True)
    got = TG.trilinear_sample(T(grid), T(center), T(half), query)
    (got ** 2).sum().backward()
    scale = np.abs(want_grad).max()
    print(f"trilinear: values {np.abs(got.detach().numpy() - want).max():.3g}, gradients "
          f"{np.abs(query.grad.numpy() - want_grad).max() / scale:.3g} of the largest entry from JAX's")
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(query.grad.numpy(), want_grad, rtol=0, atol=1e-5 * scale)
    # a cell or more below the cube reads the zero shell; above it, the clip
    # (to res - 1e-6) stops at the last lattice node, as in JAX
    below = (q < -0.5 - 1 / 8).any(-1)
    assert below.any() and np.all(want[below] == 0) and np.all(got.detach().numpy()[below] == 0)


def test_trilinear_clip_bound_takes_half_the_gradient():
    grid, center, half, q = _trilinear_case()
    query = T(q[:, :20]).requires_grad_(True)
    TG.trilinear_sample(T(grid), T(center), T(half), query).sum().backward()
    clamped = T(q[:, :20]).requires_grad_(True)
    # the same sample with torch.clamp: the whole gradient at the bound
    x = (clamped + 0.5) * 8.0 + 1.0
    x.clamp(0.0, 9.0 - 1e-6)[..., 0].sum().backward()
    assert torch.all(clamped.grad[..., 0] == 8.0)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jax.vmap(JG.trilinear_sample)(grid, center, half, a)))(q[:, :20]))
    np.testing.assert_allclose(query.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_grid_collision_loss_matches_jax(hands):
    rv, lv, faces_r, faces_l = hands
    args = (rv[:1], lv[:1], faces_r, faces_l, np.ones((1, 2), np.float32))
    want = JC.collision_loss(*map(jnp.asarray, args), backend="grid")
    got = TC.collision_loss(*map(T, args), backend="grid")
    close = np.abs(got[2].numpy() - np.asarray(want[2])) <= 1e-6
    print(f"grid collision_loss: {float(got[0]):.6g} (JAX {float(want[0]):.6g}); depths within 1e-6 on "
          f"{close.mean():.4f} of queries")
    assert close.mean() >= 0.95
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=0.05)
    assert float(want[0]) > 0


def test_chunked_build_gives_the_same_bits(hands, monkeypatch):
    rv, _, faces_r, _ = hands
    whole = TG.build_penetration_grid(T(rv), T(faces_r[::4]), res=8, num_candidates=2)
    monkeypatch.setattr(TG, "BUILD_CHUNK_PAIRS", 100 * len(faces_r[::4]))  # 100 rows a call
    chunked = TG.build_penetration_grid(T(rv), T(faces_r[::4]), res=8, num_candidates=2)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)

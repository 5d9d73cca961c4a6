"""IHMR-MLP in the port against the JAX package: each module, then the slice.

The JAX side's exact passes run with ``OptConfig(collision_backend="pallas")``
(the exact kernel K1 in interpret mode) and its in-loop pass through the TPU
branch of ``collision_loss(backend="fast")`` (``jax_tpu_branch``, see
``tests/test_torch_port_nearest.py``), which is what the port computes on
every device.

The slice: strategy (mlp_default[0], [3], [5]) cut to epoch=2, N=4 samples
in two batches of 2 (12 train steps, 3 selection passes, the cascade), the
port starting from JAX's initial stage weights carried over with
``subnetwork_from_jax``. Tolerances: each trained stage network's residuals
on the batch 1e-5 absolute; accept masks equal; cached params after each
selection 2e-4 absolute (as tests/test_ref_e2e_opt.py holds the JAX engine
to the reference); tracked losses 1e-4 relative; the cascade's final params
2e-4 and its collision 1e-3 relative. Module parts: losses 1e-5 relative,
gradients 1e-4 relative to their largest entry, SubNetwork outputs 1e-6,
make_mlp_inputs 1e-5 (fp32 decode), schedules and masks equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_mlp_inputs as jax_make_mlp_inputs
from ihmr_tpu.losses import losses as JL
from ihmr_tpu.mano.layer import HandParams as JHandParams
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.models.encoder import SubNetwork as FlaxSubNetwork
from ihmr_tpu.refine import mlp_engine as JM
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import schedule as JS
from ihmr_tpu.train import mlp as JT
from ihmr_tpu_torch.convert import subnetwork_from_jax
from ihmr_tpu_torch.data import BatchList, make_mlp_inputs
from ihmr_tpu_torch.losses import losses as TL
from ihmr_tpu_torch.mano import HandParams, synthetic_mano_model
from ihmr_tpu_torch.refine import mlp_engine as TM
from ihmr_tpu_torch.refine import schedule as TS
from ihmr_tpu_torch.refine.opt_engine import OptConfig
from ihmr_tpu_torch.train import mlp as TT
from ihmr_tpu_torch.train.stats import LossStat
from tests.test_torch_port_nearest import jax_tpu_branch

B, N_BATCHES, EPOCH = 2, 2, 2
STAGES = (0, 3, 5)
T = lambda x: torch.as_tensor(np.array(x))
identity = lambda b: b  # the JAX loops take a batch converter


def _jax_batches(model):
    return [jax_make_mlp_inputs(model, batch=B, seed=i, index_offset=i * B) for i in range(N_BATCHES)]


def _torch_batch(jb):
    return TM.MLPBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(TM.MLPBatch)})


def _strategy(module):
    return tuple(dataclasses.replace(module.mlp_default[i], epoch=EPOCH) for i in STAGES)


def _jax_stage_init(strategy, key=jax.random.PRNGKey(0)):
    """The initial stage variables train_mlp_stages draws (same key splits)."""
    out = []
    for stage in strategy:
        key, init_key = jax.random.split(key)
        variables = FlaxSubNetwork(update_dim=stage.update_dim).init(init_key, jnp.zeros((1, 1024 + 122)))
        out.append(jax.tree_util.tree_map(np.asarray, variables))
    return out


class _Loader(list):
    def set_epoch(self, epoch):
        pass


def _snapshot(caches, to_np):
    return (
        {k: to_np(v).copy() for k, v in caches.prev_params.items()},
        {k: to_np(v).copy() for k, v in caches.prev_losses.items()},
    )


@pytest.fixture(scope="module")
def jax_model():
    return jax_synthetic()


def run_jax_slice(jax_model):
    """Warm pass, training, selection and cascade of the JAX package."""
    strategy = _strategy(JS)
    loader = _Loader(_jax_batches(jax_model))
    cfg = JE.OptConfig(collision_backend="pallas")
    caches = JM.MLPCaches(B * N_BATCHES)
    snaps, stage_stats = [], []
    with jax_tpu_branch():
        JT.warm_pass(jax_model, loader, caches, cfg, identity)
        snaps.append(_snapshot(caches, np.asarray))
        stage_vars = JT.train_mlp_stages(
            jax_model, strategy, loader, caches, cfg, identity, rng_key=jax.random.PRNGKey(0),
            is_main=False, sync_fn=lambda c: snaps.append(_snapshot(c, np.asarray)), stage_stats=stage_stats,
        )

        def subnet_apply(variables, inputs):
            return FlaxSubNetwork(update_dim=variables["params"]["regressor"]["bias"].shape[0]).apply(variables, inputs)

        cascade = JM.make_cascade_apply(jax_model, strategy, subnet_apply, dict(JS.MLP_DEFAULT_LOSS_WEIGHTS), cfg)
        results = [jax.tree_util.tree_map(np.asarray, cascade(tuple(stage_vars), b)) for b in loader]
    return dict(
        snaps=snaps, stage_stats=stage_stats, results=results,
        stage_vars=[jax.tree_util.tree_map(np.asarray, v) for v in stage_vars],
    )


def run_torch_slice(jax_model):
    """The same run in the port, from JAX's initial stage weights."""
    strategy = _strategy(TS)
    init_vars = iter(_jax_stage_init(_strategy(JS)))
    mano = synthetic_mano_model(device="cpu")
    loader = BatchList(_torch_batch(b) for b in _jax_batches(jax_model))
    caches = TM.MLPCaches(B * N_BATCHES, device="cpu")
    snaps, stage_stats = [], []
    original = TT.init_stage_subnetwork
    TT.init_stage_subnetwork = lambda stage, generator, device: subnetwork_from_jax(next(init_vars), device=device)
    try:
        TT.warm_pass(mano, loader, caches, OptConfig())
        snaps.append(_snapshot(caches, lambda t: t.numpy()))
        subnets = TT.train_mlp_stages(
            mano, strategy, loader, caches, OptConfig(), is_main=False,
            sync_fn=lambda c: snaps.append(_snapshot(c, lambda t: t.numpy())), stage_stats=stage_stats,
        )
    finally:
        TT.init_stage_subnetwork = original
    results = TT.test_mlp_loop(mano, strategy, subnets, loader, OptConfig())
    return dict(snaps=snaps, stage_stats=stage_stats, results=results, subnets=subnets, loader=loader)


@pytest.fixture(scope="module")
def jax_slice(jax_model):
    return run_jax_slice(jax_model)


@pytest.fixture(scope="module")
def torch_slice(jax_model):
    return run_torch_slice(jax_model)


def _residuals(jax_slice, torch_slice, stage):
    """Stage ``stage``'s trained network on the first batch at the seed
    params, in both packages -> (JAX, port)."""
    strategy = _strategy(JS)
    tb = torch_slice["loader"][0]
    x = torch.cat([tb.img_feat, TM.flat_params(TM.seed_from_backbone(tb))], dim=-1)
    variables = jax_slice["stage_vars"][stage]
    ref = np.asarray(FlaxSubNetwork(update_dim=strategy[stage].update_dim).apply(variables, jnp.asarray(x.numpy())))
    with torch.no_grad():
        return ref, torch_slice["subnets"][stage](x).numpy()


# ---------------------------------------------------------------------------
# modules


def test_schedules_match_jax():
    for name, strategy in JS.strategies.items():
        ours = TS.strategies[name]
        assert [dataclasses.astuple(s) for s in ours] == [dataclasses.astuple(s) for s in strategy], name
        assert [s.update_dim for s in ours] == [s.update_dim for s in strategy]
    assert TS.MLP_DEFAULT_LOSS_WEIGHTS == JS.MLP_DEFAULT_LOSS_WEIGHTS


def test_hand_params_layout():
    flat = np.random.RandomState(0).randn(3, 122).astype(np.float32)
    ours, ref = HandParams.from_flat(T(flat)), JHandParams.from_flat(jnp.asarray(flat))
    for f in dataclasses.fields(HandParams):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(ours.to_flat().numpy(), flat)
    np.testing.assert_array_equal(ours.pose_params.numpy(), np.asarray(ref.pose_params))
    np.testing.assert_array_equal(ours.shape_params.numpy(), np.asarray(ref.shape_params))
    with pytest.raises(ValueError):
        HandParams.from_flat(torch.zeros(2, 121))


@pytest.mark.parametrize("dim", [45, 48])
def test_mlp_losses_match_jax(dim):
    rng = np.random.RandomState(dim)
    gt, pred = (rng.randn(4, dim) * 0.3).astype(np.float32), (rng.randn(4, dim) * 0.3).astype(np.float32)
    w = rng.rand(4, 1).astype(np.float32)
    np.testing.assert_allclose(
        TL.mano_pose_loss(T(gt), T(pred), T(w)).item(), float(JL.mano_pose_loss(*map(jnp.asarray, (gt, pred, w)))), rtol=1e-5
    )
    np.testing.assert_allclose(
        TL.mano_pose_loss(T(gt), T(pred), T(w), use_hand_rotation=True).item(),
        float(JL.mano_pose_loss(*map(jnp.asarray, (gt, pred, w)), use_hand_rotation=True)),
        rtol=1e-5,
    )
    s1, s2 = rng.randn(4, 10).astype(np.float32), rng.randn(4, 10).astype(np.float32)
    np.testing.assert_allclose(
        TL.mano_shape_loss(T(s1), T(s2), T(w)).item(), float(JL.mano_shape_loss(*map(jnp.asarray, (s1, s2, w)))), rtol=1e-5
    )
    np.testing.assert_allclose(
        TL.shape_residual_loss(T(s1), T(s2)).item(), float(JL.shape_residual_loss(jnp.asarray(s1), jnp.asarray(s2))), rtol=1e-5
    )


def test_subnetwork_from_jax():
    variables = _jax_stage_init((JS.mlp_default[3],))[0]
    x = np.abs(np.random.RandomState(1).randn(3, 1146)).astype(np.float32)
    ref = np.asarray(jax.jit(FlaxSubNetwork(update_dim=90).apply)(variables, jnp.asarray(x)))
    net = subnetwork_from_jax(variables, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(net(T(x)).numpy(), ref, atol=1e-6)
    bad = {"params": dict(variables["params"], extra={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError):
        subnetwork_from_jax(bad, device="cpu")


def test_subnetwork_init_matches_xavier_scale():
    net = TT.init_stage_subnetwork(TS.mlp_default[3], torch.Generator().manual_seed(0), torch.device("cpu"))
    for layer, (fan_in, fan_out) in zip((net.fc1, net.fc2, net.fc3, net.regressor), ((1146, 512), (512, 256), (256, 128), (128, 90))):
        limit = 0.01 * (6.0 / (fan_in + fan_out)) ** 0.5
        assert layer.weight.shape == (fan_out, fan_in)
        top = float(layer.weight.detach().abs().max())
        assert 0.9 * limit < top <= limit
        assert float(layer.bias.detach().abs().max()) == 0.0


def test_make_mlp_inputs_parity(jax_model):
    ref = jax_make_mlp_inputs(jax_model, batch=B, seed=3, index_offset=5)
    ours = make_mlp_inputs(synthetic_mano_model(device="cpu"), batch=B, seed=3, index_offset=5)
    for f in dataclasses.fields(TM.MLPBatch):
        np.testing.assert_allclose(getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name)), atol=1e-5, err_msg=f.name)


def test_in_loop_losses_and_gradients_match_jax(jax_model):
    """The gradient pass of stage training (fast collision) at each stage's
    weights, differentiated with respect to every parameter group."""
    jb = _jax_batches(jax_model)[0]
    tb = _torch_batch(jb)
    mano = synthetic_mano_model(device="cpu")
    jp = JM.seed_from_backbone(jb)
    for stage in (JS.mlp_default[0], JS.mlp_default[3]):
        def jloss(p):
            return JM.compute_losses(jax_model, p, jb, stage.weights, JE.OptConfig(), in_loop=True)

        with jax_tpu_branch():
            (jtot, jaux), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
        leaves = {k: T(v).requires_grad_(True) for k, v in jp.items()}
        ttot, taux = TM.compute_losses(mano, leaves, tb, stage.weights, OptConfig(), in_loop=True)
        tgrad = torch.autograd.grad(ttot, list(leaves.values()))
        np.testing.assert_allclose(ttot.item(), float(jtot), rtol=1e-5)
        assert float(jaux["collision_loss"]) > 0
        for key in ("joints_2d_loss", "joints_3d_loss", "mano_pose_loss", "mano_shape_loss", "hand_trans_loss",
                    "shape_reg_loss", "collision_loss", *TM._TRACKED):
            np.testing.assert_allclose(taux[key].detach().numpy(), np.asarray(jaux[key]), rtol=1e-5, atol=1e-7, err_msg=key)
        for k, g in zip(leaves, tgrad):
            scale = float(np.abs(jgrad[k]).max())
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_select_better_params_masks_match_jax():
    rng = np.random.RandomState(5)
    n = 64
    prev = {k: rng.rand(n).astype(np.float32) for k in TM._TRACKED}
    cur = {k: (v * rng.choice([0.9, 1.0, 1.1], n)).astype(np.float32) for k, v in prev.items()}
    p_prev = {k: rng.randn(n, d).astype(np.float32) for k, d in TS.PARAM_GROUP_DIMS.items()}
    p_cur = {k: rng.randn(n, d).astype(np.float32) for k, d in TS.PARAM_GROUP_DIMS.items()}
    for stage in JS.mlp_default:
        ref_p, ref_l = JM.select_better_params(stage, *(jax.tree_util.tree_map(jnp.asarray, x) for x in (p_cur, cur, p_prev, prev)))
        ours_p, ours_l = TM.select_better_params(stage, *(jax.tree_util.tree_map(T, x) for x in (p_cur, cur, p_prev, prev)))
        for k in ref_p:
            np.testing.assert_array_equal(ours_p[k].numpy(), np.asarray(ref_p[k]), err_msg=k)
        for k in ref_l:
            np.testing.assert_array_equal(ours_l[k].numpy(), np.asarray(ref_l[k]), err_msg=k)
        kept = np.any(np.asarray(ref_p[stage.update_params[0]]) == p_cur[stage.update_params[0]], axis=-1)
        assert 0 < kept.sum() < n  # both verdicts occur


def test_mlp_caches_roundtrip_merge_and_uncached():
    rng = np.random.RandomState(0)
    a, b = TM.MLPCaches(6, device="cpu"), TM.MLPCaches(6, device="cpu")
    params = {k: T(rng.randn(2, d).astype(np.float32)) for k, d in TS.PARAM_GROUP_DIMS.items()}
    losses = {k: T(rng.rand(2).astype(np.float32)) for k in TM._TRACKED}
    feat = T(rng.rand(2, 1024).astype(np.float32))
    b.save(torch.tensor([1, 4]), feat, params, losses)
    with pytest.raises(KeyError):
        a.retrieve(torch.tensor([1]))
    a.merge(b)
    got_feat, got_params, got_losses = a.retrieve(torch.tensor([1, 4]))
    np.testing.assert_array_equal(got_feat.numpy(), feat.numpy())
    for k in params:
        np.testing.assert_array_equal(got_params[k].numpy(), params[k].numpy())
    for k in losses:
        np.testing.assert_array_equal(got_losses[k].numpy(), losses[k].numpy())
    assert a.exists.tolist() == [False, True, False, False, True, False]


def test_loss_stat_running_average(capsys):
    stat = LossStat(4, names=("total_loss", "collision_loss"))
    stat.set_epoch(2)
    stat.update({"total_loss": 1.0, "collision_loss": 3.0}, n=2)
    stat.update({"total_loss": 4.0}, n=1)
    stat.print_loss(2)
    assert stat.meters["total_loss"].avg == 2.0 and stat.meters["collision_loss"].avg == 3.0
    assert capsys.readouterr().out.startswith("epoch:002, iter:2/4")


# ---------------------------------------------------------------------------
# the slice


def test_warm_pass_matches_jax(jax_slice, torch_slice):
    (jp, jl), (tp, tl) = jax_slice["snaps"][0], torch_slice["snaps"][0]
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert jl["collision_loss_batch"].max() > 0


@pytest.mark.parametrize("stage", range(len(STAGES)))
def test_stage_training_and_selection_match_jax(jax_slice, torch_slice, stage):
    strategy = _strategy(JS)
    ref, ours = _residuals(jax_slice, torch_slice, stage)
    np.testing.assert_allclose(ours, ref, atol=1e-5)

    # what the selection pass wrote back: accept masks, params, tracked losses
    (jp0, _), (jp, jl) = jax_slice["snaps"][stage], jax_slice["snaps"][stage + 1]
    (tp0, _), (tp, tl) = torch_slice["snaps"][stage], torch_slice["snaps"][stage + 1]
    groups = strategy[stage].update_params
    j_acc = np.any([np.any(jp[k] != jp0[k], axis=-1) for k in groups], axis=0)
    t_acc = np.any([np.any(tp[k] != tp0[k], axis=-1) for k in groups], axis=0)
    np.testing.assert_array_equal(t_acc, j_acc)
    assert torch_slice["stage_stats"][stage]["accepted_frac"] == jax_slice["stage_stats"][stage]["accepted_frac"]
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-4, err_msg=k)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-7, err_msg=k)


def test_cascade_matches_jax(jax_slice, torch_slice):
    accepted = sum(s["accepted_frac"] for s in jax_slice["stage_stats"])
    assert accepted > 0  # some stage update was kept, so the cascade moved
    for (jparams, jres), tres in zip(jax_slice["results"], torch_slice["results"]):
        np.testing.assert_allclose(tres["pred_pose_params"].numpy(), np.concatenate(
            [jparams["right_orient"], jparams["right_pose"], jparams["left_orient"], jparams["left_pose"]], -1), atol=2e-4)
        for k in ("pred_cam_params", "pred_hand_trans", "pred_shape_params", "pred_pose_params"):
            np.testing.assert_allclose(tres[k].numpy(), jres[k], atol=2e-4, err_msg=k)
        np.testing.assert_allclose(tres["collision_loss"].numpy(), jres["collision_loss"], rtol=1e-3, atol=1e-6)
        assert set(tres) == set(jres) | {"index"}
        assert all(bool(torch.isfinite(v).all()) for v in tres.values())


def report_slice_gaps() -> None:
    """Print how far the port's slice run lies from the JAX package's, per
    stage (the tests above only bound it). From the repo root:

        JAX_PLATFORMS=cpu python -m tests.test_torch_port_mlp
    """
    jm = jax_synthetic()
    js, ts = run_jax_slice(jm), run_torch_slice(jm)
    strategy = _strategy(JS)
    for s in range(len(STAGES)):
        ref, ours = _residuals(js, ts, s)
        (jp0, _), (jp, jl) = js["snaps"][s], js["snaps"][s + 1]
        (_, _), (tp, tl) = ts["snaps"][s], ts["snaps"][s + 1]
        accepted = np.any([np.any(jp[k] != jp0[k], axis=-1) for k in strategy[s].update_params], axis=0)
        print(
            f"stage {s} ({'+'.join(strategy[s].update_params)}): residual max |JAX| {np.abs(ref).max():.3e}, "
            f"max |port - JAX| {np.abs(ours - ref).max():.3e}; cached params max |diff| "
            f"{max(np.abs(tp[k] - jp[k]).max() for k in jp):.3e}; tracked losses max rel diff "
            f"{max((np.abs(tl[k] - jl[k]) / np.maximum(np.abs(jl[k]), 1e-12)).max() for k in jl):.3e}; "
            f"JAX accepts {accepted.astype(int).tolist()}"
        )
    for i, ((jparams, jres), tres) in enumerate(zip(js["results"], ts["results"])):
        gap = max(np.abs(tres[k].numpy() - jres[k]).max() for k in ("pred_cam_params", "pred_hand_trans", "pred_shape_params", "pred_pose_params"))
        print(f"cascade batch {i}: params max |diff| {gap:.3e}; collision port {tres['collision_loss'].numpy().tolist()} "
              f"JAX {jres['collision_loss'].tolist()}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    report_slice_gaps()

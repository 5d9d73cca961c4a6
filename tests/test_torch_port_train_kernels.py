"""IHMR-Baseline training in the port against the JAX package, on the paths
of the two TPU kernels that baseline training runs (the stock-BatchNorm
slice and the modules are in ``tests/test_torch_port_train.py``, whose
setup and bounds this file shares).

  * ``train_step`` with the Pallas BatchNorm statistics: JAX with
    ``ihmr_tpu.models.resnet._BN_IMPL`` patched to "pallas"
    (``PallasStatsBatchNorm``, K3 in interpret mode) against the port's
    ``bn_impl="pallas"`` (K3's plain version on CPU tensors), at the bounds
    of the stock slice.
  * ``eval_step``: JAX's exact backend ("auto" resolves to the Pallas kernel
    K1 under ``jax_tpu_branch``, as on the TPU) against the port's K1 plain
    version, on the first two samples of the batch (the exact metric's
    plain version is the slow part on the CPU): depths 1e-5 absolute,
    metrics 1e-5 relative, encoder outputs 1e-4 relative.
"""

import jax
import numpy as np

from ihmr_tpu.train import baseline as JB
from ihmr_tpu_torch.mano import mirror_mano_model, synthetic_mano_model
from ihmr_tpu_torch.ops import bn_stats as K3
from ihmr_tpu_torch.train import baseline as TB
from tests.test_torch_port_nearest import jax_tpu_branch
from tests.test_torch_port_train import (  # noqa: F401  (one_torch_thread and setup are fixtures)
    LR,
    _check_step1,
    _np,
    _run_jax,
    _run_torch,
    _torch_batch,
    _torch_state,
    one_torch_thread,
    setup,
)


def test_train_step_matches_jax_pallas_bn(setup):
    """PallasStatsBatchNorm (K3 in interpret mode) against bn_impl="pallas"."""
    K3.reset_launch_count()
    ours = _run_torch(setup, "pallas")
    assert K3.launch_count == 0  # CPU tensors take the plain version
    _check_step1(_run_jax(setup, "pallas"), ours)


def test_eval_step_matches_jax_exact_backend(setup):
    enc, cfg, mr, ml, s = (setup[k] for k in ("encoder", "config", "model", "left", "state"))
    batch = jax.tree_util.tree_map(lambda x: x[:2], setup["batch"])
    with jax_tpu_branch():
        jm, jo = _np(JB.eval_step(enc, s, batch, mr, ml, cfg))
    state = _torch_state({"params": _np(s.params), "batch_stats": _np(s.batch_stats)}, "pallas", setup["mean"])
    tr = synthetic_mano_model(device="cpu")
    K3.reset_launch_count()
    tm, to = TB.eval_step(state, _torch_batch(batch), tr, mirror_mano_model(tr), TB.TrainConfig(lr=LR))
    assert K3.launch_count == 0 and not state.encoder.training
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), v, rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(to["collision_loss_origin_scale"].numpy(), jo["collision_loss_origin_scale"], atol=1e-5)
    for k in ("pred_params", "pred_hand_type", "img_feat", "pred_joints_3d"):
        np.testing.assert_allclose(to[k].numpy(), jo[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert to["collision_loss_origin_scale"].shape == (2, 1556)

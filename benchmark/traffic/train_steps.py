"""A closed loop of IHMR-Baseline train steps through ``ihmr_tpu_torch.train.baseline.train_step``.

Each step takes a new batch: ``batch`` images N(0, 0.5^2) drawn on the
device from the seed and the step's index, with the labels of one of
``label_sets`` sets of synthetic hands (``inputs/draws.py``), and, as
``train_baseline_loop`` calls the step, reads the step's metrics to the host
once. ``train_samples_per_s`` is the samples of every step the window started
over the time to the end of the last of them.

Set-up builds one training state (the encoder's weights made from the seed,
Adam's moments at zero, the learning rate of epoch 0) and drives it through
the steps on batches 0..``check_steps`` - 1, recording each step's loss, the
first gradient as Adam holds it (its first moment after one step over
1 - b1) and the BatchNorm running statistics after the first step, and the
parameters' change after all of them; then one more step, and the window goes on with that same
state. The traced stretch is ``trace_steps`` steps under the profiler.

The check runs the plain reference through the same first steps from the
same weights and batches and compares the first step's loss and, per leaf,
the norms of the first gradient, of the running statistics after the first
step and of the change (a leaf whose reference gradient is under a
thousandth of the median leaf's is left out of the change: Adam moves it by
round-off alone). The later steps' losses and running statistics are not
compared: a few entries whose first gradient is within rounding of 0 take
the other sign of Adam's first step, and the random network carries that
into the later steps' values on every seed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import harness
from benchmark.counts import resnet as resnet_counts
from benchmark.inputs import draws, mano_hand
from benchmark.reference import resnet as ref_resnet
from benchmark.reference import train as ref_train

LABEL_KEYS = ("hand_type_array", "hand_type_valid", "joints_2d", "joints_3d", "mano_params_weight", "hand_trans")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(torch.tensor([ref[k] for k in names]).median())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


class Driver:
    def __init__(self, config: Dict, params: Dict, seed: int, device: torch.device):
        self.config, self.params, self.seed, self.device = config, params, seed, device
        self.B = params["batch"]
        self.image = config["image_size"]
        self.index = 0

    def labels(self, i: int) -> Dict[str, torch.Tensor]:
        return draws.hands(self.hand, self.seed, 1000 + i, self.B)

    def batch_dict(self, index: int, lab) -> Dict[str, torch.Tensor]:
        """Step ``index``'s batch on the label set ``lab``, as the reference reads it."""
        out = {k: lab[k] for k in LABEL_KEYS}
        out.update(gt_pose=lab["gt_pose"], gt_shape=lab["gt_shape"],
                   img=draws.images(self.device, self.seed, index, self.B, self.image, "normal"))
        return out

    # ---- the program ----
    def setup(self) -> None:
        from ihmr_tpu_torch.device import set_fp32_matmul_precision
        from ihmr_tpu_torch.mano.loader import mirror_mano_model
        from ihmr_tpu_torch.mano.model import ManoModel
        from ihmr_tpu_torch.models.encoder import InterHandEncoder
        from ihmr_tpu_torch.train.baseline import (TrainConfig, create_state, learning_rate_for_epoch,
                                                   set_learning_rate, train_step)

        self.marks = {"port_imported": time.perf_counter()}
        set_fp32_matmul_precision()
        self.hand = mano_hand.tensors(self.device)
        self.mano_right = ManoModel(**self.hand, is_rhand=True)
        self.mano_left = mirror_mano_model(self.mano_right)
        with torch.device(self.device):
            encoder = InterHandEncoder(self.config["arch"], bn_impl=self.config["bn_impl"])
        weights = draws.encoder_weights(self.device, self.seed)
        with torch.no_grad():
            for k, v in encoder.state_dict().items():
                if k in weights:
                    v.copy_(weights[k])
        del weights
        self.train_config = TrainConfig(**self.config["train_config"])
        self.state = create_state(encoder, ref_resnet.mean_params(self.device), self.train_config)
        set_learning_rate(self.state, learning_rate_for_epoch(self.train_config, 0))
        self.train_step = train_step
        self.label_sets = [self.labels(i) for i in range(self.params["label_sets"])]
        _sync(self.device)
        self.marks["built"] = time.perf_counter()

        # the first steps, recorded for the check, on the state the window keeps
        n = self.params["check_steps"]
        start = {k: v.detach().clone() for k, v in encoder.named_parameters()}
        self.first = {"loss": []}
        for i in range(n):
            self.first["loss"].append(self.step()["total_loss"])
            if i == 0:
                self.first["grad1"] = {k: float(torch.linalg.vector_norm(m.double() / (1 - 0.9)))
                                       for k, m in self.state.adam.m.items()}
                self.first["running1"] = {k: float(torch.linalg.vector_norm(v.double()))
                                          for k, v in encoder.named_buffers() if "running" in k}
        self.first["change"] = {k: float(torch.linalg.vector_norm((v.detach() - start[k]).double()))
                                for k, v in encoder.named_parameters()}
        del start
        self.step()  # one more, so that the window starts on a steady state
        _sync(self.device)
        self.marks["warmed"] = time.perf_counter()

    def step(self) -> Dict[str, float]:
        from ihmr_tpu_torch.train.baseline import BaselineBatch

        b = self.batch_dict(self.index, self.label_sets[self.index % len(self.label_sets)])
        batch = BaselineBatch(img=b["img"], gt_pose_params=b["gt_pose"], gt_shape_params=b["gt_shape"],
                              do_flip=torch.zeros((self.B,), dtype=torch.int32, device=self.device),
                              **{k: b[k] for k in LABEL_KEYS})
        self.index += 1
        self.state, metrics = self.train_step(self.state, batch, self.mano_right, self.mano_left, self.train_config)
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))  # one host read, as the loop's

    def window(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        ends = []
        while time.perf_counter() - t0 < seconds:
            self.step()
            ends.append(time.perf_counter() - t0)
        n = len(ends)
        units = sorted(b - a for a, b in zip([0.0] + ends, ends))
        return {"metrics": {"train_samples_per_s": n * self.B / ends[-1]}, "attempted": n, "failed": 0,
                "units_s": [units[0], units[n // 2], units[-1]]}

    def traced(self) -> Dict:
        spans = harness.Spans()
        k = self.params["trace_steps"]
        _sync(self.device)
        with harness.profiler(self.device) as prof:
            lo = time.time_ns()
            for _ in range(k):
                spans.run("train_step", self.step)
            hi = time.time_ns()
        rec = harness.trace_records(prof, spans, lo, hi)
        rec.update(attempted=k, failed=0, steps=k, batch=self.B,
                   flops=k * self.B * resnet_counts.train_flops(self.image),
                   k3_bytes=k * resnet_counts.bn_input_bytes(self.B, self.image),
                   peak_flops_per_s=self.config["peak_flops_per_s"], peak_bytes_per_s=self.config["peak_bytes_per_s"])
        return rec

    def release(self) -> None:
        self.state = self.mano_right = self.mano_left = self.label_sets = None

    # ---- the check ----
    def check(self, records=None) -> Dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gaps = compare(self, self.first)
        limits = self.params["limits"]
        return {k: {"value": float(v), "limit": limits[k]} for k, v in gaps.items() if k in limits}


def reference_first_steps(drv: Driver, weights) -> Dict:
    """The reference's first ``check_steps`` steps on the driver's seed."""
    p = drv.params["label_sets"]
    batches = [drv.batch_dict(i, drv.labels(i % p)) for i in range(drv.params["check_steps"])]
    return ref_train.run_steps(weights, batches, drv.hand, drv.config["lr"], drv.config["loss_weights"])


def compare(drv: Driver, prog: Dict) -> Dict[str, float]:
    weights = draws.encoder_weights(drv.device, drv.seed)
    ref = reference_first_steps(drv, weights)
    r_grad = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref["grad1"].items()}
    r_change = {k: float(torch.linalg.vector_norm((v - weights[k]).double())) for k, v in ref["params"].items()}
    r_running = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["running1"].items()}
    med = float(torch.tensor(list(r_grad.values())).median())
    moved = {k for k, g in r_grad.items() if g >= 1e-3 * med}
    return {
        "loss1_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad_gap": norm_gap(prog["grad1"], r_grad),
        "update_gap": norm_gap(prog["change"], r_change, moved),
        "running1_gap": norm_gap(prog["running1"], r_running),
    }

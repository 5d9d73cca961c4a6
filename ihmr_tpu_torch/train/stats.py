"""Running loss averages of the training loops (port of the ``LossStat`` part
of ihmr_tpu/train/stats.py). The time-split printers (``TimeStat``,
``OptTimeStat``) are not ported yet."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


LOSS_NAMES = (
    "hand_type_loss",
    "joints_2d_loss",
    "joints_3d_loss",
    "mano_pose_loss",
    "mano_shape_loss",
    "hand_trans_loss",
    "shape_reg_loss",
    "collision_loss",
    "total_loss",
)


class LossStat:
    """Named running averages, printed as one line on request."""

    def __init__(self, num_batches: int, names=LOSS_NAMES):
        self.num_batches = num_batches
        self.epoch = 0
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict((name, AverageMeter()) for name in names)

    def update(self, losses: Dict[str, float], n: int = 1):
        for name, meter in self.meters.items():
            if name in losses:
                meter.update(float(losses[name]), n)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for meter in self.meters.values():
            meter.reset()

    def print_loss(self, batch_idx: int):
        parts = [f"epoch:{self.epoch:03d}, iter:{batch_idx}/{self.num_batches}"]
        parts += [f"{name}:{m.avg:.4f}" for name, m in self.meters.items() if m.count]
        print("  ".join(parts), flush=True)

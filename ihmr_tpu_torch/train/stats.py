"""Telemetry counters of the training loops (port of ihmr_tpu/train/stats.py):
running loss averages (``LossStat``), the epoch's time split into data,
step and the rest (``TimeStat``), and the OPT runner's throughput and ETA
printer (``OptTimeStat``). Times are host-clock; a caller that times device
work synchronises first (the baseline loop reads its losses to the host
inside each step, so the step's device work ends before ``stat_forward_time``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from datetime import datetime
from typing import Dict, Optional


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


class TimeStat:
    """Epoch time split into data / forward (the train step) / visualize."""

    def __init__(self, total_epoch: int = 0, stage_id: int = -1):
        self.total_epoch = total_epoch
        self.stage_id = stage_id
        self.epoch = 0
        self.data_time = self.forward_time = self.vis_time = 0.0

    def epoch_init(self, epoch: int):
        self.epoch = epoch
        self.start = time.perf_counter()
        self.data_time = self.forward_time = self.vis_time = 0.0
        self._mark = self.start

    def _lap(self) -> float:
        now = time.perf_counter()
        dt, self._mark = now - self._mark, now
        return dt

    def stat_data_time(self):
        self.data_time += self._lap()

    def stat_forward_time(self):
        self.forward_time += self._lap()

    def stat_visualize_time(self):
        self.vis_time += self._lap()

    def print_stat(self):
        total = time.perf_counter() - self.start
        stage = f"stage:{self.stage_id:02d}, " if self.stage_id >= 0 else ""
        print(
            f"{stage}epoch:{self.epoch:03d} time {total:.1f}s "
            f"(data {self.data_time:.1f}s, forward {self.forward_time:.1f}s, vis {self.vis_time:.1f}s)",
            flush=True,
        )


class OptTimeStat:
    """Per-iteration wall clock, throughput and ETA of the OPT runner."""

    def __init__(self, iter_total: int, samples_per_iter: Optional[int] = None):
        self.iter_total = iter_total
        self.samples_per_iter = samples_per_iter
        self.iter_count = 0
        self.total_time = 0.0
        self.iter_time = 0.0

    def opt_iter_start(self):
        self._start = time.perf_counter()

    def opt_iter_end(self):
        self.iter_time = time.perf_counter() - self._start
        self.total_time += self.iter_time
        self.iter_count += 1

    @property
    def hands_per_sec(self) -> Optional[float]:
        if self.samples_per_iter is None or self.total_time == 0:
            return None
        return self.iter_count * self.samples_per_iter / self.total_time

    def print_stat(self, opt_complete: bool = False):
        if opt_complete:
            now = datetime.now().strftime("%Y-%m-%d:%H:%M:%S")
            print(
                f"Opt completes in {now}, total time cost: "
                f"{self.total_time / 60:.3f} mins ({self.total_time / 3600:.3f} hours)",
                flush=True,
            )
            return
        speed = self.iter_count / self.total_time
        remain = (self.iter_total - self.iter_count) / max(speed, 1e-9)
        line = (
            f"Opt completes: {self.iter_count}/{self.iter_total}, "
            f"iter time: {self.iter_time:.2f} sec, remain requires: {remain / 60:.2f} mins"
        )
        if self.hands_per_sec is not None:
            line += f", throughput: {self.hands_per_sec:.2f} hands/sec"
        print(line, flush=True)
        print("-------------------------------------------", flush=True)

"""Best-so-far metric tracking across epochs (ref src/utils/eval_utils.py; a
copy of ihmr_tpu/eval/result_stat.py)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class ResultStat:
    RESULT_INFO = [
        ("mpjpe_3d", "small", 1),
        ("inter_mpjpe_3d", "small", 1),
        ("collision_ave", "small", 1),
        ("collision_max", "small", 1),
        # beyond the reference's 4: AUC + handedness accuracy are defined by
        # the reference (metric_utils.py:12-20,146-160) but never surfaced
        ("collision_auc", "large", 1),
        ("hand_type_acc", "large", 1),
    ]

    def __init__(self):
        self.all_results: Dict[str, Tuple[str, float, List]] = {}
        self.best_results: Dict[str, Optional[Tuple[float, object]]] = {}
        self.get_best_results: Dict[str, bool] = {}
        for metric, result_type, scale in self.RESULT_INFO:
            assert result_type in ("large", "small")
            self.all_results[metric] = (result_type, scale, [])
            self.best_results[metric] = None
            self.get_best_results[metric] = False

    def update(self, metric: str, epoch, value: float):
        self.all_results[metric][2].append((epoch, value))
        result_type = self.all_results[metric][0]
        best = self.best_results[metric]
        better = (
            best is None
            or (result_type == "large" and value > best[0])
            or (result_type == "small" and value < best[0])
        )
        if better:
            self.best_results[metric] = (value, epoch)
        self.get_best_results[metric] = better

    def print_current_result(self, epoch):
        print(f"Test of epoch: {epoch} complete")
        parts = []
        for metric, (_t, scale, results) in self.all_results.items():
            if results:
                parts.append(f"{metric}:{results[-1][1] * scale:.3f}")
        print(" ".join(parts))

    def print_best_results(self):
        for metric, (_t, scale, _r) in self.all_results.items():
            if self.best_results[metric] is None:
                continue
            value, epoch = self.best_results[metric]
            print(f"{metric} : {value * scale:.3f} (epoch : {epoch})")

    def achieve_better(self) -> bool:
        return self.get_best_results["inter_mpjpe_3d"]

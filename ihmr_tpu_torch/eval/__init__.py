"""Evaluation (port of ihmr_tpu/eval/): the Evaluator, its metric math, the
best-so-far tracker and the hand-off exporters. Host-side numpy."""

from ihmr_tpu_torch.eval import metrics  # noqa: F401
from ihmr_tpu_torch.eval.evaluator import Evaluator, evaluator_for, results_to_host  # noqa: F401
from ihmr_tpu_torch.eval.result_stat import ResultStat  # noqa: F401

"""Streaming two-hand mesh tracking (port of ihmr_tpu/refine/tracker.py).

Each frame's refinement starts from the previous frame's refined
parameters, so a schedule about ten times shorter than ``opt_default``
suffices, and S independent streams share one batch (the leading batch
dimension is the stream). Per frame: the warm start, optionally blended
with the frame's fresh detection; one ``optimize_batch`` (whose final pass
launches the exact-collision kernel K1 once); an exponential moving average
of the refined parameters as the smoothed output.

    tracker = TwoHandTracker(model)
    state = tracker.init(first_frame_params)
    for frame, detection in video:  # an OptBatch per frame, ParamDict detections
        state, results = tracker.step(state, frame, detection)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, ParamDict, optimize_batch
from ihmr_tpu_torch.refine.schedule import Stage, opt_default


def streaming_strategy(steps_per_stage: int = 30) -> Tuple[Stage, ...]:
    """``opt_default``'s stages (groups, losses, filters) with every stage's
    epoch set to ``steps_per_stage``: the warm-start schedule."""
    return tuple(dataclasses.replace(s, epoch=steps_per_stage) for s in opt_default)


@dataclass(frozen=True)
class TrackerState:
    params: ParamDict  # the previous frame's refined params, (S, ...) each
    ema_params: ParamDict  # the smoothed output stream
    frame_idx: int


class TwoHandTracker:
    def __init__(
        self,
        model: ManoModel,
        strategy: Optional[Sequence[Stage]] = None,
        config: OptConfig = OptConfig(save_mid_freq=5),
        smoothing: float = 0.5,
        blend_with_detection: float = 0.25,
    ):
        """smoothing: the EMA factor of the output (0 = each frame's refined
        params as they are). blend_with_detection: the weight of the frame's
        fresh detection in the warm start (guards against drift)."""
        self.model = model
        self.strategy = tuple(strategy) if strategy is not None else streaming_strategy()
        self.config = config
        self.smoothing = float(smoothing)
        self.blend = float(blend_with_detection)

    def init(self, init_params: ParamDict) -> TrackerState:
        return TrackerState(params=init_params, ema_params=init_params, frame_idx=0)

    def step(
        self,
        state: TrackerState,
        frame: OptBatch,
        detection_params: Optional[ParamDict] = None,
    ) -> Tuple[TrackerState, Dict[str, torch.Tensor]]:
        """Refine one frame of every stream -> (new state, optimize_batch's
        results with "smoothed_params", the EMA dict, added)."""
        warm = state.params
        if detection_params is not None and self.blend > 0:
            b = self.blend
            with torch.no_grad():
                warm = {k: (1.0 - b) * warm[k] + b * detection_params[k] for k in warm}
        refined, results = optimize_batch(self.model, warm, frame, self.strategy, self.config)
        a = self.smoothing
        with torch.no_grad():
            ema = {k: a * state.ema_params[k] + (1.0 - a) * refined[k] for k in refined}
        new_state = TrackerState(params=refined, ema_params=ema, frame_idx=state.frame_idx + 1)
        results = dict(results)
        results["smoothed_params"] = ema
        return new_state, results

"""A closed loop of IHMR-OPT batches through ``ihmr_tpu_torch.pipeline.run_pipeline``.

Each batch is new, drawn from the seed and its index: ``batch`` images and
the hands' initial parameters and keypoint targets (``inputs/draws.py``).
The next batch starts when the last one's results are on the device; the
window counts whole batches, and ``hands_per_s`` is the hands of every batch
the window started over the time to the end of the last of them.

Set-up makes the encoder's weights and the synthetic hand, and warms up
every shape with one batch of the cell's size whose stages are cut to
``warm_epoch`` (a superblock and a tail block each, and the final pass with
the exact kernel). The traced stretch is one batch: the encoder and the
refinement called apart, each in a host span, under the profiler.

The check takes the window's last batch. The reference recomputes the
encoder's 122 parameters and handedness for every image; replays the whole
refinement for ``check_hands`` hands drawn from the seed (each with the
gradient it gets in the whole batch); and, from the program's refined
parameters, recomputes the final pass for every hand: vertices and joints,
the exact depths filtered by the ray-parity test, and the losses.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import exact_collision as k1_counts
from benchmark.counts import mano as mano_counts
from benchmark.counts import resnet as resnet_counts
from benchmark.inputs import draws, mano_hand
from benchmark.reference import opt as ref_opt
from benchmark.reference import resnet as ref_resnet


OPT_BATCH_KEYS = ("hand_type_array", "hand_type_valid", "joints_2d", "joints_3d", "mano_params_weight", "hand_trans",
                  "init_joints_2d", "init_joints_3d", "init_hand_trans_j")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, config: Dict, params: Dict, seed: int, device: torch.device):
        self.config, self.params, self.seed, self.device = config, params, seed, device
        self.B = params["batch"]
        self.image = config["image_size"]
        self.last = None

    # ---- the program ----
    def setup(self) -> None:
        from ihmr_tpu_torch.device import set_fp32_matmul_precision
        from ihmr_tpu_torch.mano.model import ManoModel
        from ihmr_tpu_torch.models.encoder import InterHandEncoder
        from ihmr_tpu_torch.refine.opt_engine import OptConfig, optimize_batch
        from ihmr_tpu_torch.refine.schedule import Stage

        self.marks = {"port_imported": time.perf_counter()}
        set_fp32_matmul_precision()
        self.hand = mano_hand.tensors(self.device)
        self.mano = ManoModel(**self.hand, is_rhand=True)
        with torch.device(self.device):
            self.encoder = InterHandEncoder(self.config["arch"])
        weights = draws.encoder_weights(self.device, self.seed)
        with torch.no_grad():
            for k, v in self.encoder.state_dict().items():
                if k in weights:
                    v.copy_(weights[k])
        self.encoder.eval()
        del weights
        self.mean = ref_resnet.mean_params(self.device)
        self.stages = tuple(
            Stage(update_params=tuple(s["update"]), loss_weights=tuple(sorted(s["weights"].items())), lr=s["lr"],
                  epoch=s["epoch"], filter_loss=tuple(tuple(f) for f in s["filter"]), select_loss=s["select"])
            for s in self.config["stages"]
        )
        self.opt_config = OptConfig(**self.config["opt_config"])
        self.optimize_batch = optimize_batch
        warm = tuple(dataclasses.replace(s, epoch=self.params["warm_epoch"]) for s in self.stages)
        _sync(self.device)
        self.marks["built"] = time.perf_counter()
        self._batch(10**6, warm)
        _sync(self.device)
        self.marks["warmed"] = time.perf_counter()

    def _inputs(self, index: int):
        from ihmr_tpu_torch.refine.opt_engine import OptBatch

        h = draws.hands(self.hand, self.seed, index, self.B)
        batch = OptBatch(gt_pose_params=h["gt_pose"], gt_shape_params=h["gt_shape"],
                         **{k: h[k] for k in OPT_BATCH_KEYS})
        images = draws.images(self.device, self.seed, index, self.B, self.image, "uniform")
        return images, draws.init_params(h), batch

    def _batch(self, index: int, stages=None):
        from ihmr_tpu_torch.pipeline import BenchInputs, run_pipeline

        images, params, batch = self._inputs(index)
        inputs = BenchInputs(encoder=self.encoder, mean_params=self.mean, images=images, mano=self.mano,
                             params=params, opt_batch=batch)
        return run_pipeline(inputs, stages or self.stages, self.opt_config)

    def window(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        n, ends = 0, []
        while time.perf_counter() - t0 < seconds:
            out = self._batch(n)
            _sync(self.device)
            self.last, n = (n, out), n + 1
            ends.append(time.perf_counter() - t0)
        return {"metrics": {"hands_per_s": n * self.B / ends[-1]}, "attempted": n * self.B, "failed": 0,
                "units_s": [b - a for a, b in zip([0.0] + ends, ends)]}

    def traced(self) -> Dict:
        images, params, batch = self._inputs(0)
        spans = harness.Spans()
        sync = lambda: _sync(self.device)  # noqa: E731
        _sync(self.device)
        with harness.profiler(self.device) as prof:
            lo = time.time_ns()
            with torch.no_grad():
                pred, hand_type = spans.run("encoder", self.encoder, images, self.mean, sync=sync)
            refined, results = spans.run("optimize_batch", self.optimize_batch, self.mano, params, batch,
                                         self.stages, self.opt_config, sync=sync)
            spans.run("host_read", lambda: {k: v.cpu() for k, v in refined.items()})
            hi = time.time_ns()
        self.last = (0, (refined, results, pred, hand_type))
        rec = harness.trace_records(prof, spans, lo, hi)
        enc = next(e - s for n, s, e in spans.items if n == "encoder")
        steps = sum(s["epoch"] + 1 for s in self.config["stages"])
        rec.update(attempted=self.B, failed=0, steps=steps, batch=self.B, encoder_s=enc / 1e9,
                   peak_flops_per_s=self.config["peak_flops_per_s"], peak_bytes_per_s=self.config["peak_bytes_per_s"])
        return rec

    def release(self) -> None:
        for name in ("encoder", "mano"):
            setattr(self, name, None)

    # ---- the check ----
    def check(self, records=None) -> Dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        index, (refined, results, pred, hand_type) = self.last
        self.last = None
        h = draws.hands(self.hand, self.seed, index, self.B)
        gaps = compare(self.config, self.params, self.hand, self.seed, index, h, refined, results, pred, hand_type,
                       self.device)
        if records is not None:
            fp = gaps.pop("_final")
            rv, lv = fp["right_verts"], fp["left_verts"]
            faces = self.hand["faces"]
            tri = torch.cat([lv[:, faces.flip(-1)].reshape(self.B, -1, 9), rv[:, faces].reshape(self.B, -1, 9)])
            V = rv.shape[1]
            pairs = k1_counts.pairs_needed(torch.cat([rv, lv]), tri, torch.cat([fp["best_d2"][:, :V], fp["best_d2"][:, V:]]))
            records["k1_flops"] = pairs * k1_counts.FLOP_PER_PAIR
            records["k1_bytes"] = k1_counts.bytes_moved(2 * self.B, V, faces.shape[0])
            work = mano_counts.opt_batch_flops(self.B, self.config["stages"], self.config["opt_config"], pairs)
            records["flops"] = self.B * resnet_counts.forward_flops(self.image) + sum(work.values())
            k1_s, k1_n = harness.kernel_seconds(records, "exact_collision_kernel")
            records["notes"] = {"k1_pairs": pairs, "k1_seconds": k1_s, "k1_launches": k1_n, "work_flops": work}
        gaps.pop("_final", None)
        limits = self.params["limits"]
        return {k: {"value": float(v), "limit": limits[k]} for k, v in gaps.items() if k in limits}


def compare(config, params, hand, seed, index, h, refined, results, pred, hand_type, device) -> Dict:
    """The gaps between the program's outputs and the reference's."""
    B = h["gt_pose"].shape[0]
    weights = draws.encoder_weights(device, seed)
    mean = ref_resnet.mean_params(device)
    ref_pred, ref_ht = [], []
    blk = params["check_block"]
    images = draws.images(device, seed, index, B, config["image_size"], "uniform")
    with torch.no_grad():
        for s in range(0, B, blk):
            p, t = ref_resnet.encoder(weights, images[s:s + blk], mean)
            ref_pred.append(p)
            ref_ht.append(t)
    del weights, images
    ref_pred, ref_ht = torch.cat(ref_pred), torch.cat(ref_ht)
    out = {
        "encoder_gap": float((pred - ref_pred).abs().max() / ref_pred.abs().max()),
        "hand_type_gap": float((hand_type - ref_ht).abs().max()),
    }
    # the refinement, replayed for a sample of the hands
    rng = np.random.RandomState(draws.substream(seed, 4, index) & 0xFFFFFFFF)
    rows = torch.as_tensor(np.sort(rng.choice(B, size=min(params["check_hands"], B), replace=False)), device=device)
    sub = draws.take(h, rows)
    ref_params = ref_opt.optimize(hand, draws.init_params(sub), sub, config["stages"], config["opt_config"], B)
    hand_gap = (ref_opt.join_flat({k: v[rows] for k, v in refined.items()}) - ref_opt.join_flat(ref_params)).abs().amax(1)
    out["refined_gap_median"] = float(hand_gap.median())
    out["refined_parted_share"] = float((hand_gap > params["parted_at"]).float().mean())
    # the final pass, for every hand, from the program's refined parameters
    fp = ref_opt.final_pass(hand, {k: v.detach() for k, v in refined.items()}, h, config["final_weights"], blk)
    out["final_verts_gap"] = float(max((results["pred_right_hand_verts"] - fp["right_verts"]).abs().max(),
                                       (results["pred_left_hand_verts"] - fp["left_verts"]).abs().max(),
                                       (results["pred_joints_3d"] - fp["joints_3d"]).abs().max()))
    gap = (results["collision_loss_origin_scale"] - fp["depths"]).abs()
    out["final_depth_gap"] = float(gap.masked_fill(fp["ambiguous"], 0.0).max())
    out["final_loss_gap"] = float(max(abs(float(results[k]) - float(fp[k])) / abs(float(fp[k]))
                                      for k in ("total_loss", "joints_2d_loss", "joints_3d_loss", "hand_trans_loss")))
    out["_final"] = fp
    return out

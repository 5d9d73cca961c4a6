from ihmr_tpu_torch.data.synthetic import (
    BatchList,
    baseline_raw_batch,
    generate,
    make_baseline_batch,
    make_mlp_inputs,
    make_opt_inputs,
    opt_raw_batch,
)

__all__ = [
    "BatchList",
    "baseline_raw_batch",
    "generate",
    "make_baseline_batch",
    "make_mlp_inputs",
    "make_opt_inputs",
    "opt_raw_batch",
]

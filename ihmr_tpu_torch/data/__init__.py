from ihmr_tpu_torch.data.compose import ComposeDataset
from ihmr_tpu_torch.data.datasets import (
    BaselineDataset,
    DataConfig,
    MLPDataset,
    OPTDataset,
    load_anno_pred_data,
    load_annotation,
)
from ihmr_tpu_torch.data.loader import BatchLoader, collate
from ihmr_tpu_torch.data.synthetic import (
    VARIANTS,
    BatchList,
    baseline_raw_batch,
    generate,
    generate_grazing,
    generate_interlocked,
    make_baseline_batch,
    make_mlp_inputs,
    make_opt_inputs,
    opt_raw_batch,
)

__all__ = [
    "BaselineDataset",
    "BatchList",
    "BatchLoader",
    "ComposeDataset",
    "DataConfig",
    "MLPDataset",
    "OPTDataset",
    "VARIANTS",
    "baseline_raw_batch",
    "collate",
    "generate",
    "generate_grazing",
    "generate_interlocked",
    "load_anno_pred_data",
    "load_annotation",
    "make_baseline_batch",
    "make_mlp_inputs",
    "make_opt_inputs",
    "opt_raw_batch",
]

from ihmr_tpu_torch.data.synthetic import BatchList, generate, make_baseline_batch, make_mlp_inputs, make_opt_inputs

__all__ = ["BatchList", "generate", "make_baseline_batch", "make_mlp_inputs", "make_opt_inputs"]

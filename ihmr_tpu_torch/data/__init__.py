from ihmr_tpu_torch.data.synthetic import generate, make_opt_inputs

__all__ = ["generate", "make_opt_inputs"]

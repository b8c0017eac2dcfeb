from repro_torch.kernels.hdc_encode import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]

from repro_torch.kernels.flash_attention import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]

from repro_torch.kernels.mibo_mc import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]

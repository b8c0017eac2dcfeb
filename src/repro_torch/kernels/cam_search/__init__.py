from repro_torch.kernels.cam_search import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]

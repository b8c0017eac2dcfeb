"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise.

    ``device=None`` means the GPU.  Without one this raises instead of
    falling back to the CPU; callers that want the CPU say
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def device_of(*xs, device=None) -> torch.device:
    """Where a function of ``xs`` runs: ``device`` if given, else the
    device of the first tensor among ``xs``, else the GPU (as
    :func:`resolve_device`)."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device
    return resolve_device(device)

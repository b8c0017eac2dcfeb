"""What every kernel wrapper of the port shares: argument checks, launch
error reporting and launch counts."""

from __future__ import annotations

import threading

import torch


class LaunchCounts(dict):
    """Launches by kernel name, each added where its wrapper launched.

    A plain dict (so it compares and copies as one) with a thread-safe
    :meth:`add` and a :meth:`reset` to 0.
    """

    def __init__(self, *names: str):
        super().__init__((n, 0) for n in names)
        self._lock = threading.Lock()

    def add(self, name: str) -> None:
        with self._lock:
            self[name] += 1

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0


def check(name: str, x, dtype, shape, device, align: int = 1) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor on ``device`` of
    ``dtype`` and ``shape`` whose data is ``align``-byte aligned."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align > 1 and x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def raise_on(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev``, as the pointer ctypes passes."""
    return torch.cuda.current_stream(dev).cuda_stream

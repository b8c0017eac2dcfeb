"""Wrapper of the hand-written CUDA HDC encode kernel (``csrc/hdc_encode.cu``).

:func:`hdc_encode` replaces the Pallas ``hdc_encode``
(``src/repro/kernels/hdc_encode/kernel.py``): the random-projection
product H = X·P in full float32, the row norms ‖x‖ accumulated from the
same X tiles, and the Z-score bucketize ``code = #{t : H > t·‖x‖}`` in the
epilogue.  Ragged B, n and D are masked in the kernel, so nothing is
padded here.

The wrapper takes CUDA tensors only and checks device, dtype, shape and
contiguity; it allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch returns a CUDA error.  It counts
its launches in :data:`launches`.  The library is built and loaded at the
first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LaunchCounts, check, raise_on, stream

#: Most thresholds the kernel takes (bits <= 8).
MAX_THRESHOLDS = 255

#: Wrapper calls that launched their kernel, by kernel name.
launches = LaunchCounts("hdc_encode")
reset_launches = launches.reset

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("hdc_encode")
    if not hasattr(lib, "_repro_bound"):
        lib.hdc_encode_launch.argtypes = [_VP] * 4 + [_I] * 4 + [_VP]
        lib.hdc_encode_launch.restype = _I
        lib._repro_bound = True
    return lib


def hdc_encode(x: torch.Tensor, proj: torch.Tensor,
               thresholds: torch.Tensor) -> torch.Tensor:
    """(B, n) x (n, D) float32 and (T,) float32 thresholds -> (B, D) int32.

    ``code[b, j] = #{t : (x @ proj)[b, j] > thresholds[t] * ||x[b]||}``,
    with ``||x[b]|| = sqrt(sum x[b]^2 + 1e-12)``.
    """
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("x must be a CUDA tensor")
    if x.dim() != 2 or proj.dim() != 2 or thresholds.dim() != 1:
        raise ValueError("x and proj must be 2-D, thresholds 1-D")
    (b, n), d, t = x.shape, proj.shape[1], thresholds.shape[0]
    dev = x.device
    check("x", x, torch.float32, (b, n), dev)
    check("proj", proj, torch.float32, (n, d), dev)
    check("thresholds", thresholds, torch.float32, (t,), dev)
    if b < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: B={b}, n={n}, D={d}")
    if t > MAX_THRESHOLDS:
        raise ValueError(f"{t} thresholds, at most {MAX_THRESHOLDS}")
    out = torch.empty((b, d), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().hdc_encode_launch(
            x.data_ptr(), proj.data_ptr(), thresholds.data_ptr(),
            out.data_ptr(), b, n, d, t, stream(dev))
    raise_on(err, "hdc_encode")
    launches.add("hdc_encode")
    return out

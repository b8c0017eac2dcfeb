"""Public wrapper of the fused HDC encode + quantize kernel.

Port of :mod:`repro.kernels.hdc_encode.ops`.  The device of the operands
decides, and nothing else: CUDA tensors go to the hand-written kernel of
:mod:`~repro_torch.kernels.hdc_encode.kernel` (which raises if it cannot
launch), CPU tensors to the plain version in
:mod:`~repro_torch.kernels.hdc_encode.ref`.  The kernel masks ragged
shapes itself, so unlike the reference nothing is padded.

The thresholds live on each device once (:func:`thresholds`): a call makes
no host-to-device copy of them, so it never waits on the stream.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core import quantize as q
from repro_torch.device import device_of
from repro_torch.kernels.hdc_encode import kernel as _k
from repro_torch.kernels.hdc_encode import ref as _ref


_thresholds: dict[tuple[int, torch.device], torch.Tensor] = {}
_thresholds_lock = threading.Lock()


def thresholds(bits: int, device) -> torch.Tensor:
    """The (2**bits - 1,) float32 thresholds of ``bits`` on ``device``
    (``q.gaussian_thresholds_np``'s values), copied there at the first call
    for the pair and kept; callers must not write to them."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (bits, dev)
    thr = _thresholds.get(key)
    if thr is None:
        with _thresholds_lock:
            thr = _thresholds.get(key)
            if thr is None:
                thr = q.gaussian_thresholds(bits, device=dev)
                _thresholds[key] = thr
    return thr


def encode_quantize(x, proj, bits: int = 3, *, device=None) -> torch.Tensor:
    """(B, n) features x (n, D) projection -> (B, D) int32 level codes.

    ``code = #{t : (x @ proj) > t * ||x||_row}`` over the 2**bits - 1
    Z-score thresholds: for a Gaussian projection, H | x ~ N(0, ||x||^2),
    so the thresholds scale by the row norm.  Host arrays go to ``device``
    (default the GPU); tensors stay where they are.
    """
    if (isinstance(x, torch.Tensor) and isinstance(proj, torch.Tensor)
            and x.device != proj.device):
        raise ValueError(f"x on {x.device} but proj on {proj.device}")
    dev = device_of(x, proj, device=device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    proj = torch.as_tensor(proj, dtype=torch.float32,
                           device=dev).contiguous()
    thr = thresholds(bits, dev)
    if dev.type == "cuda":
        return _k.hdc_encode(x, proj, thr)
    return _ref.encode_quantize(x, proj, thr)

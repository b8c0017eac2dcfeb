"""Wrapper of the hand-written CUDA Monte-Carlo MIBO kernel (``csrc/mibo_mc.cu``).

:func:`mibo_mc` replaces the Pallas ``mibo_mc``
(``src/repro/kernels/mibo_mc/kernel.py``): per sample and cell the
2FeFET pull-up current through the behavioural device model, summed over
the cells whose current exceeds the node-D threshold.  The device
constants come from :mod:`repro_torch.core.fefet` and
:mod:`repro_torch.core.mibo` and are passed to the kernel as arguments.
Any sample count S is taken: ragged S needs no padding.

The wrapper takes CUDA tensors only and checks device, dtype, shape and
contiguity; it allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch returns a CUDA error.  It counts
its launches in :data:`launches`.  The library is built and loaded at the
first launch, never at import.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import fefet, mibo
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LaunchCounts, check, raise_on, stream

#: Wrapper calls that launched their kernel, by kernel name.
launches = LaunchCounts("mibo_mc")
reset_launches = launches.reset

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("mibo_mc")
    if not hasattr(lib, "_repro_bound"):
        lib.mibo_mc_launch.argtypes = [_VP] * 5 + [_I] * 2 + [_F] * 5 + [_VP]
        lib.mibo_mc_launch.restype = _I
        lib._repro_bound = True
    return lib


def mibo_mc(vth1: torch.Tensor, vth2: torch.Tensor, g1: torch.Tensor,
            g2: torch.Tensor) -> torch.Tensor:
    """(S, C) noised V_TH pairs + (1, C) gate voltages -> (S, 1) ML currents.

    All float32 on one CUDA device.
    """
    if not isinstance(vth1, torch.Tensor) or vth1.device.type != "cuda":
        raise ValueError("vth1 must be a CUDA tensor")
    if vth1.dim() != 2:
        raise ValueError("vth1 must be (S, C)")
    s, c = vth1.shape
    dev = vth1.device
    check("vth1", vth1, torch.float32, (s, c), dev)
    check("vth2", vth2, torch.float32, (s, c), dev)
    check("g1", g1, torch.float32, (1, c), dev)
    check("g2", g2, torch.float32, (1, c), dev)
    if s < 1 or c < 1:
        raise ValueError(f"empty operand: S={s}, C={c}")
    out = torch.empty((s, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().mibo_mc_launch(
            vth1.data_ptr(), vth2.data_ptr(), g1.data_ptr(), g2.data_ptr(),
            out.data_ptr(), s, c, math.log(fefet.I_ON),
            math.log(fefet.I_ON / fefet.ON_OFF_RATIO), fefet.SS_V,
            fefet.OVERDRIVE_SLOPE, mibo.I_D_THRESHOLD, stream(dev))
    raise_on(err, "mibo_mc")
    launches.add("mibo_mc")
    return out

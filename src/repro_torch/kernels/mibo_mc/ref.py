"""Plain PyTorch version of the Monte-Carlo MIBO margin kernel.

Port of :mod:`repro.kernels.mibo_mc.ref`, through the port's own device
model.
"""

from __future__ import annotations

import torch

from repro_torch.core import fefet, mibo


def ml_currents(vth1: torch.Tensor, vth2: torch.Tensor, g1: torch.Tensor,
                g2: torch.Tensor) -> torch.Tensor:
    """(S, C) noised V_TH + (1, C) gates -> (S, 1) matchline currents."""
    i_cell = fefet.drain_current(g1, vth1) + fefet.drain_current(g2, vth2)
    mismatch = i_cell > mibo.I_D_THRESHOLD
    return torch.where(mismatch, i_cell, 0.0).sum(dim=1, keepdim=True)

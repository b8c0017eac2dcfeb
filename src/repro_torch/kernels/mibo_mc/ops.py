"""Monte-Carlo sense-margin study of one SEE-MCAM word.

Port of :mod:`repro.kernels.mibo_mc.ops`.  The device of the noise planes
decides, and nothing else: CUDA tensors go to the hand-written kernel of
:mod:`~repro_torch.kernels.mibo_mc.kernel` (which raises if it cannot
launch), CPU tensors to the plain version in
:mod:`~repro_torch.kernels.mibo_mc.ref`.  Noise is drawn from a
``torch.Generator`` where the reference takes a JAX key; the two streams
differ, so :func:`ml_currents_with_noise` takes the noise planes directly.
"""

from __future__ import annotations

import torch

from repro_torch.core import fefet, mibo
from repro_torch.device import device_of
from repro_torch.kernels.mibo_mc import kernel as _k
from repro_torch.kernels.mibo_mc import ref as _ref


def ml_currents_with_noise(stored, query, noise1: torch.Tensor,
                           noise2: torch.Tensor,
                           bits: int = 3) -> torch.Tensor:
    """(S,) matchline currents of a word under given V_TH noise planes.

    ``stored``/``query``: (C,) int symbols; ``noise1``/``noise2``: (S, C)
    float32 V_TH perturbations of F1/F2, on the device that runs.
    """
    noise1 = torch.as_tensor(noise1, dtype=torch.float32)
    noise2 = torch.as_tensor(noise2, dtype=torch.float32,
                             device=noise1.device)
    dev = noise1.device
    vth1, vth2 = mibo.stored_vths(stored, bits, device=dev)
    g1, g2 = mibo.search_gate_voltages(query, bits, device=dev)
    args = ((vth1[None, :] + noise1).contiguous(),
            (vth2[None, :] + noise2).contiguous(),
            g1[None, :].contiguous(), g2[None, :].contiguous())
    run = _k.mibo_mc if dev.type == "cuda" else _ref.ml_currents
    return run(*args)[:, 0]


def monte_carlo_ml_currents(stored, query, bits: int = 3,
                            n_samples: int = 1024, *,
                            generator: torch.Generator | None = None
                            ) -> torch.Tensor:
    """(S,) matchline currents of a word under V_TH variation (sigma=54 mV).

    ``stored``/``query``: (C,) int symbols.  Worst-case margin studies call
    this twice — once with query == stored (match leakage) and once with a
    single-cell mismatch (worst discharge) — and compare the distributions.
    The two (S, C) noise planes are drawn from ``generator`` on its device;
    without one, from the default generator of the device of ``stored`` if
    it is a tensor, else of the GPU.
    """
    dev = (generator.device if generator is not None
           else device_of(stored))
    c = torch.as_tensor(stored).shape[0]
    n1 = fefet.sample_vth_variation(generator, (n_samples, c), device=dev)
    n2 = fefet.sample_vth_variation(generator, (n_samples, c), device=dev)
    return ml_currents_with_noise(stored, query, n1, n2, bits)

"""Core SEE-MCAM library in PyTorch.

The counterpart of :mod:`repro.core`, ported slice by slice.  So far:
:mod:`~repro_torch.core.quantize` (Z-score quantization),
:mod:`~repro_torch.core.am` (the functional associative-search API, single
device), :mod:`~repro_torch.core.hdc` (the quantized HDC pipeline), the
device model (:mod:`~repro_torch.core.fefet`, :mod:`~repro_torch.core.mibo`,
:mod:`~repro_torch.core.cam_array`), the analytical
:mod:`~repro_torch.core.energy` model and the
:mod:`~repro_torch.core.baselines`.
"""

from repro_torch.core import (am, baselines, cam_array, energy, fefet, hdc,
                              mibo, quantize)

__all__ = ["am", "baselines", "cam_array", "energy", "fefet", "hdc", "mibo",
           "quantize"]

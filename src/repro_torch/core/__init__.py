"""Core SEE-MCAM library in PyTorch: quantization and associative search.

The counterpart of :mod:`repro.core`, ported slice by slice.  So far:
:mod:`~repro_torch.core.quantize` (Z-score quantization) and
:mod:`~repro_torch.core.am` (the functional associative-search API, single
device).
"""

from repro_torch.core import am, quantize

__all__ = ["am", "quantize"]

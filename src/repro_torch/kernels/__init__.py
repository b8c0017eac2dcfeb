"""Hand-written CUDA kernels of the port, each beside its plain version.

* :mod:`repro_torch.kernels.cam_search` — the multi-bit CAM search, dense
  (Q, N) mismatch counts and the fused streaming top-k.
* :mod:`repro_torch.kernels.hdc_encode` — the fused HDC random-projection
  encode and Z-score quantize.
* :mod:`repro_torch.kernels.mibo_mc` — Monte-Carlo MIBO matchline currents
  under V_TH variation.

Kernels are built from ``csrc/`` with ``nvcc`` at first launch
(:mod:`repro_torch.kernels._build`), never at import.
"""

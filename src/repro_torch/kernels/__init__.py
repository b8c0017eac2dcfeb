"""Hand-written CUDA kernels of the port, each beside its plain version.

* :mod:`repro_torch.kernels.cam_search` — the multi-bit CAM search, dense
  (Q, N) mismatch counts and the fused streaming top-k.

Kernels are built from ``csrc/`` with ``nvcc`` at first launch
(:mod:`repro_torch.kernels._build`), never at import.
"""

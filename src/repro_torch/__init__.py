"""repro_torch — the SEE-MCAM associative-search stack in PyTorch and CUDA.

A port of the JAX package ``repro`` that keeps its module names and layout,
so every module here has a counterpart there.  It imports ``torch`` and
numpy only: never ``jax`` and never ``repro``.  The CAM-search kernels are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use; each has a plain PyTorch version beside it that CPU tensors take.

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``); with no GPU and no explicit device they raise.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

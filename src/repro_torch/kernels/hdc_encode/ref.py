"""Plain PyTorch version of the fused HDC encode + quantize kernel.

Port of :mod:`repro.kernels.hdc_encode.ref`.  The product runs as one
``torch.matmul`` in full float32 (TF32 is off for matrix products by
default, and this module does not turn it on).
"""

from __future__ import annotations

import torch


def encode_quantize(x: torch.Tensor, proj: torch.Tensor,
                    thresholds: torch.Tensor) -> torch.Tensor:
    """H = x @ proj; code = #{t: H > t * ||x||_row} — analytic Z-score bins.

    (B, n) and (n, D) float32 and (T,) float32 thresholds in sigma units
    -> (B, D) int32 codes in [0, T].
    """
    h = torch.matmul(x, proj)
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
    code = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for t in thresholds:                 # one (B, D) compare per threshold
        code += h > t * norm
    return code

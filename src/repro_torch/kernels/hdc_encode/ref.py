"""Plain PyTorch version of the fused HDC encode + quantize kernel.

Port of :mod:`repro.kernels.hdc_encode.ref`.  The product runs as one
``torch.matmul`` in full float32 (TF32 is off for matrix products by
default, and this module does not turn it on).  The CUDA kernel's
product is float32-accurate (3xTF32), not full float32: it is held
against this version's codes by the reference tolerance and by
``kernel.ENCODE_FP32_FRACTION``.

:func:`tf32_split` and :func:`tf32_product` emulate the kernel's split
and its 3xTF32 (and a single TF32) product on float32 tensors, for tests
of that arithmetic; the operators never call them.
"""

from __future__ import annotations

import torch


def encode_quantize(x: torch.Tensor, proj: torch.Tensor,
                    thresholds: torch.Tensor) -> torch.Tensor:
    """H = x @ proj; code = #{t: H > t * ||x||_row} — analytic Z-score bins.

    (B, n) and (n, D) float32 and (T,) float32 thresholds in sigma units
    -> (B, D) int32 codes in [0, T].
    """
    return codes_from_product(torch.matmul(x, proj), x, thresholds)


def tf32_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``a`` -> (hi, lo), both TF32 values held in float32.

    ``hi`` is ``a`` rounded to TF32's 10 fraction bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits to the magnitude's bit pattern, then clear them); ``lo`` is the
    rest ``a - hi`` (exact in float32) rounded the same way, so
    ``hi + lo`` is ``a`` to within 2^-22 of ``|a|``.
    """
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def tf32_product(x: torch.Tensor, proj: torch.Tensor,
                 terms: int = 3) -> torch.Tensor:
    """x @ proj on TF32 parts, as the kernel's tensor cores take it.

    ``terms=3``: the compensated product, ``lo_x·hi_p + hi_x·lo_p`` and
    then ``hi_x·hi_p``, in float32 (``lo·lo`` dropped); ``terms=1``: the
    single TF32 product ``hi_x·hi_p``.  The parts are exact in float32, so
    each partial product differs from the tensor cores' only in the order
    of its float32 sums.
    """
    xh, xl = tf32_split(x)
    ph, pl = tf32_split(proj)
    if terms == 1:
        return torch.matmul(xh, ph)
    if terms != 3:
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    return (torch.matmul(xl, ph) + torch.matmul(xh, pl)) + torch.matmul(xh,
                                                                        ph)


def codes_from_product(h: torch.Tensor, x: torch.Tensor,
                       thresholds: torch.Tensor) -> torch.Tensor:
    """The bucketize of :func:`encode_quantize` on a given product ``h``."""
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
    code = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for t in thresholds:                 # one (B, D) compare per threshold
        code += h > t * norm
    return code

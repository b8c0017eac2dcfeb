"""The operations and bytes of the fused HDC encode, and the H100 peaks
they are held to.

The peaks are the NVIDIA H100 SXM5 data sheet's dense rates at the full
700 W limit: TF32 on the tensor cores 495 TFLOP/s, HBM3 3.35 TB/s.  The
encode of Q feature rows of n values to D symbols is a 3xTF32 product (each
operand split into a high and a low TF32 part, three products), so 3 x 2
x Q x n x D operations at the TF32 peak; its least bytes are the features,
the projection and the codes once each, four bytes a value.
"""

from __future__ import annotations

PEAK_FLOPS_TF32 = 4.95e14     # tensor cores, TF32, dense
HBM_BW = 3.35e12              # HBM3 bytes/s


def encode_ops(q: float, n: int, d: int) -> float:
    """Tensor-core operations of a 3xTF32 encode of ``q`` rows."""
    return 3.0 * 2.0 * float(q) * n * d


def encode_bytes(q: float, n: int, d: int) -> float:
    """Least bytes an encode of ``q`` rows reads and writes."""
    return (float(q) * n + float(n) * d + float(q) * d) * 4.0


def encode_bound_s(q: float, n: int, d: int) -> float:
    """Least seconds the card could take: the larger of the two terms."""
    return max(encode_ops(q, n, d) / PEAK_FLOPS_TF32,
               encode_bytes(q, n, d) / HBM_BW)

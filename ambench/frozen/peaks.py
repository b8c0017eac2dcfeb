"""Peaks of one NVIDIA H100 SXM, and the operation count of a CAM search.

Copied from ``src/repro_torch/roofline/model.py`` (NVIDIA H100 SXM5 data
sheet, dense rates, at the full 700 W power limit) and its ``bound_ms``.
A CAM search's operations are one symbol compare per query, row and symbol
(Q x N x D), as the program's kernel table counts them at the int8 peak;
its least bytes are every row it scans and every query read once, each
symbol at the table's bits (the benchmark's own count, whatever layout a
kernel packs them in).
"""

from __future__ import annotations

PEAK_OPS_INT8 = 1.979e15      # tensor cores, int8
HBM_BW = 3.35e12              # HBM3 bytes/s


def search_ops(lookups: float, rows: float, width: int) -> float:
    """Symbol compares of ``lookups`` queries against ``rows`` rows each."""
    return float(lookups) * float(rows) * float(width)


def search_bytes(lookups: float, rows: float, width: int,
                 bits: int) -> float:
    """Least bytes a search of ``lookups`` queries over ``rows`` rows reads."""
    return (float(lookups) + float(rows)) * width * bits / 8.0


def bound_s(ops: float, bytes_moved: float = 0.0) -> float:
    """Least seconds the card could take: the larger of the two terms."""
    return max(ops / PEAK_OPS_INT8, bytes_moved / HBM_BW)

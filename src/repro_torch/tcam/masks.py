"""Ternary entry construction: prefixes and value ranges as (code, care).

Port of :mod:`repro.tcam.masks`, line for line: host-side numpy, so every
entry it builds is bitwise the reference's.

An :class:`~repro_torch.core.am.AMTable` row with a care mask matches every query
whose *cared* symbol positions agree — a ternary CAM word.  This module
builds those rows from integer semantics:

* :func:`int_to_code` / :func:`code_to_int` — big-endian base-``2**bits``
  digit encoding, so a ``width``-symbol word covers the value space
  ``[0, 2**(width*bits))`` and a symbol-aligned *prefix* of the binary
  value is exactly a leading run of cared symbols.
* :func:`prefix_entry` — a symbol-aligned prefix as one ternary entry
  (cared prefix symbols, don't-care suffix), the TLB/LPM building block.
* :func:`range_to_entries` — an arbitrary inclusive value range as a
  minimal cover of aligned blocks, i.e. the classic TCAM range-to-prefix
  expansion, here over quantized multi-bit level codes — the discrete
  version of the per-cell acceptance ranges of the complementary-FeFET
  analog CAM (arXiv 2309.09165).
* :func:`prefix_entries` — any prefix length, sub-symbol ones included
  (a sub-symbol prefix is an aligned power-of-two range, so it expands to
  at most ``2**(bits-1)`` symbol-aligned entries via the range cover).

Everything here is host-side numpy — table *construction*, not search.
"""

from __future__ import annotations

import numpy as np


def _check_geometry(width: int, bits: int) -> None:
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")


def int_to_code(value: int, *, width: int, bits: int) -> np.ndarray:
    """Encode an integer as a big-endian (width,) multi-bit symbol word.

    Args:
      value: integer in ``[0, 2**(width*bits))``.
      width: number of symbols per word.
      bits: bits per symbol (symbols are base-``2**bits`` digits).

    Returns:
      (width,) int32 symbols, most-significant digit first.
    """
    _check_geometry(width, bits)
    value = int(value)
    if not 0 <= value < 1 << (width * bits):
        raise ValueError(
            f"value {value} out of range [0, 2**{width * bits})")
    mask = (1 << bits) - 1
    return np.array([(value >> (bits * (width - 1 - i))) & mask
                     for i in range(width)], np.int32)


def code_to_int(code, *, bits: int) -> int:
    """Decode a big-endian symbol word back to its integer value.

    Args:
      code: (width,) integer symbols in ``[0, 2**bits)``.
      bits: bits per symbol.

    Returns:
      The encoded integer.
    """
    code = np.asarray(code)
    _check_geometry(code.shape[-1], bits)
    out = 0
    for s in code.reshape(-1).tolist():
        if not 0 <= s < 1 << bits:
            raise ValueError(f"symbol {s} out of range [0, 2**{bits})")
        out = (out << bits) | s
    return out


def prefix_entry(value: int, prefix_bits: int, *, width: int,
                 bits: int) -> tuple[np.ndarray, np.ndarray]:
    """One ternary entry matching every value under a symbol-aligned prefix.

    Args:
      value: any value under the prefix (host bits below the prefix are
        ignored — the entry is canonicalised to the prefix's base value).
      prefix_bits: prefix length in *bits*; must be a multiple of ``bits``
        (care masks are per symbol — use :func:`prefix_entries` for
        sub-symbol prefix lengths).
      width: symbols per word.
      bits: bits per symbol.

    Returns:
      ``(code, care)`` — two (width,) int32 arrays: the prefix symbols with
      a zero suffix, and 1s over the prefix symbols / 0s (don't-care) over
      the suffix.  An ``am`` masked search against this entry reports
      distance 0 exactly for values sharing the prefix.
    """
    _check_geometry(width, bits)
    total = width * bits
    if not 0 <= prefix_bits <= total:
        raise ValueError(
            f"prefix_bits {prefix_bits} out of range [0, {total}]")
    if prefix_bits % bits:
        raise ValueError(
            f"prefix_bits {prefix_bits} is not symbol-aligned (bits={bits}) "
            "— expand with prefix_entries() instead")
    host = total - prefix_bits
    base = (int(value) >> host) << host
    code = int_to_code(base, width=width, bits=bits)
    care = np.zeros(width, np.int32)
    care[:prefix_bits // bits] = 1
    return code, care


def range_to_entries(lo: int, hi: int, *, width: int,
                     bits: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Cover the inclusive value range [lo, hi] with ternary entries.

    Greedy aligned-block decomposition: from ``lo`` upward, emit the largest
    block of size ``(2**bits)**j`` that starts aligned and fits inside the
    remaining range — each block is one symbol-aligned prefix entry.  This
    is the minimal cover by symbol-aligned prefixes (the TCAM range
    expansion, at most ``2 * width * (2**bits - 1)`` entries).

    Args:
      lo: range start (inclusive).
      hi: range end (inclusive, >= ``lo``).
      width: symbols per word.
      bits: bits per symbol.

    Returns:
      List of ``(code, care)`` entry pairs; a query word matches one of them
      (masked distance 0) iff its value lies in [lo, hi].
    """
    _check_geometry(width, bits)
    lo, hi = int(lo), int(hi)
    if lo > hi:
        raise ValueError(f"empty range [{lo}, {hi}]")
    if not 0 <= lo and hi < 1 << (width * bits):
        raise ValueError(
            f"range [{lo}, {hi}] outside [0, 2**{width * bits})")
    radix = 1 << bits
    entries = []
    cur = lo
    while cur <= hi:
        span, free = 1, 0
        while cur % (span * radix) == 0 and cur + span * radix - 1 <= hi:
            span *= radix
            free += 1
        entries.append(prefix_entry(cur, (width - free) * bits,
                                    width=width, bits=bits))
        cur += span
    return entries


def prefix_entries(value: int, prefix_bits: int, *, width: int,
                   bits: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Expand a prefix of *any* bit length into ternary entries.

    Symbol-aligned prefixes yield the single :func:`prefix_entry`; a
    sub-symbol prefix (``prefix_bits % bits != 0``) is the aligned
    power-of-two value range it denotes, expanded through
    :func:`range_to_entries` into at most ``2**(bits - 1)`` entries.

    Args:
      value: any value under the prefix.
      prefix_bits: prefix length in bits, 0..``width*bits``.
      width: symbols per word.
      bits: bits per symbol.

    Returns:
      List of ``(code, care)`` pairs jointly matching exactly the prefix's
      value range.
    """
    _check_geometry(width, bits)
    total = width * bits
    if not 0 <= prefix_bits <= total:
        raise ValueError(
            f"prefix_bits {prefix_bits} out of range [0, {total}]")
    if prefix_bits % bits == 0:
        return [prefix_entry(value, prefix_bits, width=width, bits=bits)]
    host = total - prefix_bits
    base = (int(value) >> host) << host
    return range_to_entries(base, base + (1 << host) - 1,
                            width=width, bits=bits)

"""Carry state across from the JAX package: tables as numpy planes.

The system has no weights; a table's planes (codes, meta, care) are its
state.  The reference hands them over as numpy arrays
(``np.asarray(table.codes)`` and so on), so this module needs neither JAX
nor the reference package.
"""

from __future__ import annotations

from repro_torch.core import am


def am_table_from_numpy(codes, *, bits: int, distance: str, meta=None,
                        care=None, device=None) -> am.AMTable:
    """An :class:`~repro_torch.core.am.AMTable` from a table's numpy planes.

    ``codes`` (N, D), ``meta`` (N, ...) and ``care`` (N, D) are the planes of
    a reference ``AMTable``; ``bits`` and ``distance`` its static fields.
    ``device=None`` puts the table on the GPU.
    """
    return am.make_table(codes, bits=bits, distance=distance, meta=meta,
                         care_mask=care, device=device)

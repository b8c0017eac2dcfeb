"""Public CAM-search ops: dtype normalisation, padding, device dispatch.

Port of :mod:`repro.kernels.cam_search.ops` (the ``"cuda"`` backend of
:mod:`repro_torch.core.am`).  Symbols are cast to int8 first, as in the
reference.  Then the table's device decides, and nothing else: a CUDA table
goes to the hand-written kernels of
:mod:`~repro_torch.kernels.cam_search.kernel` (D zero-padded on both sides
to a multiple of 16, which always matches, so it adds no mismatches); a CPU
table goes to the plain versions in :mod:`~repro_torch.kernels.cam_search.
ref`.  The two agree bitwise on symbols in ``[0, 2**bits)``; outside that
range the kernels follow the one-hot rule (such a query symbol matches
nothing) and the plain versions compare values.

``l1=True`` (CUDA tables only, ``2 <= bits <= kernel.L1_MAX_BITS``) takes
level codes and counts L1 distances: the int8 codes go unpadded to the
kernels, whose L1 pack makes the one-bit planes of their thermometer
expansion itself (:func:`~repro_torch.kernels.cam_search.kernel.pack_l1`).
The counts equal those of the expanded codes (``repro_torch.core.am.
thermometer``) searched at one bit, as a CPU table is, for codes in int8's
range ``[-128, 128)``: the kernel clamps those to ``[0, 2**bits)`` as the
thermometer does.  A code outside int8 wraps in the cast, as every symbol
does (at 3 bits 256 reads as 0, where the thermometer saturates it to 7).

Contracts (as in the reference): :func:`mismatch_counts` returns the exact
integer number of differing symbol positions; results of the top-k helpers
are ordered by ascending (distance, row index), the lowest row winning
every tie, +inf masked rows included.

The reference's ``merge_alg=`` (a choice between two bitwise-identical TPU
merge networks) has no counterpart here: the CUDA kernel has one merge.

While a profiler records (:mod:`repro_torch.obs`), the casts run in the
spans ``cam.cast.queries`` and ``cam.cast.table`` (the table's care plane
with the table).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.cam_search import kernel as _k
from repro_torch.kernels.cam_search import ref as _ref


def _on_cuda(queries: torch.Tensor, table: torch.Tensor) -> bool:
    if queries.device != table.device:
        raise ValueError(f"queries on {queries.device} but table on "
                         f"{table.device}")
    return table.device.type == "cuda"


def _int8(x: torch.Tensor, pad: bool) -> torch.Tensor:
    """``x`` cast to int8 once, contiguous; for the kernels' symbols
    (``pad``) with D zero-padded to a multiple of ``_k.D_MULTIPLE``."""
    rows, d = x.shape
    dp = -(-d // _k.D_MULTIPLE) * _k.D_MULTIPLE if pad else d
    if dp == d:
        return x.to(torch.int8).contiguous()
    out = torch.zeros((rows, dp), dtype=torch.int8, device=x.device)
    out[:, :d] = x
    return out


def _cast(queries, table, care, pad: bool):
    """Queries, table and care plane (or None) as int8, each in its span."""
    with obs.span("cam.cast.queries"):
        q = _int8(queries, pad)
    with obs.span("cam.cast.table"):
        t = _int8(table, pad)
        c = None if care is None else _int8(care, pad)
    return q, t, c


def _check_l1(l1: bool, cuda: bool) -> None:
    if l1 and not cuda:
        raise ValueError("l1=True takes a CUDA table; expand the codes of a "
                         "CPU table first (am.thermometer)")


def mismatch_counts(queries: torch.Tensor, table: torch.Tensor,
                    bits: int = 3, *, care: torch.Tensor | None = None,
                    l1: bool = False) -> torch.Tensor:
    """(Q, D) queries vs (N, D) stored codes -> (Q, N) int32 mismatch counts.

    ``care`` is an optional (N, D) plane; positions with ``care == 0`` never
    count as mismatches.  ``l1``: L1 distances of level codes (module doc).
    """
    cuda = _on_cuda(queries, table)
    _check_l1(l1, cuda)
    q, t, c = _cast(queries, table, care, cuda and not l1)
    if cuda:
        return _k.cam_search(q, t, levels=1 << bits, care=c, l1=l1)
    return _ref.mismatch_counts(q, t, c)


def exact_match(queries: torch.Tensor, table: torch.Tensor, bits: int = 3, *,
                care: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, N) bool exact word-match flags (the digital CAM output)."""
    return mismatch_counts(queries, table, bits, care=care) == 0


def best_row(queries: torch.Tensor, table: torch.Tensor, bits: int = 3, *,
             care: torch.Tensor | None = None) -> torch.Tensor:
    """(Q,) int32 nearest row, the lowest index among equals."""
    mm = mismatch_counts(queries, table, bits, care=care)
    return torch.argmin(mm, dim=-1).to(torch.int32)


def topk(queries: torch.Tensor, table: torch.Tensor, k: int = 1,
         bits: int = 3, *, care: torch.Tensor | None = None):
    """k nearest rows per query: ((Q, k) int32 indices, (Q, k) int32 counts).

    A stable sort of the dense mismatch matrix, so ties go to the lowest
    row.  ``k`` is clamped to the table size.
    """
    mm = mismatch_counts(queries, table, bits, care=care)
    k = min(k, table.shape[0])
    vals, idx = torch.sort(mm, dim=1, stable=True)
    return idx[:, :k].to(torch.int32), vals[:, :k]


def topk_fused(queries: torch.Tensor, table: torch.Tensor, k: int = 1,
               bits: int = 3, valid_rows=None, *,
               care: torch.Tensor | None = None, count_le=None,
               l1: bool = False):
    """Streaming top-k: ((Q, k) int32 rows, (Q, k) float32 distances).

    Bitwise the order of a stable ascending sort of the dense masked
    matrix.  ``valid_rows`` (int or tensor) counts the live leading rows;
    it is clamped to N and, on the GPU, read by the kernel itself.  ``k``
    is clamped to the table size.  ``count_le`` — a scalar or (Q,) / (Q, 1)
    threshold — adds a third (Q,) int32 output, the number of live rows at
    distance <= threshold.  ``l1``: L1 distances of level codes (module
    doc).
    """
    cuda = _on_cuda(queries, table)
    _check_l1(l1, cuda)
    q, t, c = _cast(queries, table, care, cuda and not l1)
    qn, tn = q.shape[0], t.shape[0]
    k = min(k, tn)
    dev = t.device
    thr = None
    if count_le is not None:
        thr = torch.as_tensor(count_le, dtype=torch.float32, device=dev)
        thr = thr.reshape(-1, 1).expand(qn, 1).contiguous()
    if valid_rows is None:
        vr = torch.full((1,), tn, dtype=torch.int32, device=dev)
    elif isinstance(valid_rows, torch.Tensor):
        vr = valid_rows.to(device=dev, dtype=torch.int32).reshape(1)
        vr = torch.clamp(vr, max=tn)          # padded rows are never live
    else:
        vr = torch.full((1,), min(int(valid_rows), tn), dtype=torch.int32,
                        device=dev)
    if cuda:
        return _k.cam_search_topk(q, t, vr, levels=1 << bits, k=k, care=c,
                                  count_le=thr, l1=l1)
    return _ref.topk(q, t, k, valid_rows=vr, care=c, count_le=thr)

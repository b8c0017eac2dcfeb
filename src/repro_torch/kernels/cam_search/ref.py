"""Plain PyTorch versions of the CAM-search kernels (dense and fused tiers).

Port of :mod:`repro.kernels.cam_search.ref`.  These are what CPU tensors
run, what the tests hold the JAX package against, and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  Both walk the table in row
chunks so the (Q, chunk, D) comparison stays bounded at any table size.

A position counts when ``query != stored`` (and, with a ``care`` plane,
``care != 0``).  This plain inequality is the reference's own rule; the
one-hot kernels additionally treat a query symbol outside ``[0, levels)``
as matching nothing (see :mod:`~repro_torch.kernels.cam_search.kernel`).
The two agree on every in-range input.
"""

from __future__ import annotations

import torch

#: Bound on the elements of one (Q, chunk, D) comparison block.
_CHUNK_ELEMS = 1 << 26

#: Packed-key distance field for +inf (rows at index >= ``valid_rows``).
#: It sorts after every finite count, and keeps the int64 key positive.
_INF_KEY = (1 << 31) - 1


def _row_chunk(qn: int, d: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, qn * d))


def _counts(queries, table, care) -> torch.Tensor:
    diff = queries[:, None, :] != table[None, :, :]
    if care is not None:
        diff &= care[None, :, :] != 0
    return diff.sum(dim=-1, dtype=torch.int32)


def mismatch_counts(queries: torch.Tensor, table: torch.Tensor,
                    care: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, D) x (N, D) int symbols -> (Q, N) int32 #differing positions.

    With ``care`` (an (N, D) 0/1 plane aligned with ``table``), a position
    only counts when it differs AND is cared about.  An all-ones plane
    reproduces the unmasked integers exactly.
    """
    qn, d = queries.shape
    n = table.shape[0]
    step = _row_chunk(qn, d)
    out = torch.empty((qn, n), dtype=torch.int32, device=queries.device)
    for s in range(0, n, step):
        c = None if care is None else care[s:s + step]
        out[:, s:s + step] = _counts(queries, table[s:s + step], c)
    return out


def topk(queries: torch.Tensor, table: torch.Tensor, k: int = 1,
         valid_rows=None, care: torch.Tensor | None = None,
         count_le: torch.Tensor | None = None):
    """Fused-tier version: ((Q, k) int32 rows, (Q, k) f32 distances).

    The order is ascending (distance, row index): among equal distances —
    +inf masked rows included — the lowest row wins, as ``lax.top_k`` over
    the dense masked matrix orders them.  Each chunk's candidates fold into
    the running top-k through a packed int64 key ``(distance << 32) | row``,
    unique per row, so no sort has to be stable.

    ``valid_rows`` (int or tensor) masks rows at index >= it to +inf.
    ``count_le`` — a (Q, 1) float32 threshold — adds a third (Q,) int32
    output: the number of rows at distance <= threshold.
    """
    qn, d = queries.shape
    n = table.shape[0]
    k = min(k, n)
    dev = queries.device
    vr = n if valid_rows is None else valid_rows
    vr = torch.as_tensor(vr, device=dev).reshape(())
    step = _row_chunk(qn, d)
    best = torch.empty((qn, 0), dtype=torch.int64, device=dev)
    count = torch.zeros((qn,), dtype=torch.int32, device=dev)
    for s in range(0, n, step):
        c = None if care is None else care[s:s + step]
        cnt = _counts(queries, table[s:s + step], c).to(torch.int64)
        rows = torch.arange(s, s + cnt.shape[1], device=dev)
        live = rows[None, :] < vr
        if count_le is not None:
            dist = torch.where(live, cnt.to(torch.float32), torch.inf)
            count += (dist <= count_le).sum(dim=1, dtype=torch.int32)
        key = (torch.where(live, cnt, _INF_KEY) << 32) | rows[None, :]
        best = torch.cat([best, key], dim=1)
        best = torch.topk(best, min(k, best.shape[1]), dim=1,
                          largest=False, sorted=True).values
    idx = (best & 0xFFFFFFFF).to(torch.int32)
    dist_key = best >> 32
    dist = torch.where(dist_key == _INF_KEY, torch.inf,
                       dist_key.to(torch.float32))
    if count_le is None:
        return idx, dist
    return idx, dist, count

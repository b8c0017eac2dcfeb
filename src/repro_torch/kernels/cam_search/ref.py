"""Plain PyTorch versions of the CAM-search kernels (dense and fused tiers).

Port of :mod:`repro.kernels.cam_search.ref`.  These are what CPU tensors
run, what the tests hold the JAX package against, and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  Both walk the table in row
chunks so the (Q, chunk, D) comparison stays bounded at any table size.

A position counts when ``query != stored`` (and, with a ``care`` plane,
``care != 0``).  This plain inequality is the reference's own rule; the
one-hot kernels additionally treat a query symbol outside ``[0, levels)``
as matching nothing (see :mod:`~repro_torch.kernels.cam_search.kernel`).
The two agree on every in-range input.  Given ``levels=``, the helpers
below count by the kernels' one-hot rule instead (:func:`onehot_counts`).

The CUDA kernels compare bit-planes: :func:`plane_layout`,
:func:`pack_planes` and :func:`pack_care` are the plain versions of their
pack kernel, :func:`pack_planes_l1` and :func:`pack_care_l1` of the L1
pack kernel, and :func:`plane_counts` counts on packed words as the search
kernels do.
"""

from __future__ import annotations

import torch

#: The kernels take D in multiples of this (16-byte vector loads); the ops
#: layer zero-pads to it.
D_MULTIPLE = 16

#: Bound on the elements of one (Q, chunk, D) comparison block.
_CHUNK_ELEMS = 1 << 26

#: Packed-key distance field for +inf (rows at index >= ``valid_rows``).
#: It sorts after every finite count, and keeps the int64 key positive.
_INF_KEY = (1 << 31) - 1


def _row_chunk(qn: int, d: int, device) -> int:
    """Rows of one (Q, rows, D) comparison block: bounded by
    :data:`_CHUNK_ELEMS`, but on the meta device, where nothing is
    allocated, one block takes every row."""
    if device.type == "meta":
        return 1 << 62
    return max(1, _CHUNK_ELEMS // max(1, qn * d))


def _counts(queries, table, care, levels=None) -> torch.Tensor:
    if levels is not None:
        return onehot_counts(queries, table, levels, care)
    diff = queries[:, None, :] != table[None, :, :]
    if care is not None:
        diff &= care[None, :, :] != 0
    return diff.sum(dim=-1, dtype=torch.int32)


def onehot_counts(queries: torch.Tensor, table: torch.Tensor, levels: int,
                  care: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, D) x (N, D) symbols -> (Q, N) int32 mismatches by the one-hot
    rule of the TPU kernels, ``sum_m onehot_m(q) . onehot_m(t)`` over
    ``m < levels``: a query symbol outside ``[0, levels)`` matches nothing
    (unmasked it always counts, masked never); a table symbol outside it
    differs from every in-range query symbol."""
    q = queries.to(torch.int32)[:, None, :]
    t = table.to(torch.int32)[None, :, :]
    q_in = (q >= 0) & (q < levels)
    if care is None:
        match = (q == t) & q_in
        return (queries.shape[1] - match.sum(dim=-1)).to(torch.int32)
    diff = (q != t) & q_in & (care[None, :, :] != 0)
    return diff.sum(dim=-1, dtype=torch.int32)


def mismatch_counts(queries: torch.Tensor, table: torch.Tensor,
                    care: torch.Tensor | None = None, *,
                    levels: int | None = None) -> torch.Tensor:
    """(Q, D) x (N, D) int symbols -> (Q, N) int32 #differing positions.

    With ``care`` (an (N, D) 0/1 plane aligned with ``table``), a position
    only counts when it differs AND is cared about.  An all-ones plane
    reproduces the unmasked integers exactly.  With ``levels``, positions
    count by the kernels' one-hot rule (:func:`onehot_counts`).
    """
    qn, d = queries.shape
    n = table.shape[0]
    step = _row_chunk(qn, d, queries.device)
    out = torch.empty((qn, n), dtype=torch.int32, device=queries.device)
    for s in range(0, n, step):
        c = None if care is None else care[s:s + step]
        out[:, s:s + step] = _counts(queries, table[s:s + step], c, levels)
    return out


# ---------------------------------------------------------------------------
# Bit-planes: the plain versions of the pack kernel and the plane compare
# ---------------------------------------------------------------------------

def plane_layout(d: int, levels: int) -> tuple[int, int, int]:
    """(planes, words per group, groups per row) of a packed (rows, d) matrix.

    ``planes`` (1, 3 or 7) value planes hold enough bits for
    ``min(levels, 128)`` values; each 32-symbol group is ``planes`` words
    and one in-range word.  Groups are rounded up so that a row is a
    multiple of four words (16-byte rows).
    """
    if levels < 1:
        raise ValueError(f"levels={levels} must be at least 1")
    need = max(1, (min(levels, 128) - 1).bit_length())
    planes = next(p for p in (1, 3, 7) if p >= need)
    words = planes + 1
    groups = -(-d // 32)
    per = max(1, 4 // words)
    return planes, words, -(-groups // per) * per


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in the low 32 bits of int64 ``x``."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 symbols of a group -> (...,) int32 words: symbol
    ``4 i + j`` of the group at bit ``8 j + i``, as the kernel packs."""
    s = torch.arange(32, device=bits.device)
    weight = torch.ones(32, dtype=torch.int64, device=bits.device) << (
        8 * (s % 4) + s // 4)
    w = (bits.to(torch.int64) * weight).sum(dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)      # wrap to int32


def _grouped(x: torch.Tensor, groups: int):
    """(rows, d) -> ((rows, groups, 32) int32 symbols, (rows, groups, 32)
    bool: the symbol lies within d)."""
    rows, d = x.shape
    out = torch.zeros((rows, groups * 32), dtype=torch.int32, device=x.device)
    out[:, :d] = x
    real = torch.zeros(groups * 32, dtype=torch.bool, device=x.device)
    real[:d] = True
    return out.view(rows, groups, 32), real.view(groups, 32).expand(
        rows, groups, 32)


def pack_planes(x: torch.Tensor, levels: int) -> torch.Tensor:
    """(rows, d) int8 symbols -> (rows, groups, planes + 1) int32 words:
    bit ``b`` of each symbol in plane ``b``, then ``0 <= x < levels``;
    symbols past d are zero and out of range."""
    planes, _, groups = plane_layout(x.shape[1], levels)
    sym, real = _grouped(x.to(torch.int32), groups)
    raw = sym & 0xFF                                # the int8 bit pattern
    out = [_words((raw >> b) & 1) for b in range(planes)]
    out.append(_words(real & (sym >= 0) & (sym < min(levels, 128))))
    return torch.stack(out, dim=-1)


def pack_care(care: torch.Tensor, levels: int) -> torch.Tensor:
    """(N, d) care plane -> (N, groups) int32 words of ``care != 0``."""
    _, _, groups = plane_layout(care.shape[1], levels)
    c, real = _grouped(care.to(torch.int32), groups)
    return _words(real & (c != 0))


def l1_width(d: int, bits: int) -> int:
    """Symbols of the L1 planes of ``d`` level codes of ``bits`` bits: the
    ``d (2^bits - 1)`` thermometer rungs, zero-padded to a multiple of
    :data:`D_MULTIPLE` as the kernels take them."""
    rungs = d * ((1 << bits) - 1)
    return -(-rungs // D_MULTIPLE) * D_MULTIPLE


def _rungs(x: torch.Tensor, bits: int):
    """(rows, d) codes -> ((rows, groups, 32) int32 values of the expanded
    symbols, (rows, groups, 32) bool: the symbol lies within the padded
    width), for the L1 planes' layout.  Expanded symbol ``e`` is rung
    ``e % (2^bits - 1) + 1`` of code ``e // (2^bits - 1)``."""
    rows, d = x.shape
    m1 = (1 << bits) - 1
    width = l1_width(d, bits)
    _, _, groups = plane_layout(width, 2)
    e = torch.arange(groups * 32, device=x.device)
    code, rung = e // m1, e % m1 + 1
    inside = code < d
    vals = x.to(torch.int32)[:, torch.where(inside, code, 0)]
    vals = torch.where(inside, vals, 0)
    real = (e < width).view(groups, 32).expand(rows, groups, 32)
    return vals.view(rows, groups, 32), rung.view(groups, 32), real


def pack_planes_l1(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(rows, d) int8 level codes -> (rows, groups, 2) int32 words of
    their thermometer expansion at one bit, ``plane_layout(l1_width(d,
    bits), 2)``: rung ``r`` of a code is set iff ``clamp(code, 0, 2^bits -
    1) >= r``, and the in-range word covers the padded width, so these are
    the words that :func:`pack_planes` makes at ``levels=2`` of the
    zero-padded expansion.  Plain version of the L1 pack kernel."""
    vals, rung, real = _rungs(codes, bits)
    return torch.stack([_words(vals >= rung), _words(real)], dim=-1)


def pack_care_l1(care: torch.Tensor, bits: int) -> torch.Tensor:
    """(N, d) care plane -> (N, groups) int32 words of ``care != 0`` over
    every rung of a code, in :func:`pack_planes_l1`'s layout; the padding
    is never cared for (past the codes, ``_rungs`` reads 0)."""
    vals, _, _ = _rungs(care, bits)
    return _words(vals != 0)


def plane_counts(qp: torch.Tensor, tp: torch.Tensor,
                 cp: torch.Tensor | None, d: int) -> torch.Tensor:
    """Packed (Q, G, W) queries x (N, G, W) table [x (N, G) care words]
    -> (Q, N) int32 mismatches, counted as the kernels count: per group
    ``popc(qv & tv & ~X)`` matches (the count is d minus their sum) or,
    masked, ``popc(care & qv & (X | ~tv))`` mismatches, where ``X`` ORs the
    planes' XORs and ``qv``, ``tv`` are the in-range words."""
    qn, n = qp.shape[0], tp.shape[0]
    q = qp.to(torch.int64)[:, None]
    step = max(1, _CHUNK_ELEMS // max(1, qn * qp.shape[1] * qp.shape[2]))
    out = torch.empty((qn, n), dtype=torch.int32, device=qp.device)
    for s in range(0, n, step):
        t = tp[s:s + step].to(torch.int64)[None]
        x = torch.zeros(torch.broadcast_shapes(q.shape, t.shape)[:-1],
                        dtype=torch.int64, device=qp.device)
        for b in range(qp.shape[2] - 1):
            x |= q[..., b] ^ t[..., b]
        qv, tv = q[..., -1], t[..., -1]
        if cp is None:
            bits = qv & tv & ~x
        else:
            bits = cp[s:s + step].to(torch.int64)[None] & qv & (x | ~tv)
        cnt = _popcount32(bits).sum(dim=-1)
        out[:, s:s + step] = (cnt if cp is not None else d - cnt).to(
            torch.int32)
    return out


def topk(queries: torch.Tensor, table: torch.Tensor, k: int = 1,
         valid_rows=None, care: torch.Tensor | None = None,
         count_le: torch.Tensor | None = None, *, levels: int | None = None):
    """Fused-tier version: ((Q, k) int32 rows, (Q, k) f32 distances).

    The order is ascending (distance, row index): among equal distances —
    +inf masked rows included — the lowest row wins, as ``lax.top_k`` over
    the dense masked matrix orders them.  Each chunk's candidates fold into
    the running top-k through a packed int64 key ``(distance << 32) | row``,
    unique per row, so no sort has to be stable.

    ``valid_rows`` (int or tensor) masks rows at index >= it to +inf.
    ``count_le`` — a (Q, 1) float32 threshold — adds a third (Q,) int32
    output: the number of rows at distance <= threshold.  With ``levels``,
    distances count by the kernels' one-hot rule (:func:`onehot_counts`).
    """
    qn, d = queries.shape
    n = table.shape[0]
    k = min(k, n)
    dev = queries.device
    vr = n if valid_rows is None else valid_rows
    vr = torch.as_tensor(vr, device=dev).reshape(())
    step = _row_chunk(qn, d, queries.device)
    best = torch.empty((qn, 0), dtype=torch.int64, device=dev)
    count = torch.zeros((qn,), dtype=torch.int32, device=dev)
    for s in range(0, n, step):
        c = None if care is None else care[s:s + step]
        cnt = _counts(queries, table[s:s + step], c, levels).to(torch.int64)
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

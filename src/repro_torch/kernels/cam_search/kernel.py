"""Wrappers of the hand-written CUDA CAM-search kernels (``csrc/cam_search.cu``).

* :func:`cam_search` replaces the Pallas ``cam_search``
  (``src/repro/kernels/cam_search/kernel.py``): the dense (Q, N) int32
  mismatch counts.
* :func:`cam_search_topk` replaces the Pallas ``cam_search_topk``: the
  streaming per-query top-k, ``valid_rows`` masked in-kernel, optional
  threshold count.  Bitwise ``lax.top_k`` order over the dense masked
  matrix: ascending (distance, row index), +inf masked rows included.
* :func:`pack` runs the pack kernel both of them start with: queries,
  table and care plane to bit-planes (:func:`~repro_torch.kernels.
  cam_search.ref.pack_planes` is its plain version).
* :func:`pack_l1` runs the L1 pack kernel in its place when they are
  called with ``l1=True``: level codes straight to the one-bit planes of
  their thermometer expansion (:func:`~repro_torch.kernels.cam_search.ref.
  pack_planes_l1`), so that the search counts L1 distances.

Symbols are int8.  Unmasked, a position matches iff ``q == t`` and
``0 <= q < levels``; masked, it is a mismatch iff ``care != 0`` and
``0 <= q < levels`` and ``q != t`` — the one-hot rule of the TPU kernels
(:func:`~repro_torch.kernels.cam_search.ref.onehot_counts`).

The wrappers take CUDA tensors only and check device, dtype, shape,
contiguity and alignment; they allocate outputs and the packed scratch with
``torch.empty``, launch on the current stream and raise if a launch returns
a CUDA error.  Each counts its launches in :data:`launches`: a search call
adds one to ``cam_pack`` (``cam_pack_l1`` with ``l1``) and one to its own
kernel (although the fused kernel runs as two passes); a fused search of a
table of at most :data:`FEW_ROWS_MAX` rows, which takes the few-row partial
pass (one 32-row tile, 16 queries a block), adds one to
``cam_search_topk_few`` as well.  The library is built and loaded at the
first launch, never at import.

While a profiler records (:mod:`repro_torch.obs`), the pack, the L1 pack
and the fused launch run in the spans ``cam.pack``, ``cam.expand.l1`` and
``cam.topk``, and one unmasked, uncounted fused search in
``obs.TRACE_EVERY`` runs the traced partial pass, which adds its votes,
inserts and cycles to the ``cam_topk`` counters; its outputs are the
untraced pass's, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LaunchCounts, check, raise_on, stream
from repro_torch.kernels.cam_search.ref import (D_MULTIPLE, l1_width,
                                                plane_layout)

#: Largest ``k`` :func:`cam_search_topk` takes.
MAX_K = 256

#: Table rows per tile of the kernels (``BN`` in the source).
_BN = 128

#: Tables of at most this many rows take the fused top-k's few-row partial
#: pass: one tile of this many rows (``FEW_BN`` in the source) and 16
#: queries a block (``FEW_BQ``), whatever the batch.
FEW_ROWS_MAX = 32

#: Largest ``bits`` of the L1 pack: a code's 2^bits - 1 rungs fit int8.
L1_MAX_BITS = 7

#: Batches of at most this many queries take 16-query blocks, larger ones
#: 64-query blocks (the source's two ``BQ`` instantiations), on tables of
#: more than :data:`FEW_ROWS_MAX` rows.  0 sends every such batch to
#: 64-query blocks, which is how ``chip_smoke.py`` compares them.
SMALL_TILE_MAX_Q = 16

#: Wrapper calls that launched their kernel, by kernel name.
launches = LaunchCounts("cam_search", "cam_search_topk",
                        "cam_search_topk_few", "cam_pack", "cam_pack_l1")
reset_launches = launches.reset

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("cam_search")
    if not hasattr(lib, "_repro_bound"):
        lib.cam_pack_launch.argtypes = [_VP] * 6 + [_I] * 6 + [_VP]
        lib.cam_pack_launch.restype = _I
        lib.cam_pack_l1_launch.argtypes = [_VP] * 6 + [_I] * 5 + [_VP]
        lib.cam_pack_l1_launch.restype = _I
        lib.cam_search_launch.argtypes = [_VP] * 4 + [_I] * 6 + [_VP]
        lib.cam_search_launch.restype = _I
        lib.cam_search_topk_launch.argtypes = [_VP] * 11 + [_I] * 10 + [_VP]
        lib.cam_search_topk_launch.restype = _I
        lib._repro_bound = True
    return lib


def _check16(name, x, dtype, shape, device):
    check(name, x, dtype, shape, device, align=16)


def _check_inputs(queries, table, care, codes: bool = False):
    """Symbols for :func:`pack`: 16-byte aligned, D a multiple of
    :data:`D_MULTIPLE`; level ``codes`` for :func:`pack_l1`: any D, any
    alignment."""
    if not isinstance(queries, torch.Tensor) or queries.device.type != "cuda":
        raise ValueError("queries must be a CUDA tensor")
    if queries.dim() != 2 or table.dim() != 2:
        raise ValueError("queries and table must be 2-D")
    qn, d = queries.shape
    n = table.shape[0]
    dev = queries.device
    align = 1 if codes else 16
    check("queries", queries, torch.int8, (qn, d), dev, align)
    check("table", table, torch.int8, (n, d), dev, align)
    if care is not None:
        check("care", care, torch.int8, (n, d), dev, align)
    if qn < 1 or n < 1:
        raise ValueError(f"need at least one query and one row, got Q={qn}, "
                         f"N={n}")
    if not codes and d % D_MULTIPLE:
        raise ValueError(f"D={d} must be a multiple of {D_MULTIPLE}")
    return qn, n, d, dev


def _ptr(x):
    return None if x is None else x.data_ptr()


def _tile(qn: int) -> int:
    """Queries per block of a batch of ``qn``."""
    return 16 if qn <= SMALL_TILE_MAX_Q else 64


def pack(queries: torch.Tensor, table: torch.Tensor, *, levels: int,
         care: torch.Tensor | None = None):
    """One launch of the pack kernel: (Q, D) queries and (N, D) table
    [and (N, D) care] int8 -> ((Q, G, W), (N, G, W) [, (N, G)]) int32
    bit-plane words, the layout of ``ref.plane_layout(D, levels)``; the
    third is None without ``care``."""
    qn, n, d, dev = _check_inputs(queries, table, care)
    planes, words, groups = plane_layout(d, levels)
    qp = torch.empty((qn, groups, words), dtype=torch.int32, device=dev)
    tp = torch.empty((n, groups, words), dtype=torch.int32, device=dev)
    cp = (None if care is None else
          torch.empty((n, groups), dtype=torch.int32, device=dev))
    with obs.span("cam.pack"), torch.cuda.device(dev):
        err = _lib().cam_pack_launch(
            queries.data_ptr(), table.data_ptr(), _ptr(care), qp.data_ptr(),
            tp.data_ptr(), _ptr(cp), qn, n, d, levels, planes, groups,
            stream(dev))
    raise_on(err, "cam_pack")
    launches.add("cam_pack")
    return qp, tp, cp


def pack_l1(queries: torch.Tensor, table: torch.Tensor, *, bits: int,
            care: torch.Tensor | None = None):
    """One launch of the L1 pack kernel: (Q, D) queries and (N, D) table
    [and (N, D) care] int8 level codes -> ((Q, G, 2), (N, G, 2) [, (N, G)])
    int32 words of their thermometer expansion at one bit, the layout of
    ``ref.plane_layout(ref.l1_width(D, bits), 2)``: the words that
    :func:`pack` makes at ``levels=2`` of the zero-padded expansion, bit
    for bit (``ref.pack_planes_l1`` and ``ref.pack_care_l1``).  Each int8
    code clamps to ``[0, 2^bits)``; ``2 <= bits <=`` :data:`L1_MAX_BITS`."""
    qn, n, d, dev = _check_inputs(queries, table, care, codes=True)
    if not 2 <= bits <= L1_MAX_BITS:
        raise ValueError(f"bits={bits} outside [2, {L1_MAX_BITS}]")
    _, words, groups = plane_layout(l1_width(d, bits), 2)
    qp = torch.empty((qn, groups, words), dtype=torch.int32, device=dev)
    tp = torch.empty((n, groups, words), dtype=torch.int32, device=dev)
    cp = (None if care is None else
          torch.empty((n, groups), dtype=torch.int32, device=dev))
    with obs.span("cam.expand.l1"), torch.cuda.device(dev):
        err = _lib().cam_pack_l1_launch(
            queries.data_ptr(), table.data_ptr(), _ptr(care), qp.data_ptr(),
            tp.data_ptr(), _ptr(cp), qn, n, d, bits, groups, stream(dev))
    raise_on(err, "cam_pack_l1")
    launches.add("cam_pack_l1")
    return qp, tp, cp


def _packed(queries, table, levels, care, l1):
    """The pack a search starts with: (qp, tp, cp, d, planes, groups), d
    the symbols the search counts over.  With ``l1`` the symbols are level
    codes in ``[0, levels)``, ``levels = 2^bits``, packed by
    :func:`pack_l1` and compared at one bit."""
    if not l1:
        qp, tp, cp = pack(queries, table, levels=levels, care=care)
        d = queries.shape[1]
    else:
        bits = levels.bit_length() - 1
        if levels != 1 << bits:
            raise ValueError(f"levels={levels} of L1 codes must be 2^bits")
        qp, tp, cp = pack_l1(queries, table, bits=bits, care=care)
        d, levels = l1_width(queries.shape[1], bits), 2
    planes, _, groups = plane_layout(d, levels)
    return qp, tp, cp, d, planes, groups


def cam_search(queries: torch.Tensor, table: torch.Tensor, *, levels: int,
               care: torch.Tensor | None = None,
               l1: bool = False) -> torch.Tensor:
    """(Q, D) x (N, D) int8 [+ (N, D) int8 care] -> (Q, N) int32 mismatches.

    With ``l1`` the symbols are level codes, ``levels = 2^bits``, and the
    counts their L1 distances: :func:`pack_l1` packs them."""
    qn, n, _, dev = _check_inputs(queries, table, care, codes=l1)
    qp, tp, cp, d, planes, groups = _packed(queries, table, levels, care, l1)
    out = torch.empty((qn, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().cam_search_launch(
            qp.data_ptr(), tp.data_ptr(), _ptr(cp), out.data_ptr(), qn, n, d,
            planes, groups, _tile(qn), stream(dev))
    raise_on(err, "cam_search")
    launches.add("cam_search")
    return out


def _partial_plan(qn: int, n: int, sms: int):
    """The partial pass of a fused top-k of ``qn`` queries over ``n`` rows
    on a card of ``sms`` SMs: (queries a block, rows a tile, splits, rows
    a split, the launch counts the call adds to).  A table of at most
    :data:`FEW_ROWS_MAX` rows is one tile of that many rows, one split,
    and 16-query blocks; a larger one takes 128-row tiles, the blocks of
    :func:`_tile`, and about four blocks per SM, whole tiles a split."""
    if n <= FEW_ROWS_MAX:
        return (16, FEW_ROWS_MAX, 1, FEW_ROWS_MAX,
                ("cam_search_topk", "cam_search_topk_few"))
    bq = _tile(qn)
    tiles = -(-n // _BN)
    splits = max(1, min(tiles, -(-4 * sms // -(-qn // bq))))
    per = -(-tiles // splits)
    return bq, _BN, -(-tiles // per), per * _BN, ("cam_search_topk",)


def cam_search_topk(queries: torch.Tensor, table: torch.Tensor,
                    valid_rows: torch.Tensor, *, levels: int, k: int,
                    care: torch.Tensor | None = None,
                    count_le: torch.Tensor | None = None, l1: bool = False):
    """Streaming top-k: ((Q, k) int32 rows, (Q, k) float32 distances).

    ``valid_rows`` is a (1,) int32 CUDA tensor that the kernel reads itself
    (no host sync); rows at index >= it get +inf.  ``count_le`` is an
    optional (Q, 1) float32 threshold; with it a third (Q,) int32 output
    counts the rows at distance <= threshold.  ``1 <= k <= min(N, 256)``.
    While a profiler records, one unmasked search without ``count_le`` in
    ``obs.TRACE_EVERY`` adds to :mod:`repro_torch.obs`'s ``cam_topk``
    counters.  ``l1``: level codes at L1 distance, as in
    :func:`cam_search`.  A table of at most :data:`FEW_ROWS_MAX` rows
    takes the few-row partial pass (:func:`_partial_plan`), bitwise the
    same results.
    """
    qn, n, _, dev = _check_inputs(queries, table, care, codes=l1)
    _check16("valid_rows", valid_rows, torch.int32, (1,), dev)
    if count_le is not None:
        _check16("count_le", count_le, torch.float32, (qn, 1), dev)
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"k={k} outside [1, min(N={n}, {MAX_K})]")
    qp, tp, cp, d, planes, groups = _packed(queries, table, levels, care, l1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bq, bn, splits, rows_per_split, counts = _partial_plan(qn, n, sms)
    part_keys = torch.empty((qn, splits, k), dtype=torch.int64, device=dev)
    idx = torch.empty((qn, k), dtype=torch.int32, device=dev)
    dist = torch.empty((qn, k), dtype=torch.float32, device=dev)
    part_counts = count = None
    if count_le is not None:
        part_counts = torch.empty((qn, splits), dtype=torch.int32, device=dev)
        count = torch.empty((qn,), dtype=torch.int32, device=dev)
    stats = None
    if care is None and count_le is None and obs.enabled():
        stats = obs.launch_buffer("cam_topk", dev)
    with obs.span("cam.topk"), torch.cuda.device(dev):
        err = _lib().cam_search_topk_launch(
            qp.data_ptr(), tp.data_ptr(), _ptr(cp), valid_rows.data_ptr(),
            _ptr(count_le), part_keys.data_ptr(), _ptr(part_counts),
            idx.data_ptr(), dist.data_ptr(), _ptr(count), _ptr(stats), qn, n,
            d, planes, groups, k, splits, rows_per_split, bq, bn,
            stream(dev))
    raise_on(err, "cam_search_topk")
    for name in counts:
        launches.add(name)
    if count_le is None:
        return idx, dist
    return idx, dist, count

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

Symbols are int8.  Unmasked, a position matches iff ``q == t`` and
``0 <= q < levels``; masked, it is a mismatch iff ``care != 0`` and
``0 <= q < levels`` and ``q != t`` — the one-hot rule of the TPU kernels
(:func:`~repro_torch.kernels.cam_search.ref.onehot_counts`).

The wrappers take CUDA tensors only and check device, dtype, shape,
contiguity and alignment; they allocate outputs and the packed scratch with
``torch.empty``, launch on the current stream and raise if a launch returns
a CUDA error.  Each counts its launches in :data:`launches`: a search call
adds one to ``cam_pack`` and one to its own kernel (although the fused
kernel runs as two passes).  The library is built and loaded at the first
launch, never at import.

While a profiler records (:mod:`repro_torch.obs`), the pack and the fused
launch run in the spans ``cam.pack`` and ``cam.topk``, and one unmasked,
uncounted fused search in ``obs.TRACE_EVERY`` runs the traced partial
pass, which adds its votes, inserts and cycles to the ``cam_topk``
counters; its outputs are the untraced pass's, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LaunchCounts, check, raise_on, stream
from repro_torch.kernels.cam_search.ref import plane_layout

#: Largest ``k`` :func:`cam_search_topk` takes.
MAX_K = 256

#: Table rows per tile of the kernels (``BN`` in the source).
_BN = 128

#: D must be a multiple of this (16-byte vector loads); the ops layer pads.
D_MULTIPLE = 16

#: Batches of at most this many queries take 16-query blocks, larger ones
#: 64-query blocks (the source's two ``BQ`` instantiations).  0 sends every
#: batch to 64-query blocks, which is how ``chip_smoke.py`` compares them.
SMALL_TILE_MAX_Q = 16

#: Wrapper calls that launched their kernel, by kernel name.
launches = LaunchCounts("cam_search", "cam_search_topk", "cam_pack")
reset_launches = launches.reset

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("cam_search")
    if not hasattr(lib, "_repro_bound"):
        lib.cam_pack_launch.argtypes = [_VP] * 6 + [_I] * 6 + [_VP]
        lib.cam_pack_launch.restype = _I
        lib.cam_search_launch.argtypes = [_VP] * 4 + [_I] * 6 + [_VP]
        lib.cam_search_launch.restype = _I
        lib.cam_search_topk_launch.argtypes = [_VP] * 11 + [_I] * 9 + [_VP]
        lib.cam_search_topk_launch.restype = _I
        lib._repro_bound = True
    return lib


def _check16(name, x, dtype, shape, device):
    check(name, x, dtype, shape, device, align=16)


def _check_inputs(queries, table, care):
    if not isinstance(queries, torch.Tensor) or queries.device.type != "cuda":
        raise ValueError("queries must be a CUDA tensor")
    if queries.dim() != 2 or table.dim() != 2:
        raise ValueError("queries and table must be 2-D")
    qn, d = queries.shape
    n = table.shape[0]
    dev = queries.device
    _check16("queries", queries, torch.int8, (qn, d), dev)
    _check16("table", table, torch.int8, (n, d), dev)
    if care is not None:
        _check16("care", care, torch.int8, (n, d), dev)
    if qn < 1 or n < 1:
        raise ValueError(f"need at least one query and one row, got Q={qn}, "
                         f"N={n}")
    if d % D_MULTIPLE:
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


def cam_search(queries: torch.Tensor, table: torch.Tensor, *, levels: int,
               care: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, D) x (N, D) int8 [+ (N, D) int8 care] -> (Q, N) int32 mismatches."""
    qn, n, d, dev = _check_inputs(queries, table, care)
    qp, tp, cp = pack(queries, table, levels=levels, care=care)
    planes, _, groups = plane_layout(d, levels)
    out = torch.empty((qn, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().cam_search_launch(
            qp.data_ptr(), tp.data_ptr(), _ptr(cp), out.data_ptr(), qn, n, d,
            planes, groups, _tile(qn), stream(dev))
    raise_on(err, "cam_search")
    launches.add("cam_search")
    return out


def _splits(q_tiles: int, n: int, dev: torch.device) -> tuple[int, int]:
    """(splits, rows per split): about four blocks per SM, whole tiles."""
    tiles = -(-n // _BN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(tiles, -(-4 * sms // q_tiles)))
    per = -(-tiles // splits)
    return -(-tiles // per), per * _BN


def cam_search_topk(queries: torch.Tensor, table: torch.Tensor,
                    valid_rows: torch.Tensor, *, levels: int, k: int,
                    care: torch.Tensor | None = None,
                    count_le: torch.Tensor | None = None):
    """Streaming top-k: ((Q, k) int32 rows, (Q, k) float32 distances).

    ``valid_rows`` is a (1,) int32 CUDA tensor that the kernel reads itself
    (no host sync); rows at index >= it get +inf.  ``count_le`` is an
    optional (Q, 1) float32 threshold; with it a third (Q,) int32 output
    counts the rows at distance <= threshold.  ``1 <= k <= min(N, 256)``.
    While a profiler records, one unmasked search without ``count_le`` in
    ``obs.TRACE_EVERY`` adds to :mod:`repro_torch.obs`'s ``cam_topk``
    counters.
    """
    qn, n, d, dev = _check_inputs(queries, table, care)
    _check16("valid_rows", valid_rows, torch.int32, (1,), dev)
    if count_le is not None:
        _check16("count_le", count_le, torch.float32, (qn, 1), dev)
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"k={k} outside [1, min(N={n}, {MAX_K})]")
    qp, tp, cp = pack(queries, table, levels=levels, care=care)
    planes, _, groups = plane_layout(d, levels)
    bq = _tile(qn)
    splits, rows_per_split = _splits(-(-qn // bq), n, dev)
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
            d, planes, groups, k, splits, rows_per_split, bq, stream(dev))
    raise_on(err, "cam_search_topk")
    launches.add("cam_search_topk")
    if count_le is None:
        return idx, dist
    return idx, dist, count

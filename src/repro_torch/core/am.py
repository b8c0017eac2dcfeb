"""Functional associative-search API — the SEE-MCAM primitive in PyTorch.

Port of the single-device part of :mod:`repro.core.am`.  An immutable
:class:`AMTable` of multi-bit codes, plus :func:`search`, which runs batched
top-k, threshold and multi-match lookups over it:

  >>> table = am.make_table(codes, bits=3, distance="l1")     # on the GPU
  >>> table = am.append(table, more_codes)             # returns a NEW table
  >>> res = am.search(table, queries, k=4, threshold=2, backend="cuda")
  >>> res.indices, res.distances, res.exact, res.matched   # all (Q, k)

``AMTable`` is a frozen dataclass of tensors that all live on one device;
:func:`make_table` puts them on the GPU unless told ``device="cpu"``.  The
functions here never update a table's tensors in place: each returns new
ones.

Backends
--------
Registered by name through :func:`register_backend`.  ``"ref"`` compares
symbols with plain tensor ops; ``"cuda"`` (alias ``"pallas"``, so call
sites ported from the reference keep their strings) runs the hand-written
kernels of :mod:`repro_torch.kernels.cam_search` on a GPU table and their
plain versions on a CPU table.  Each backend has a **dense** tier
``fn(queries, codes, bits, distance) -> (Q, N)`` distances; ``"cuda"`` also
has a **fused** tier that returns the top-k directly without the (Q, N)
matrix, and :func:`search` uses it for ``k <= FUSED_K_MAX``.  Both tiers
are bitwise-identical, ordered by ascending (distance, row index) with the
lowest row winning every tie, +inf masked rows included.  The **masked**
tier adds ternary care planes, and ``fused_count`` an in-kernel threshold
count for multi-match.  ``"analog"`` and ``"analog_cal"`` run the
behavioural FeFET circuit model (:func:`make_analog_backend`), dense tier
only.  The reference's sharded search comes with multi-bank sharding in a
later port slice.

Distance units: ``"hamming"`` counts differing symbols; ``"l1"`` is the
level distance ``sum_d |q_d - t_d|``, realised for digital backends by
thermometer expansion (:func:`thermometer`).  A distance is 0 iff the words
are equal, and integer-exact, so threshold semantics are bit-precise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import fefet, mibo
from repro_torch.device import resolve_device

#: Distances below this are exact word matches (half of one LSB mismatch).
EXACT_MATCH_EPS = 0.5

DISTANCES = ("hamming", "l1")


# ---------------------------------------------------------------------------
# AMTable — the immutable code store
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AMTable:
    """Immutable multi-bit code table.

    ``codes`` is (N, D) int32 symbols in [0, 2**bits); ``meta`` an optional
    per-row tensor whose leading axis aligns with rows; ``care`` an optional
    (N, D) int32 0/1 plane (0 = ternary don't-care cell, never a mismatch).
    All three live on one device.
    """

    codes: torch.Tensor
    meta: torch.Tensor | None = None
    care: torch.Tensor | None = None
    bits: int = 3
    distance: str = "hamming"

    @property
    def n_rows(self) -> int:
        """Stored row (word) count N."""
        return self.codes.shape[0]

    @property
    def width(self) -> int:
        """Word width D in multi-bit symbols."""
        return self.codes.shape[1]

    @property
    def device(self) -> torch.device:
        """The device every plane of the table lives on."""
        return self.codes.device


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; 64-bit types narrow to 32 bits.

    The reference runs with 64-bit types off, so its arrays are int32 and
    float32; tables built here keep those types.  Host arrays are copied,
    so a table never shares memory with its caller's array.
    """
    t = (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.array(x))).to(device)
    if dtype is None:
        dtype = {torch.int64: torch.int32,
                 torch.float64: torch.float32}.get(t.dtype, t.dtype)
    return t.to(dtype)


def _check_care(care_mask, codes: torch.Tensor) -> torch.Tensor | None:
    """Normalise a care plane to (N, D) int32 0/1 aligned with ``codes``."""
    if care_mask is None:
        return None
    care = _tensor(care_mask, codes.device)
    if care.shape != codes.shape:
        raise ValueError(f"care_mask shape {tuple(care.shape)} != codes "
                         f"shape {tuple(codes.shape)}")
    return (care != 0).to(torch.int32)


def make_table(codes, *, bits: int = 3, distance: str = "hamming",
               meta=None, care_mask=None, device=None) -> AMTable:
    """Build an :class:`AMTable` from (N, D) integer symbol codes.

    Args:
      codes: (N, D) integer symbols in [0, 2**bits).
      bits: bits per stored symbol.
      distance: ``"hamming"`` or ``"l1"``.
      meta: optional per-row array whose leading axis aligns with rows.
      care_mask: optional (N, D) ternary care plane — nonzero marks a cared
        position, 0 a don't-care cell.  An all-nonzero mask is
        bitwise-identical to no mask.
      device: where the table lives; ``None`` means the GPU, and raises
        when there is none.

    Returns:
      A new immutable :class:`AMTable`.
    """
    if distance not in DISTANCES:
        raise ValueError(f"unknown distance {distance!r}; expected {DISTANCES}")
    dev = resolve_device(device)
    codes = _tensor(codes, dev, torch.int32)
    if codes.dim() != 2:
        raise ValueError(f"codes must be (N, D), got {tuple(codes.shape)}")
    if meta is not None:
        meta = _tensor(meta, dev)
        if meta.shape[:1] != codes.shape[:1]:
            raise ValueError(f"meta leading axis {tuple(meta.shape[:1])} != "
                             f"rows {tuple(codes.shape[:1])}")
    return AMTable(codes=codes, meta=meta, care=_check_care(care_mask, codes),
                   bits=bits, distance=distance)


def write(table: AMTable, codes, meta=None, care_mask=None) -> AMTable:
    """Replace the stored codes, returning a new table on the same device."""
    return make_table(codes, bits=table.bits, distance=table.distance,
                      meta=meta, care_mask=care_mask, device=table.device)


def append(table: AMTable, codes, meta=None, care_mask=None) -> AMTable:
    """Append (M, D) rows, returning a new table.

    ``meta`` and ``care_mask`` presence must each match the table's.
    """
    dev = table.device
    codes = _tensor(codes, dev, torch.int32)
    if codes.dim() == 1:
        codes = codes[None]
    if codes.shape[-1] != table.width:
        raise ValueError(
            f"appended width {codes.shape[-1]} != table width {table.width}")
    new_codes = torch.cat([table.codes, codes], dim=0)
    if (table.meta is None) != (meta is None):
        raise ValueError("append meta presence must match the table's")
    if (table.care is None) != (care_mask is None):
        raise ValueError("append care_mask presence must match the table's")
    new_meta = None
    if meta is not None:
        meta = torch.atleast_1d(_tensor(meta, dev))
        if meta.shape[:1] != codes.shape[:1]:
            raise ValueError(
                f"meta leading axis {tuple(meta.shape[:1])} != appended rows "
                f"{tuple(codes.shape[:1])}")
        new_meta = torch.cat([table.meta, meta.to(table.meta.dtype)], dim=0)
    new_care = None
    if care_mask is not None:
        care = _tensor(care_mask, dev)
        if care.dim() == 1:
            care = care[None]
        new_care = torch.cat([table.care, _check_care(care, codes)], dim=0)
    return AMTable(codes=new_codes, meta=new_meta, care=new_care,
                   bits=table.bits, distance=table.distance)


def delete(table: AMTable, rows) -> AMTable:
    """Drop rows by index array or boolean eviction mask; returns a new table.

    ``rows`` is an integer index array or an (N,) boolean mask where
    ``True`` marks rows to remove.  Host-side table maintenance.
    """
    rows = np.asarray(rows)
    keep = np.ones((table.n_rows,), bool)
    if rows.dtype == np.bool_:
        if rows.shape != (table.n_rows,):
            raise ValueError(
                f"boolean delete mask shape {rows.shape} != rows "
                f"({table.n_rows},)")
        keep &= ~rows
    else:
        # a negative index would wrap onto the wrong row — reject by name
        idx = rows.reshape(-1).astype(np.int64)
        bad = idx[(idx < 0) | (idx >= table.n_rows)]
        if bad.size:
            raise ValueError(
                f"delete indices out of range [0, {table.n_rows}): "
                f"{sorted(set(bad.tolist()))}")
        keep[idx] = False
    keep = torch.from_numpy(keep).to(table.device)
    return AMTable(codes=table.codes[keep],
                   meta=None if table.meta is None else table.meta[keep],
                   care=None if table.care is None else table.care[keep],
                   bits=table.bits, distance=table.distance)


# ---------------------------------------------------------------------------
# Serving meta: per-row timestamps for eviction policies
# ---------------------------------------------------------------------------
#
# ``repro_torch.serve.am_service`` stores tables whose ``meta`` is an (N, 2)
# float32 tensor of timestamps: column META_INSERT is the insert time,
# column META_LAST_HIT the last exact-hit time.

#: ``meta[:, META_INSERT]`` — when the row was appended.
META_INSERT = 0
#: ``meta[:, META_LAST_HIT]`` — when the row last matched exactly.
META_LAST_HIT = 1


def serving_meta(n: int, now, device=None) -> torch.Tensor:
    """(n, 2) float32 timestamp meta for freshly inserted rows, both ``now``."""
    return torch.full((n, 2), float(now), dtype=torch.float32,
                      device=resolve_device(device))


def touch(table: AMTable, rows, now) -> AMTable:
    """Set the last-hit timestamp of ``rows`` to ``now``; returns a new table.

    Out-of-range indices are dropped, so callers can pass ``table.n_rows``
    as a "no row" sentinel for queries that missed.  No host sync: the
    sentinel rows land on a scratch row past the end.
    """
    if table.meta is None:
        raise ValueError("touch() needs a table with (N, 2) timestamp meta — "
                         "build it with meta=serving_meta(n, now)")
    n = table.n_rows
    rows = torch.as_tensor(rows, device=table.device).reshape(-1).long()
    rows = torch.where(rows < 0, rows + n, rows)
    rows = torch.where((rows >= 0) & (rows < n), rows, n)
    meta = torch.cat([table.meta, table.meta.new_zeros((1, 2))], dim=0)
    meta[:, META_LAST_HIT].index_fill_(0, rows, float(now))
    return dataclasses.replace(table, meta=meta[:n])


# ---------------------------------------------------------------------------
# Backend registry — capability tiers (dense / fused / masked)
# ---------------------------------------------------------------------------

BackendFn = Callable[[torch.Tensor, torch.Tensor, int, str], torch.Tensor]
#: fused tier: fn(queries, codes, bits, distance, *, k, valid_rows)
#: -> ((Q, k) int32 row indices, (Q, k) float32 distances), best-first.
FusedBackendFn = Callable[..., tuple]

#: Largest ``k`` routed to a backend's fused tier; above it the dense tier
#: and a stable sort run instead (bitwise-identical, but O(Q*N) traffic),
#: and :func:`fused_fallbacks` counts the crossing.
FUSED_K_MAX = 256

_fused_fallback_count = 0


def _note_fused_fallback() -> None:
    global _fused_fallback_count
    _fused_fallback_count += 1


def fused_fallbacks() -> int:
    """How often a fused-capable backend fell back to the dense tier.

    Counts calls of :func:`search` where the backend has a fused tier but
    ``k`` (or ``matches``) exceeds :data:`FUSED_K_MAX`.  PyTorch runs
    eagerly, so this ticks once per such call.
    """
    return _fused_fallback_count


def reset_fused_fallbacks() -> None:
    """Zero the :func:`fused_fallbacks` counter (test/bench isolation)."""
    global _fused_fallback_count
    _fused_fallback_count = 0


@dataclasses.dataclass(frozen=True)
class _Backend:
    """Registry entry: the mandatory dense tier + optional fused tier."""

    dense: BackendFn
    fused: FusedBackendFn | None = None
    masked: bool = False
    fused_count: bool = False

    @property
    def capabilities(self) -> tuple[str, ...]:
        """Tier names this backend implements, dense always first."""
        caps = ["dense"]
        if self.fused is not None:
            caps.append("fused")
        if self.masked:
            caps.append("masked")
        return tuple(caps)


_BACKENDS: dict[str, _Backend] = {}
DEFAULT_BACKEND = "ref"

#: Names accepted for a registered backend; ``"pallas"`` keeps call sites
#: ported from the reference working on the CUDA kernels.
_ALIASES = {"pallas": "cuda"}


def register_backend(name: str, fn: BackendFn, *,
                     fused: FusedBackendFn | None = None,
                     masked: bool = False,
                     fused_count: bool = False) -> None:
    """Register (or replace) a search backend under ``name``.

    Args:
      name: registry key callers pass as ``backend=``.
      fn: the dense tier — ``fn(queries, codes, bits, distance)`` returning
        the (Q, N) distance matrix.
      fused: optionally the fused tier — a direct top-k
        ``fn(queries, codes, bits, distance, k=, valid_rows=)``,
        bitwise-identical to dense + stable sort.
      masked: every tier function accepts ``care=``.
      fused_count: the fused tier accepts ``count_le=`` and returns
        ``(rows, distances, counts)``.
    """
    _BACKENDS[name] = _Backend(dense=fn, fused=fused, masked=masked,
                               fused_count=fused_count)


def get_backend(name: str) -> BackendFn:
    """The dense-tier function registered under ``name``."""
    return _get_entry(name).dense


def _get_entry(name: str) -> _Backend:
    try:
        return _BACKENDS[_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {backend_names()}"
        ) from None


def backend_names() -> tuple[str, ...]:
    """Names of every registered backend, registration order."""
    return tuple(_BACKENDS)


def backend_capabilities(name: str) -> tuple[str, ...]:
    """Capability tiers of the backend registered under ``name``.

    Always starts with ``"dense"``; ``"fused"`` when a fused top-k tier is
    registered as well, ``"masked"`` when the backend accepts care planes.
    """
    return _get_entry(name).capabilities


def _resolve_backend(backend: str | BackendFn | None) -> _Backend:
    if backend is None:
        return _BACKENDS[DEFAULT_BACKEND]
    if callable(backend):
        return _Backend(dense=backend)     # raw callables are dense-tier
    return _get_entry(backend)


def thermometer(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., D) levels in [0, 2^b) -> (..., D*(2^b-1)) binary thermometer.

    ``|a - b| = Hamming(therm(a), therm(b))``.
    """
    m = 1 << bits
    rungs = torch.arange(1, m, device=codes.device)
    out = (codes[..., None] >= rungs).to(torch.int32)
    return out.reshape(*codes.shape[:-1], codes.shape[-1] * (m - 1))


def _expand_l1(queries, codes, bits, distance):
    """Apply the thermometer trick for digital backends in L1 mode."""
    if distance == "l1" and bits > 1:
        return thermometer(queries, bits), thermometer(codes, bits), 1
    return queries, codes, bits


def _expand_care_l1(care, bits, distance):
    """Widen a care plane to match :func:`_expand_l1`'s thermometer codes."""
    if care is not None and distance == "l1" and bits > 1:
        return torch.repeat_interleave(care, (1 << bits) - 1, dim=-1)
    return care


def _ref_backend(queries, codes, bits, distance, care=None):
    from repro_torch.kernels.cam_search import ref as cam_ref
    care = _expand_care_l1(care, bits, distance)
    queries, codes, bits = _expand_l1(queries, codes, bits, distance)
    return cam_ref.mismatch_counts(queries, codes, care)


def _cuda_backend(queries, codes, bits, distance, care=None):
    from repro_torch.kernels.cam_search import ops as cam_ops
    care = _expand_care_l1(care, bits, distance)
    queries, codes, bits = _expand_l1(queries, codes, bits, distance)
    return cam_ops.mismatch_counts(queries, codes, bits, care=care)


def _cuda_fused_backend(queries, codes, bits, distance, *, k, valid_rows,
                        care=None, count_le=None):
    # The L1 thermometer expansion widens D, never the row axis, so the
    # in-kernel valid_rows mask applies unchanged.
    from repro_torch.kernels.cam_search import ops as cam_ops
    care = _expand_care_l1(care, bits, distance)
    queries, codes, bits = _expand_l1(queries, codes, bits, distance)
    return cam_ops.topk_fused(queries, codes, k=k, bits=bits,
                              valid_rows=valid_rows, care=care,
                              count_le=count_le)


def make_analog_backend(generator: torch.Generator | None = None,
                        params: fefet.FeFETParams = fefet.DEFAULT,
                        calibrated: bool = False) -> BackendFn:
    """Build an analog (device-model) backend, optionally with V_TH variation.

    ``"hamming"`` counts cells whose MIBO node D charged; ``"l1"`` reports the
    graded matchline discharge current in LSB-mismatch units
    (:func:`repro_torch.core.mibo.lsb_mismatch_current`), the paper's analog
    nearest-match ranking.  The registered ``"analog"`` backend is this with
    no variation; register a generator-driven instance for robustness
    studies::

        am.register_backend("analog_mc", am.make_analog_backend(gen))

    The generator's state is captured here, and every call draws the two
    (rows, cells) noise planes from a copy of it, so one backend instance
    always sees the same variation realisation for the same table shape —
    a fixed programmed array, as the reference's keyed backend is.  The
    generator must live on the device of the tables it searches.

    With ``calibrated=True`` the ``"l1"`` readout is inverted through the
    affine overdrive-response fit
    (:func:`repro_torch.core.mibo.overdrive_response_fit`): a matchline
    discharge ``i_ml ~= a * mismatches + b * L1`` maps back to the
    digital-equivalent level distance ``(i_ml - a * mismatches) / b``, so
    analog thresholds compare directly with digital ones (the registered
    ``"analog_cal"`` backend).

    Returns:
      A dense-tier :data:`BackendFn`.
    """
    state = None if generator is None else generator.get_state()

    def _backend(queries, codes, bits, distance):
        from repro_torch.core import cam_array
        noise1 = noise2 = None
        if state is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
            noise1 = fefet.sample_vth_variation(gen, tuple(codes.shape),
                                                params, device=codes.device)
            noise2 = fefet.sample_vth_variation(gen, tuple(codes.shape),
                                                params, device=codes.device)
        mismatch, i_ml = cam_array.analog_search_batch(
            codes, queries, bits, noise1, noise2, params)
        if distance == "hamming":
            return mismatch
        if calibrated:
            a, b = mibo.overdrive_response_fit(bits, params)
            return (i_ml - a * mismatch) / b
        return i_ml / mibo.lsb_mismatch_current(bits, params,
                                                device=codes.device)

    return _backend


register_backend("ref", _ref_backend, masked=True)
register_backend("cuda", _cuda_backend, fused=_cuda_fused_backend,
                 masked=True, fused_count=True)
register_backend("analog", make_analog_backend())
register_backend("analog_cal", make_analog_backend(calibrated=True))


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AMSearchResult:
    """Top-k outcome of one batched associative search.

    All fields are (Q, k) — or (k,) when a single 1-D query was given —
    ordered best-first (ascending distance, ties to the lowest row index).
    """

    indices: torch.Tensor     # int32 row indices of the k nearest rows
    distances: torch.Tensor   # float32 distances (binary cell mismatches)
    exact: torch.Tensor       # bool — distance below EXACT_MATCH_EPS
    matched: torch.Tensor     # bool — within `threshold` (== exact if None)

    @property
    def best_row(self) -> torch.Tensor:
        """(Q,) index of the single nearest row."""
        return self.indices[..., 0]

    @property
    def best_distance(self) -> torch.Tensor:
        """(Q,) distance of the single nearest row."""
        return self.distances[..., 0]


def _finalize(indices, distances, threshold, squeeze) -> AMSearchResult:
    exact = distances < EXACT_MATCH_EPS
    matched = exact if threshold is None else distances <= threshold
    if squeeze:
        indices, distances = indices[0], distances[0]
        exact, matched = exact[0], matched[0]
    return AMSearchResult(indices=indices, distances=distances, exact=exact,
                          matched=matched)


#: Effective multi-match threshold when ``threshold=None``: the largest f32
#: strictly below :data:`EXACT_MATCH_EPS`, so ``distance <= threshold``
#: means exact matches only.
_EXACT_THR = float(np.nextafter(np.float32(EXACT_MATCH_EPS), np.float32(0)))

#: Row-index sentinel for candidate-list padding; sorts after every real
#: row index (and after +inf-masked real rows at equal distance).
_IDX_SENTINEL = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class AMMultiMatchResult:
    """Fixed-width multi-match outcome (the TCAM answer shape).

    *All* rows at distance <= threshold, in a window of ``M`` slots ordered
    by ascending (distance, row index) — slot 0 is the priority entry.
    Non-match slots hold index ``-1`` / distance ``+inf`` / flags False.
    ``match_count`` is exact, also beyond ``M`` (then ``overflow`` is set).
    Shapes are (Q, M) and (Q,); a single 1-D query drops the leading axis.
    """

    indices: torch.Tensor      # int32 matching rows, priority-first; -1 empty
    distances: torch.Tensor    # float32 distances; +inf on empty slots
    exact: torch.Tensor        # bool — slot is an exact match (< EPS)
    matched: torch.Tensor      # bool — slot holds a within-threshold match
    match_count: torch.Tensor  # int32 — exact #rows within threshold
    overflow: torch.Tensor     # bool — match_count > M (window truncated)

    @property
    def single_match(self) -> torch.Tensor:
        """(Q,) bool — exactly one row matched."""
        return self.match_count == 1

    @property
    def multiple_match(self) -> torch.Tensor:
        """(Q,) bool — more than one row matched."""
        return self.match_count > 1

    @property
    def priority_index(self) -> torch.Tensor:
        """(Q,) the winning row — lowest (distance, index); -1 if no match."""
        return self.indices[..., 0]

    @property
    def priority_distance(self) -> torch.Tensor:
        """(Q,) distance of the priority entry (+inf if no match)."""
        return self.distances[..., 0]


def _match_threshold(threshold, qn: int, device) -> torch.Tensor:
    """Normalise a multi-match threshold to a (Q, 1) float32 tensor.

    A scalar becomes a device fill, not a host-to-device copy, so a GPU
    search never waits on the host here.
    """
    if threshold is None or isinstance(threshold, (int, float)):
        thr = _EXACT_THR if threshold is None else threshold
        return torch.full((qn, 1), thr, dtype=torch.float32, device=device)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=device)
    t = t.reshape(1, 1) if t.dim() == 0 else t.reshape(-1, 1)
    return t.expand(qn, 1)


def _finalize_matches(indices, distances, count, thr_q, matches: int,
                      squeeze: bool) -> AMMultiMatchResult:
    """Blank non-match slots and assemble an :class:`AMMultiMatchResult`."""
    matched = distances <= thr_q
    exact = matched & (distances < EXACT_MATCH_EPS)
    indices = torch.where(matched, indices, -1)
    distances = torch.where(matched, distances, torch.inf)
    count = count.to(torch.int32)
    overflow = count > matches
    if squeeze:
        indices, distances = indices[0], distances[0]
        exact, matched = exact[0], matched[0]
        count, overflow = count[0], overflow[0]
    return AMMultiMatchResult(indices=indices, distances=distances,
                              exact=exact, matched=matched,
                              match_count=count, overflow=overflow)


def _pad_candidates(dist: torch.Tensor, idx: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a (Q, k_local) candidate list out to (Q, k) with +inf sentinels."""
    q, k_local = dist.shape
    if k_local >= k:
        return dist, idx
    pad = k - k_local
    return (torch.cat([dist, dist.new_full((q, pad), torch.inf)], dim=1),
            torch.cat([idx, idx.new_full((q, pad), _IDX_SENTINEL)], dim=1))


def _care_kwargs(table: AMTable, be: _Backend) -> dict:
    """The ``care=`` kwarg for a masked table — or {} (and a clear error)."""
    if table.care is None:
        return {}
    if not be.masked:
        raise ValueError(
            "table has a care mask but the backend lacks the 'masked' "
            f"capability tier (has {be.capabilities}); use a masked backend "
            "such as 'ref' or 'cuda'")
    return {"care": table.care}


def _prep_queries(table: AMTable, queries) -> tuple[torch.Tensor, bool]:
    if table.n_rows == 0:
        raise ValueError(
            "cannot search an empty AMTable (0 rows) — append codes first")
    queries = _tensor(queries, table.device, torch.int32)
    squeeze = queries.dim() == 1
    if squeeze:
        queries = queries[None]
    if queries.dim() != 2:
        raise ValueError(
            f"queries must be (Q, D) or a single (D,) word, got a "
            f"{queries.dim()}-D array of shape {tuple(queries.shape)} — "
            f"flatten leading batch axes before searching")
    if queries.shape[-1] != table.width:
        raise ValueError(
            f"query width {queries.shape[-1]} != stored width {table.width}")
    return queries, squeeze


def _mask_rows(d: torch.Tensor, valid_rows) -> torch.Tensor:
    if valid_rows is None:
        return d
    rows = torch.arange(d.shape[1], device=d.device)
    return torch.where(rows[None, :] < valid_rows, d, torch.inf)


def _sorted_topk(d: torch.Tensor, k: int):
    """The k smallest per row, ties to the lowest index (a stable sort)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :k].to(torch.int32), vals[:, :k]


def distances(table: AMTable, queries, *,
              backend: str | BackendFn | None = None) -> torch.Tensor:
    """Full (Q, N) distance matrix (backend-native dtype, contract units).

    Always the dense tier.  Tables with a care mask route it through.
    """
    queries, squeeze = _prep_queries(table, queries)
    be = _resolve_backend(backend)
    d = be.dense(queries, table.codes, table.bits, table.distance,
                 **_care_kwargs(table, be))
    return d[0] if squeeze else d


def search(table: AMTable, queries, *, k: int = 1, threshold=None,
           backend: str | BackendFn | None = None, valid_rows=None,
           matches: int | None = None):
    """Batched top-k / threshold / multi-match associative search.

    Args:
      table: the code store.  A table with a ``care`` plane needs a backend
        with the ``"masked"`` capability.
      queries: (Q, D) — or a single (D,) — integer symbol words.
      k: how many nearest rows to return (clamped to the table size).
      threshold: optional match radius in contract units (float or a
        tensor broadcasting against (Q, k)); ``result.matched`` flags
        candidates with ``distance <= threshold``.  ``None`` means
        exact-match-only flags.
      backend: registered backend name, a raw dense-tier callable, or
        ``None`` for ``"ref"``.
      valid_rows: optional count of live rows (int or tensor) — rows at
        index >= ``valid_rows`` get distance ``+inf`` and can never rank.
      matches: switch to **multi-match** mode with window width M: all rows
        at distance <= ``threshold`` (exact matches when None) as an
        :class:`AMMultiMatchResult`.  Mutually exclusive with ``k``.

    Returns:
      :class:`AMSearchResult` with rows ordered best-first — or, with
      ``matches=``, an :class:`AMMultiMatchResult`.

    Dispatch: a backend with a fused tier runs it for ``k <=
    FUSED_K_MAX`` (multi-match also needs ``fused_count``); otherwise the
    dense matrix and a stable sort run.  The two are bitwise-identical.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if matches is not None:
        if k != 1:
            raise ValueError(
                f"pass either k= or matches=, not both (k={k}, "
                f"matches={matches})")
        if matches < 1:
            raise ValueError(f"matches must be >= 1, got {matches}")
    queries, squeeze = _prep_queries(table, queries)
    be = _resolve_backend(backend)
    ckw = _care_kwargs(table, be)

    if matches is not None:
        m_eff = min(matches, table.n_rows)
        thr_q = _match_threshold(threshold, queries.shape[0], table.device)
        if (be.fused is not None and be.fused_count
                and 1 <= m_eff <= FUSED_K_MAX):
            idx, dist, count = be.fused(
                queries, table.codes, table.bits, table.distance, k=m_eff,
                valid_rows=valid_rows, count_le=thr_q, **ckw)
        else:
            if be.fused is not None and be.fused_count \
                    and m_eff > FUSED_K_MAX:
                _note_fused_fallback()
            d = be.dense(queries, table.codes, table.bits, table.distance,
                         **ckw).to(torch.float32)
            d = _mask_rows(d, valid_rows)
            count = (d <= thr_q).sum(dim=1, dtype=torch.int32)
            idx, dist = _sorted_topk(d, m_eff)
        dist, idx = _pad_candidates(dist, idx, matches)
        return _finalize_matches(idx, dist, count, thr_q, matches, squeeze)

    k = min(k, table.n_rows)
    if be.fused is not None and 1 <= k <= FUSED_K_MAX:
        idx, dist = be.fused(queries, table.codes, table.bits, table.distance,
                             k=k, valid_rows=valid_rows, **ckw)
        return _finalize(idx, dist, threshold, squeeze)
    if be.fused is not None and k > FUSED_K_MAX:
        _note_fused_fallback()
    d = be.dense(queries, table.codes, table.bits, table.distance, **ckw)
    d = _mask_rows(d.to(torch.float32), valid_rows)
    idx, dist = _sorted_topk(d, k)
    return _finalize(idx, dist, threshold, squeeze)

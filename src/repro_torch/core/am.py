"""Functional associative-search API — the SEE-MCAM primitive in PyTorch.

Port of :mod:`repro.core.am`.  An immutable
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
only.

Multi-bank search
-----------------
:func:`search_sharded` banks the rows over the ``model`` axis of a mesh
(:mod:`repro_torch.dist`), runs the backend per bank on that bank's rows,
and reduces the per-bank candidates by the all-gather, tree or ring merge
(:data:`MERGE_STRATEGIES`), bitwise the single-device :func:`search`.

Distance units: ``"hamming"`` counts differing symbols; ``"l1"`` is the
level distance ``sum_d |q_d - t_d|``, realised for digital backends by
thermometer expansion (:func:`thermometer`; on a CUDA table the ``"cuda"``
kernels pack the expansion's bit-planes from the codes in one launch, which
takes codes as int8, as every symbol on the card: they agree with the
expansion for codes in ``[-128, 128)``).  A distance is 0 iff the words are
equal, and integer-exact, so threshold semantics are bit-precise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
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
    """Apply the thermometer trick for digital backends in L1 mode (in the
    span ``cam.expand.l1`` while a profiler records)."""
    if distance == "l1" and bits > 1:
        with obs.span("cam.expand.l1"):
            return thermometer(queries, bits), thermometer(codes, bits), 1
    return queries, codes, bits


def _expand_care_l1(care, bits, distance):
    """Widen a care plane to match :func:`_expand_l1`'s thermometer codes."""
    if care is not None and distance == "l1" and bits > 1:
        return torch.repeat_interleave(care, (1 << bits) - 1, dim=-1)
    return care


def _l1_on_card(codes, bits, distance) -> bool:
    """An L1 search of multi-bit codes in a CUDA table: the kernels' L1
    pack makes the thermometer planes from the codes themselves, in one
    launch (in the span ``cam.expand.l1``), in place of :func:`_expand_l1`
    and :func:`_expand_care_l1`."""
    from repro_torch.kernels.cam_search import kernel as cam_kernel
    return (distance == "l1" and 1 < bits <= cam_kernel.L1_MAX_BITS
            and codes.device.type == "cuda")


def _ref_backend(queries, codes, bits, distance, care=None):
    from repro_torch.kernels.cam_search import ref as cam_ref
    care = _expand_care_l1(care, bits, distance)
    queries, codes, bits = _expand_l1(queries, codes, bits, distance)
    return cam_ref.mismatch_counts(queries, codes, care)


def _cuda_backend(queries, codes, bits, distance, care=None):
    from repro_torch.kernels.cam_search import ops as cam_ops
    l1 = _l1_on_card(codes, bits, distance)
    if not l1:
        care = _expand_care_l1(care, bits, distance)
        queries, codes, bits = _expand_l1(queries, codes, bits, distance)
    return cam_ops.mismatch_counts(queries, codes, bits, care=care, l1=l1)


def _cuda_fused_backend(queries, codes, bits, distance, *, k, valid_rows,
                        care=None, count_le=None):
    # The L1 thermometer expansion widens D, never the row axis, so the
    # in-kernel valid_rows mask applies unchanged.
    from repro_torch.kernels.cam_search import ops as cam_ops
    l1 = _l1_on_card(codes, bits, distance)
    if not l1:
        care = _expand_care_l1(care, bits, distance)
        queries, codes, bits = _expand_l1(queries, codes, bits, distance)
    return cam_ops.topk_fused(queries, codes, k=k, bits=bits,
                              valid_rows=valid_rows, care=care,
                              count_le=count_le, l1=l1)


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
    """Pad a (..., k_local) candidate list out to (..., k) with +inf sentinels.

    A fixed-width list where a bank or a set has fewer than k live
    candidates: (+inf, ``_IDX_SENTINEL``) ranks after every genuine
    candidate, +inf-masked real rows included.
    """
    k_local = dist.shape[-1]
    if k_local >= k:
        return dist, idx
    shape = (*dist.shape[:-1], k - k_local)
    return (torch.cat([dist, dist.new_full(shape, torch.inf)], dim=-1),
            torch.cat([idx, idx.new_full(shape, _IDX_SENTINEL)], dim=-1))


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
    with obs.span("am.search.prep"):
        if table.n_rows == 0:
            raise ValueError("cannot search an empty AMTable (0 rows) — "
                             "append codes first")
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
            raise ValueError(f"query width {queries.shape[-1]} != stored "
                             f"width {table.width}")
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

    While a profiler records, the call runs in the span ``am.search`` and
    its query preparation in ``am.search.prep`` (:mod:`repro_torch.obs`).
    """
    with obs.span("am.search"):
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
            idx, dist = be.fused(queries, table.codes, table.bits,
                                 table.distance, k=k, valid_rows=valid_rows,
                                 **ckw)
            return _finalize(idx, dist, threshold, squeeze)
        if be.fused is not None and k > FUSED_K_MAX:
            _note_fused_fallback()
        d = be.dense(queries, table.codes, table.bits, table.distance, **ckw)
        d = _mask_rows(d.to(torch.float32), valid_rows)
        idx, dist = _sorted_topk(d, k)
        return _finalize(idx, dist, threshold, squeeze)


# ---------------------------------------------------------------------------
# Sharded multi-bank search
# ---------------------------------------------------------------------------

#: Cross-bank merge strategies ``search_sharded`` accepts.
MERGE_STRATEGIES = ("auto", "allgather", "tree", "ring")

#: ``merge="auto"`` picks a collective merge (tree or ring) at and above
#: this bank-axis width; below it the all-gather's single round wins.
#: ``docs/ARCHITECTURE.md``'s decision table names the same value.
TREE_MERGE_MIN_BANKS = 16

#: ``merge="auto"`` upgrades tree -> ring when ``k >= this * n_banks``: the
#: ring's O(Q * k) traffic, independent of the bank count, pays for its
#: 2 * (banks - 1) rounds only when k >> banks.
RING_MERGE_MIN_K_PER_BANK = 4


def resolve_merge(merge: str, n_banks: int, k: int = 1) -> str:
    """Resolve a ``merge=`` argument to ``"allgather"``, ``"tree"`` or
    ``"ring"``: ``"auto"`` is the all-gather below
    :data:`TREE_MERGE_MIN_BANKS` banks, then the ring when ``k >=``
    :data:`RING_MERGE_MIN_K_PER_BANK` ``* n_banks``, else the tree."""
    if merge not in MERGE_STRATEGIES:
        raise ValueError(
            f"unknown merge {merge!r}; expected one of {MERGE_STRATEGIES}")
    if merge != "auto":
        return merge
    if n_banks < TREE_MERGE_MIN_BANKS:
        return "allgather"
    return "ring" if k >= RING_MERGE_MIN_K_PER_BANK * n_banks else "tree"


def _lex_sort(dist: torch.Tensor, idx: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending (distance, row) along the last dimension.

    Two stable sorts, by row and then by distance, give the order of the
    reference's two-key ``lax.sort((dist, idx), num_keys=2)``.
    """
    by_idx = torch.sort(idx, dim=-1, stable=True)
    dist = dist.gather(-1, by_idx.indices)
    dist, by_dist = torch.sort(dist, dim=-1, stable=True)
    return dist, by_idx.values.gather(-1, by_dist)


def _lex_merge_topk(dist_a: torch.Tensor, idx_a: torch.Tensor,
                    dist_b: torch.Tensor, idx_b: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate lists, keeping the first k by (distance, row).

    The same row arriving from both lists (a tree over a bank count that is
    not a power of two wraps its coverage) is masked to (+inf,
    ``_IDX_SENTINEL``) before the cut, so no row takes two of the k slots.
    """
    dist, idx = _lex_sort(torch.cat([dist_a, dist_b], dim=-1),
                          torch.cat([idx_a, idx_b], dim=-1))
    dup = torch.zeros_like(idx, dtype=torch.bool)
    dup[..., 1:] = idx[..., 1:] == idx[..., :-1]
    dist, idx = _lex_sort(torch.where(dup, torch.inf, dist),
                          torch.where(dup, _IDX_SENTINEL, idx))
    return dist[..., :k], idx[..., :k]


def _merge_bank_candidates(dist_local: torch.Tensor, idx_local: torch.Tensor,
                           *, mesh, axis: str, n_banks: int, k: int,
                           strategy: str
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce per-bank (Q, k_local) candidates to the global top-k.

    Both inputs are bank-stacked (:mod:`repro_torch.dist.mesh`): a leading
    dimension over the banks this process holds, each slice that bank's
    list, ordered by (distance, global row) with +inf for masked rows.
    ``strategy`` is ``"allgather"``, ``"tree"`` or ``"ring"`` (resolve
    ``"auto"`` first).  Returns ``(indices, distances)``, bank-stacked,
    every slice the same (Q, k) global top-k by (distance, global row).
    """
    if strategy == "ring":
        # Reduce-scatter over query chunks: in round r bank p passes on the
        # chunk it merged last round and folds its own candidates into the
        # chunk arriving from bank p-1.  After banks-1 rounds bank p holds
        # chunk (p+1) % banks merged over every bank exactly once, and one
        # all-gather of the chunks rebuilds the (Q, k) result.
        dist_c, idx_c = _pad_candidates(dist_local, idx_local, k)
        b, q, w = dist_c.shape
        chunk = -(-q // n_banks)
        pad_q = chunk * n_banks - q
        if pad_q:
            dist_c = torch.cat(
                [dist_c, dist_c.new_full((b, pad_q, w), torch.inf)], dim=1)
            idx_c = torch.cat(
                [idx_c, idx_c.new_full((b, pad_q, w), _IDX_SENTINEL)], dim=1)
        dist_v = dist_c.reshape(b, n_banks, chunk, w)
        idx_v = idx_c.reshape(b, n_banks, chunk, w)
        held = torch.arange(b, device=dist_c.device)
        p = mesh.axis_index(axis, device=dist_c.device)

        def _local_chunk(c):
            return dist_v[held, c], idx_v[held, c]

        perm = [(i, (i + 1) % n_banks) for i in range(n_banks)]
        acc_d, acc_i = _local_chunk(p)
        for r in range(n_banks - 1):
            acc_d = mesh.ppermute(acc_d, axis, perm)
            acc_i = mesh.ppermute(acc_i, axis, perm)
            ld, li = _local_chunk((p - r - 1) % n_banks)
            acc_d, acc_i = _lex_merge_topk(acc_d, acc_i, ld, li, k)
        # bank p finished chunk (p+1) % banks: gathered[j] is chunk j+1,
        # so rolling by one restores query order before the un-pad
        gd = torch.roll(mesh.all_gather(acc_d, axis), 1, dims=1)
        gi = torch.roll(mesh.all_gather(acc_i, axis), 1, dims=1)
        return (gi.reshape(1, chunk * n_banks, -1)[:, :q],
                gd.reshape(1, chunk * n_banks, -1)[:, :q])

    if strategy == "tree":
        # Recursive doubling: round r folds in the running top-k of the
        # bank 2**r places down-ring; after ceil(log2(banks)) rounds every
        # bank has seen every bank (overlap on non-power-of-two widths is
        # removed by the merge's dedup)
        dist_c, idx_c = _pad_candidates(dist_local, idx_local, k)
        for r in range((n_banks - 1).bit_length()):
            shift = 1 << r
            perm = [(i, (i + shift) % n_banks) for i in range(n_banks)]
            dist_p = mesh.ppermute(dist_c, axis, perm)
            idx_p = mesh.ppermute(idx_c, axis, perm)
            dist_c, idx_c = _lex_merge_topk(dist_c, idx_c, dist_p, idx_p, k)
        return idx_c, dist_c

    # flat merge: every bank's candidates side by side, re-ranked by the
    # two-key sort (exact also where a bank's rows are not a contiguous run
    # of global ids, as in the index tier)
    dists = mesh.all_gather(dist_local, axis, dim=1, tiled=True)
    gis = mesh.all_gather(idx_local, axis, dim=1, tiled=True)
    dists, gis = _lex_sort(dists, gis)
    return gis[..., :k], dists[..., :k]


def merge_traffic_bytes(n_banks: int, q: int, k: int, *, merge: str = "auto",
                        n_rows: int | None = None) -> int:
    """Per-device bytes *received* over the bank axis during the merge.

    A traffic model of what :func:`_merge_bank_candidates` exchanges: each
    candidate is a float32 distance and an int32 row.  ``n_rows`` defaults
    to enough rows that every bank fields a full (Q, k) list.
    """
    if n_banks < 1:
        raise ValueError(f"n_banks must be >= 1, got {n_banks}")
    n_rows = n_banks * max(1, k) if n_rows is None else n_rows
    k_eff = min(k, n_rows)
    strategy = resolve_merge(merge, n_banks, k_eff)
    local_n = -(-n_rows // n_banks)
    k_local = min(k_eff, local_n)
    entry = 4 + 4
    if strategy == "allgather":
        # every other bank's (Q, k_local) pair lands on this device
        return (n_banks - 1) * q * k_local * entry
    if strategy == "ring":
        # reduce-scatter + all-gather, one (ceil(Q/banks), k_eff) chunk
        # pair per round for banks-1 rounds each
        chunk = -(-q // n_banks)
        return 2 * (n_banks - 1) * chunk * k_eff * entry
    # tree: one padded (Q, k_eff) pair per recursive-doubling round
    return (n_banks - 1).bit_length() * q * k_eff * entry


def _bank_candidates(be: _Backend, table: AMTable, queries: torch.Tensor,
                     lo: int, local_n: int, k_local: int, valid_rows,
                     use_fused: bool, thr: torch.Tensor | None):
    """One bank's (Q, k_local) candidates and, with ``thr``, its count.

    The bank holds rows ``[lo, lo + local_n)`` of the table, as a view;
    the last bank may hold fewer and a bank past the end none.  Its list
    is padded with (+inf, ``_IDX_SENTINEL``) where it holds fewer than
    ``k_local`` rows (the reference pads the table instead, with rows that
    can never reach the result, since k_eff <= N).  Returns (float32
    distances, int32 global rows, (Q,) int32 count or None).
    """
    n = table.n_rows
    rows = max(min(lo + local_n, n) - lo, 0)
    qn, dev = queries.shape[0], queries.device
    count = (None if thr is None
             else torch.zeros((qn,), dtype=torch.int32, device=dev))
    if rows == 0:
        return (torch.full((qn, k_local), torch.inf, device=dev),
                torch.full((qn, k_local), _IDX_SENTINEL, dtype=torch.int32,
                           device=dev), count)
    codes = table.codes[lo:lo + rows]
    ckw = {} if table.care is None else {"care": table.care[lo:lo + rows]}
    vr = n if valid_rows is None else valid_rows
    if isinstance(vr, torch.Tensor):
        vr_local = (vr.to(dev).reshape(()) - lo).clamp(0, rows)
    else:
        vr_local = min(max(int(vr) - lo, 0), rows)
    if use_fused:
        if thr is None:
            il, dl = be.fused(queries, codes, table.bits, table.distance,
                              k=k_local, valid_rows=vr_local, **ckw)
        else:
            il, dl, count = be.fused(queries, codes, table.bits,
                                     table.distance, k=k_local,
                                     valid_rows=vr_local, count_le=thr,
                                     **ckw)
    else:
        d = be.dense(queries, codes, table.bits, table.distance,
                     **ckw).to(torch.float32)
        d = _mask_rows(d, vr_local)
        if thr is not None:
            count = (d <= thr).sum(dim=1, dtype=torch.int32)
        il, dl = _sorted_topk(d, k_local)
    dl, gi = _pad_candidates(dl, il.to(torch.int32) + lo, k_local)
    return dl, gi, count


def search_sharded(table: AMTable, queries, *, mesh, rules=None, k: int = 1,
                   threshold=None, backend: str | BackendFn | None = None,
                   valid_rows=None, merge: str = "auto",
                   matches: int | None = None):
    """Row-banked search over a mesh's bank axis (the multi-bank merge).

    The table's rows split into ``mesh.shape[rules.tp]`` banks of
    ``ceil(N / banks)`` contiguous rows (:meth:`Rules.am_table`; each bank
    a row view, nothing copied); each bank runs the backend on its rows —
    the fused tier per bank where :func:`search` would use it, with the
    bank's slice of ``valid_rows`` — and keeps a local top-k with global
    row indices; the merge then reduces the per-bank candidates to the
    global top-k.

    Args:
      table, queries, k, threshold, backend, valid_rows, matches:
        :func:`search` semantics.  With ``matches=`` the per-bank windows
        ride the same merge and the per-bank counts are summed over the
        bank axis (``psum``), so ``match_count`` and ``overflow`` are
        exact.
      mesh: a :class:`repro_torch.dist.LocalMesh` (banks as slices of one
        device) or :class:`repro_torch.dist.ProcessGroupMesh` (one bank
        per rank, each holding the whole table and searching its rows).
      rules: optional :class:`repro_torch.dist.Rules`; defaults to
        ``make_rules(mesh, "tp")``.
      merge: ``"allgather"`` (one round, O(k * banks) traffic),
        ``"tree"`` (ceil(log2(banks)) rounds of pairwise merges,
        O(k * log banks)), ``"ring"`` (a reduce-scatter over query chunks
        and one chunk all-gather, O(Q * k)), or ``"auto"``
        (:func:`resolve_merge`).  Any bank count works with each.

    When the rules have dp axes and Q divides their width, the queries are
    split over them (:meth:`Rules.am_queries_dp`): each dp slice searches
    its share against all banks.  On a local mesh every slice is this
    device, so its share is the whole batch.

    Returns:
      :class:`AMSearchResult` or :class:`AMMultiMatchResult`, bitwise
      :func:`search` for every merge: each bank's list is ordered by
      (distance, global row) and the merges break ties to the lowest
      global row.  This holds for backends that are row-wise functions of
      their codes (an analog backend with variation is not).
    """
    from repro_torch.dist import specs as dist_specs

    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if matches is not None:
        if k != 1:
            raise ValueError(
                f"pass either k= or matches=, not both (k={k}, "
                f"matches={matches})")
        if matches < 1:
            raise ValueError(f"matches must be >= 1, got {matches}")
    rules = rules or dist_specs.make_rules(mesh, "tp")
    axis = rules.tp
    n_banks = mesh.shape[axis]
    queries, squeeze = _prep_queries(table, queries)
    be = _resolve_backend(backend)
    _care_kwargs(table, be)             # masked-capability check (raises)

    n = table.n_rows
    k_eff = min(matches if matches is not None else k, n)
    strategy = resolve_merge(merge, n_banks, k_eff)
    local_n = -(-n // n_banks)
    k_local = min(k_eff, local_n)
    fusable = be.fused is not None and (matches is None or be.fused_count)
    use_fused = fusable and 1 <= k_local <= FUSED_K_MAX
    if fusable and k_local > FUSED_K_MAX:
        _note_fused_fallback()
    qn = queries.shape[0]
    thr_q = (None if matches is None
             else _match_threshold(threshold, qn, table.device))

    # data-parallel query sharding: each dp slice searches its own share
    dp_axes = tuple(rules.dp or ())
    dp_width = mesh.width(dp_axes)
    batch_axes = dp_axes if dp_width > 1 and qn % dp_width == 0 else None
    q_lo, q_hi = mesh.batch_part(batch_axes, qn)
    q_mine = queries[q_lo:q_hi]
    thr_mine = None if thr_q is None else thr_q[q_lo:q_hi]

    parts = [_bank_candidates(be, table, q_mine, b * local_n, local_n,
                              k_local, valid_rows, use_fused, thr_mine)
             for b in mesh.banks(axis)]
    gi, dl = _merge_bank_candidates(
        torch.stack([p[0] for p in parts]),
        torch.stack([p[1] for p in parts]), mesh=mesh, axis=axis,
        n_banks=n_banks, k=k_eff, strategy=strategy)
    gi = mesh.gather_batch(gi[0], batch_axes)
    dl = mesh.gather_batch(dl[0], batch_axes)
    if matches is None:
        return _finalize(gi, dl, threshold, squeeze)
    # the exact global count: each bank counted disjoint rows
    count = mesh.psum(torch.stack([p[2] for p in parts]), axis)[0]
    count = mesh.gather_batch(count, batch_axes)
    dl, gi = _pad_candidates(dl, gi, matches)
    return _finalize_matches(gi, dl, count, thr_q, matches, squeeze)

"""Serving API for associative search — the CAM as a service.

Port of :mod:`repro.serve.am_service`:

  >>> svc = AMService()                                  # on the GPU
  >>> svc.create_table("responses", width=256, bits=3, capacity=4096,
  ...                  policy="lru", backend="cuda")
  >>> svc.append("responses", codes, values=payloads)
  >>> fut = svc.submit("responses", query, k=4)        # queues, non-blocking
  >>> resp = fut.result()                              # flushes the batch
  >>> resp.hit, resp.value, resp.indices, resp.distances

Design, as in the reference:

* **Fixed-capacity slabs.**  Each named table is an :class:`am.AMTable`
  whose ``codes`` tensor holds ``capacity`` rows from the start; the live
  row count is passed to ``am.search(..., valid_rows=n)``, which the fused
  kernel reads on the device.  Appends write into the slab in place (the
  one in-place update of this module); compaction builds new tensors.
* **Micro-batched dispatch.**  ``submit`` queues; ``flush`` groups queued
  lookups by (table, k, backend, thresholded?, matches) signature, pads
  each group's query count to the next power of two and runs one search
  per group.  PyTorch compiles nothing, so ``stats()["compilations"]``
  counts the distinct dispatch signatures a service has run — bucket,
  k, backend, threshold present or not, matches, and the table's shape,
  bits, distance and ternary-ness — which is exactly the count of the
  reference's jit cache.
* **Pipelined readback.**  ``_launch_group`` enqueues the search and
  non-blocking copies of its results into pinned host buffers, then
  records a CUDA event on the launching thread's current stream; the group
  is ready when the event has passed (``event.query()``) and the
  completion stage waits on that one event — one host synchronisation per
  group.  :class:`AMDriver` overlaps the stages.  All of a service's work
  runs on the calling threads' current streams, which are the default
  stream unless a caller changes it, so an append enqueued after a launch
  never races the launched search.
* **Sub-linear tables via the index tier.**  ``create_table(...,
  index=IndexSpec(sets=32, probes=4))`` gives a table a set-associative
  :class:`repro_torch.index.ivf.IVFIndex`: built lazily once the table
  holds ``index.build_threshold`` live rows, extended incrementally on
  appends, rebuilt after compaction (eviction renumbers rows).  Dispatches
  route through :func:`repro_torch.index.ivf.search` transparently — same
  micro-batching, same padding buckets — and ``stats()["index"]`` reports
  builds, indexed lookups and candidate fractions.  ``probes == sets`` is
  bitwise the flat search; fewer probes trade certified recall for
  O(S + probes * N/S) work per lookup.  Each indexed group launches the
  coarse dense search once and the fine search once per distinct probed
  set.  Indexed tables refuse ``matches=`` (the coarse pass prunes rows
  multi-match must see) and ``ternary`` (a wildcard row belongs to no
  single set).
* **Admission control**, **cross-request dedup**, **ternary tables** and
  **multi-match lookups**, **LRU/TTL/reject eviction** and the logical or
  wall **clock** behave exactly as in the reference (see its module
  docstring).

* **Pluggable placement.**  Constructed with a ``mesh`` (a
  :mod:`repro_torch.dist` mesh; ``rules`` optional), every dispatch routes
  through ``am.search_sharded`` — rows banked over the ``model`` axis as
  row views of the one slab, the query bucket split over the dp axes when
  it divides them — or, for an indexed table, ``ivf.search_sharded``.
  ``merge=`` picks the cross-bank candidate reduction (``"auto"``,
  ``"allgather"``, ``"tree"``, ``"ring"``) and is validated at
  construction.  Results are bitwise the local service's; ``stats()``
  reports ``"sharded"`` and ``"merge"``, and each group still costs one
  readback.  On one GPU a group launches the search once per bank.

* **Durability.**  ``snapshot(dir)`` commits every table atomically through
  :mod:`repro_torch.checkpoint`, in the reference's on-disk format;
  ``AMService.restore(dir, mesh=..., device=...)`` warm-restarts onto any
  bank count with bitwise-identical search results (see
  :mod:`repro_torch.serve.snapshot`).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import am
from repro_torch.device import resolve_device
from repro_torch.dist.specs import make_rules
from repro_torch.index import ivf
from repro_torch.index.ivf import IndexSpec

#: Eviction policies a table may be created with.
POLICIES = ("lru", "ttl", "reject")

#: Admission-control behaviours for an over-budget submit.
ADMISSION_MODES = ("reject", "shed", "block")

#: Lifecycle states of an :class:`AMDriver`.
DRIVER_STATES = ("idle", "running", "draining", "stopped")

#: In-flight groups retire strictly in dispatch order.
COMPLETION_ORDER = "fifo"

#: Meta timestamps are float32, integer-exact only to 2**24; the logical
#: clock rebases every live timestamp down once it reaches this.
_REBASE_TICKS = float(1 << 23)

#: Queue waits kept as they are for the stats() percentiles; past this
#: many, the percentiles come from :class:`WaitHistogram`'s buckets.
_EXACT_WAITS = 4096


class WaitHistogram:
    """Queue waits of every lookup a service resolved, in constant memory.

    Each wait lands in one of ``BUCKETS_PER_DECADE`` log-spaced buckets a
    decade from ``LOW`` to ``HIGH`` clock units (a bucket spans a factor of
    10 ** (1 / 100), 2.33 %), or in one bucket below ``LOW`` (zero waits
    too) or one at ``HIGH`` and above.  The first :data:`_EXACT_WAITS` waits
    are also kept as they are: while they are all the waits there are, a
    percentile is NumPy's (linear) over them; past that it is the geometric
    middle of the bucket that holds the wait of its rank, within one bucket
    of the exact value (0 below ``LOW``, ``HIGH`` at or above it).
    """

    BUCKETS_PER_DECADE = 100
    LOW, HIGH = 1e-9, 1e9

    def __init__(self):
        decades = round(math.log10(self.HIGH / self.LOW))
        self._counts = np.zeros(decades * self.BUCKETS_PER_DECADE + 2,
                                np.int64)
        self._exact = np.empty(_EXACT_WAITS, np.float64)
        self.n = 0

    def add(self, waits) -> None:
        """Count a sequence of waits (clock units)."""
        w = np.asarray(waits, np.float64).reshape(-1)
        keep = min(w.size, max(0, self._exact.size - self.n))
        self._exact[self.n:self.n + keep] = w[:keep]
        top = self._counts.size - 1
        with np.errstate(divide="ignore", invalid="ignore"):
            b = np.log10(w / self.LOW) * self.BUCKETS_PER_DECADE
        b = np.where(w < self.LOW, 0, np.where(
            w >= self.HIGH, top, 1 + np.clip(np.nan_to_num(b), 0, top - 2)))
        np.add.at(self._counts, b.astype(np.int64), 1)
        self.n += w.size

    def percentiles(self, qs) -> list[float]:
        """The ``qs`` percentiles (0-100) of every wait counted; 0.0 each
        before the first."""
        if self.n == 0:
            return [0.0] * len(qs)
        if self.n <= self._exact.size:
            return np.percentile(self._exact[:self.n], qs).tolist()
        cum = np.cumsum(self._counts)
        out = []
        for q in qs:
            rank = math.floor(q / 100.0 * (self.n - 1))
            b = int(np.searchsorted(cum, rank, side="right"))
            if b == 0:
                out.append(0.0)
            elif b == self._counts.size - 1:
                out.append(self.HIGH)
            else:
                out.append(self.LOW * 10 ** ((b - 0.5)
                                             / self.BUCKETS_PER_DECADE))
        return out

    def clear(self) -> None:
        """Forget every wait counted so far."""
        self._counts[:] = 0
        self.n = 0


class TableFullError(RuntimeError):
    """An append would exceed capacity and the policy forbids eviction."""


class AdmissionError(RuntimeError):
    """A submit was refused by admission control (budget or queue cap)."""


# ---------------------------------------------------------------------------
# Request / response dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One associative lookup against a named table."""

    rid: int
    table: str
    query: np.ndarray              # (D,) int32 symbol word
    k: int = 1
    threshold: float | None = None
    backend: str | None = None     # None -> the table's default backend
    matches: int | None = None     # multi-match window width (TCAM mode)
    submitted_at: float = 0.0


@dataclasses.dataclass(frozen=True)
class SearchResponse:
    """Top-k outcome of one request, resolved to its host payload.

    All arrays are host numpy from the group's single readback.  Entries
    beyond the table's live row count carry index ``-1``, distance ``+inf``
    and False flags.  ``admitted`` is False only for shed lookups.
    """

    rid: int
    table: str
    indices: np.ndarray            # (k,) int32 rows, best first; -1 invalid
    distances: np.ndarray          # (k,) float32 contract units
    exact: np.ndarray              # (k,) bool — exact word match
    matched: np.ndarray            # (k,) bool — within the request threshold
    value: Any = None              # payload of the best row on an exact hit
    admitted: bool = True          # False: shed by admission control
    match_count: int | None = None  # multi-match only: total matching rows
    overflow: bool | None = None    # multi-match only: count > window width

    @property
    def hit(self) -> bool:
        """Did the best candidate match exactly?"""
        return bool(self.exact[0])

    @property
    def best_row(self) -> int:
        return int(self.indices[0])


class PendingSearch:
    """Future-like handle returned by :meth:`AMService.submit`.

    ``result()`` forces progress if the response is not there yet: with no
    driver running it flushes the queue; with a live :class:`AMDriver` it
    expedites the queued bucket and waits on the completion stage.
    """

    __slots__ = ("request", "_service", "_response", "_event")

    def __init__(self, service: "AMService", request: SearchRequest):
        self.request = request
        self._service = service
        self._response: SearchResponse | None = None
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._response is not None

    def _resolve(self, response: SearchResponse) -> None:
        self._response = response
        self._event.set()

    def result(self, timeout: float | None = None) -> SearchResponse:
        if self._response is None:
            svc = self._service
            drv = svc._driver
            if drv is not None and drv.is_alive():
                svc._expedite(self)
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while self._response is None:
                    if drv.exception is not None:
                        raise RuntimeError(
                            "AMService driver thread died") from drv.exception
                    if not drv.is_alive():
                        svc.flush()            # driver gone: finish sync
                        break
                    wait = 0.05
                    if deadline is not None:
                        wait = min(wait, deadline - time.monotonic())
                        if wait <= 0:
                            raise TimeoutError(
                                f"request {self.request.rid} unresolved "
                                f"after {timeout}s")
                    self._event.wait(wait)
            else:
                svc.flush()
            # A concurrent flush() may have claimed this request's bucket
            # and be mid-readback: wait for that completion stage.
            if self._response is None and not self._event.wait(timeout):
                raise TimeoutError(
                    f"request {self.request.rid} unresolved after {timeout}s")
        return self._response


# ---------------------------------------------------------------------------
# Table state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _TableState:
    """One named table: capacity slab + host-side bookkeeping."""

    name: str
    table: am.AMTable              # (capacity, D) codes + (capacity, 2) meta
    n: int                         # live rows (<= capacity)
    capacity: int
    policy: str
    ttl: float | None
    backend: str
    values: list                   # host payloads, aligned with live rows
    version: int = 0               # bumped on every append/delete/evict
    appends: int = 0
    evicted: int = 0
    hits: int = 0
    misses: int = 0
    # -- admission control ---------------------------------------------------
    qps_budget: float | None = None    # sustained lookups per clock unit
    burst: float = 1.0                 # token-bucket depth
    max_queue: int | None = None       # cap on this table's queued lookups
    admission: str = "reject"          # over-budget behaviour
    tokens: float = 0.0                # current token-bucket level
    tokens_at: float = 0.0             # clock reading of the last refill
    queued: int = 0                    # lookups currently in the shared queue
    rejected: int = 0
    shed: int = 0
    blocked: int = 0                   # submits that had to wait
    # dispatched groups by power-of-two bucket size
    buckets: dict = dataclasses.field(default_factory=dict)
    # -- set-associative index tier (repro_torch.index) ----------------------
    index_spec: IndexSpec | None = None
    index: "ivf.IVFIndex | None" = None   # built lazily per index_spec
    index_builds: int = 0              # full (re)builds (lazy + compaction)
    index_lookups: int = 0             # lookups served through the index
    index_groups: int = 0              # dispatched groups served through it
    index_frac_sum: float = 0.0        # sum of per-group candidate fractions


@dataclasses.dataclass
class _InFlightGroup:
    """One dispatched bucket awaiting its completion-stage readback.

    ``host`` holds the results — pinned host tensors being filled by
    non-blocking copies on a GPU, the results themselves on the CPU — and
    ``event`` (GPU only) is recorded after those copies.
    """

    table: _TableState
    futs: list
    slot_of: list
    host: tuple                    # (idx, dist, exact, matched, count,
    #                                 overflow, frac); count and overflow
    #                                 are None unless the group is
    #                                 multi-match, frac (the mean candidate
    #                                 fraction) unless it is indexed
    event: Any                     # torch.cuda.Event, or None on the CPU
    new_meta: torch.Tensor         # post-touch meta, written back if fresh
    version: int                   # table.version at launch
    values: list                   # payload list as of launch
    now: float                     # dispatch-time clock reading

    def ready(self) -> bool:
        """True when the results have landed (non-blocking probe)."""
        return self.event is None or self.event.query()


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device without a host sync (pinned, non-blocking)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(t: torch.Tensor | None) -> torch.Tensor | None:
    """Start a non-blocking copy of ``t`` into a pinned host tensor."""
    if t is None or t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

class AMService:
    """Named associative-search tables + a micro-batching lookup scheduler.

    Thread-safe: one service lock guards table state, the queue and the
    in-flight list; readbacks wait outside it.

    Args:
      mesh: optional :mod:`repro_torch.dist` mesh; when given, every
        dispatch routes through :func:`am.search_sharded` (rows banked over
        ``rules.tp``) or :func:`ivf.search_sharded`.
      rules: optional :class:`repro_torch.dist.Rules`; defaults to
        ``make_rules(mesh, "tp")`` when a mesh is given.
      merge: cross-bank merge strategy (``"auto"`` | ``"allgather"`` |
        ``"tree"`` | ``"ring"``); only meaningful with a mesh.
      max_batch: queued lookups that trigger an automatic flush.
      flush_after: deadline in clock units on the oldest queued request; as
        an idle deadline it needs a real clock (``time_fn``) and a driver.
      time_fn: clock source; ``None`` uses a deterministic logical tick
        (+1.0 per submit/append/flush).
      device: where every table lives; ``None`` means the GPU and raises
        when there is none.
    """

    def __init__(self, *, mesh=None, rules=None, merge: str = "auto",
                 max_batch: int = 64, flush_after: float | None = None,
                 time_fn: Callable[[], float] | None = None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if merge not in am.MERGE_STRATEGIES:
            raise ValueError(f"unknown merge {merge!r}; expected one of "
                             f"{am.MERGE_STRATEGIES}")
        if flush_after is not None and time_fn is None:
            warnings.warn(
                "AMService(flush_after=...) with the default logical clock "
                "only observes the deadline at submit time: an idle "
                "half-full bucket never auto-flushes.  Pass "
                "time_fn=time.monotonic and run svc.start_driver() for a "
                "live idle deadline.", RuntimeWarning, stacklevel=2)
        self.device = resolve_device(device)
        self._mesh = mesh
        self._merge = merge
        self._rules = ((rules or make_rules(mesh, "tp"))
                       if mesh is not None else rules)
        self.max_batch = max_batch
        self.flush_after = flush_after
        self._time_fn = time_fn
        self._clock = 0.0
        self._epoch: float | None = None
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._tables: dict[str, _TableState] = {}
        self._pending: list[PendingSearch] = []
        self._in_flight: collections.deque[_InFlightGroup] = \
            collections.deque()
        self._waits = WaitHistogram()
        self._drain_req = False
        self._resolving = 0            # popped in-flight groups mid-readback
        self._driver: AMDriver | None = None
        self._next_rid = 0
        self._signatures: set[tuple] = set()
        self.flushes = 0
        self.readbacks = 0
        self.dispatched = 0            # requests routed through a dispatch
        self.dedup_hits = 0            # of those, resolved from a shared row
        self.fused_fallbacks = 0       # groups dense-downgraded by k ceiling
        self._last_snapshot: dict | None = None   # stage seconds, see snapshot

    # -- clock ---------------------------------------------------------------

    def _tick(self) -> float:
        # Timestamps land in float32 meta, so they must stay small: wall
        # clocks are re-based to the service's first reading, and the
        # logical clock shifts every live timestamp down before it leaves
        # float32's integer-exact range.  Rebase only when nothing is
        # queued or in flight.
        if self._time_fn is not None:
            return self._now()
        self._clock += 1.0
        if (self._clock >= _REBASE_TICKS and not self._pending
                and not self._in_flight and not self._resolving):
            shift = self._clock
            self._clock = 0.0
            for t in self._tables.values():
                t.table = dataclasses.replace(t.table,
                                              meta=t.table.meta - shift)
        return self._clock

    def _now(self) -> float:
        """Read the clock without advancing the logical tick."""
        if self._time_fn is not None:
            t = float(self._time_fn())
            if self._epoch is None:
                self._epoch = t
            return t - self._epoch
        return self._clock

    # -- table lifecycle -----------------------------------------------------

    def create_table(self, name: str, *, width: int, bits: int = 3,
                     distance: str = "hamming", capacity: int = 1024,
                     policy: str = "lru", ttl: float | None = None,
                     backend: str = "ref",
                     qps_budget: float | None = None,
                     burst: float | None = None,
                     max_queue: int | None = None,
                     admission: str = "reject",
                     index: IndexSpec | None = None,
                     ternary: bool = False) -> None:
        """Allocate an empty capacity-bounded table under ``name``.

        Admission control (all optional): ``qps_budget`` is a sustained
        lookups-per-clock-unit token bucket (depth ``burst``, default
        ``max(1, qps_budget)``), ``max_queue`` caps this table's queued
        lookups, and ``admission`` picks the over-budget behaviour.
        ``ternary`` allocates a care-mask plane beside the code slab (a
        masked backend required).

        ``index`` (an :class:`repro_torch.index.IndexSpec`) turns on the
        set-associative index tier for this table: once the table holds
        ``index.build_threshold`` live rows, dispatches route through
        :func:`repro_torch.index.ivf.search` with the spec's ``probes``.
        Appends extend the index incrementally; evictions/deletes rebuild
        it (compaction renumbers rows).  ``stats()`` grows an ``"index"``
        block.  Mutually exclusive with ``ternary``.
        """
        if name in self._tables:
            raise ValueError(f"table {name!r} already exists")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
        if (ttl is None) == (policy == "ttl"):
            raise ValueError("ttl must be set iff policy == 'ttl'")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"unknown admission {admission!r}; expected "
                             f"one of {ADMISSION_MODES}")
        if qps_budget is not None and qps_budget <= 0:
            raise ValueError(f"qps_budget must be > 0, got {qps_budget}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if index is not None:
            index.validate()
            if index.sets > capacity:
                raise ValueError(
                    f"index sets ({index.sets}) exceeds table capacity "
                    f"({capacity}); every set needs at least one row slot")
        am.get_backend(backend)          # fail fast on unknown backends
        if ternary:
            if index is not None:
                raise ValueError(
                    "ternary tables cannot use the index tier: the "
                    "set-associative coarse pass has no wildcard semantics")
            if "masked" not in am.backend_capabilities(backend):
                raise ValueError(
                    f"backend {backend!r} lacks the 'masked' capability "
                    "tier required for ternary tables")
        dev = self.device
        table = am.make_table(
            torch.zeros((capacity, width), dtype=torch.int32, device=dev),
            bits=bits, distance=distance,
            meta=am.serving_meta(capacity, 0.0, device=dev),
            care_mask=(torch.ones((capacity, width), dtype=torch.int32,
                                  device=dev) if ternary else None),
            device=dev)
        if burst is None:
            burst = max(1.0, float(qps_budget)) if qps_budget else 1.0
        else:
            burst = float(burst)
        with self._lock:
            self._tables[name] = _TableState(
                name=name, table=table, n=0, capacity=capacity, policy=policy,
                ttl=ttl, backend=backend, values=[],
                qps_budget=qps_budget, burst=burst, max_queue=max_queue,
                admission=admission, tokens=burst, tokens_at=self._now(),
                index_spec=index)

    def drop_table(self, name: str) -> None:
        """Remove a table; queued and in-flight lookups resolve first."""
        while True:
            with self._lock:
                self._state(name)        # fail fast on unknown names
                has_work = (any(p.request.table == name
                                for p in self._pending)
                            or any(g.table.name == name
                                   for g in self._in_flight))
                if not has_work:
                    del self._tables[name]
                    return
            self.flush()

    def _state(self, name: str) -> _TableState:
        try:
            return self._tables[name]
        except KeyError:
            raise ValueError(
                f"unknown table {name!r}; existing: {tuple(self._tables)}"
            ) from None

    def append(self, name: str, codes, values=None, *,
               care=None, now: float | None = None) -> None:
        """Insert rows (evicting per policy first if capacity requires).

        ``values`` carries one host payload per appended row; payloads
        follow their rows through eviction and come back on exact hits as
        ``SearchResponse.value``.  ``care`` (ternary tables only) gives each
        row its care plane; omitted, ternary rows default to all-care.
        """
        codes = np.asarray(codes, np.int32)
        if codes.ndim == 1:
            codes = codes[None]
        with self._lock:
            t = self._state(name)
            if codes.ndim != 2 or codes.shape[1] != t.table.width:
                raise ValueError(f"append codes shape {codes.shape} != "
                                 f"(m, {t.table.width})")
            if care is not None and t.table.care is None:
                raise ValueError(
                    f"table {name!r} is not ternary; create it with "
                    "ternary=True to append care masks")
            if t.table.care is not None:
                care = (np.ones_like(codes) if care is None
                        else np.asarray(care, np.int32))
                if care.ndim == 1:
                    care = care[None]
                if care.shape != codes.shape:
                    raise ValueError(f"append care shape {care.shape} != "
                                     f"codes shape {codes.shape}")
            m = codes.shape[0]
            if m > t.capacity:
                raise TableFullError(
                    f"appending {m} rows exceeds table capacity {t.capacity}")
            if values is None:
                values = [None] * m
            elif not isinstance(values, (list, tuple)):
                values = [values]
            if len(values) != m:
                raise ValueError(f"{len(values)} values for {m} rows")
            now = self._tick() if now is None else float(now)
            self._make_room(t, m, now)
            # In place: the slab belongs to this service, and a search
            # launched earlier is ordered before this write on the stream.
            start = t.n
            rows = slice(start, start + m)
            t.table.codes[rows] = _to_device(codes, self.device)
            t.table.meta[rows] = now
            if t.table.care is not None:
                t.table.care[rows] = _to_device(
                    (care != 0).astype(np.int32), self.device)
            t.values.extend(values)
            t.n += m
            t.appends += m
            t.version += 1
            if t.index is not None:
                # incremental: new rows land at their sets' slab ends with
                # the global ids the slab write just gave them
                t.index = ivf.append(t.index, codes, start_row=start)
            elif t.index_spec is not None:
                self._rebuild_index(t)       # lazy build once big enough

    def delete(self, name: str, rows) -> int:
        """Drop live rows by index array or boolean mask; returns the count.

        Integer indices must satisfy ``0 <= row < live rows``; both
        out-of-range directions raise :class:`ValueError`.
        """
        with self._lock:
            t = self._state(name)
            rows = np.asarray(rows)
            kill = np.zeros((t.n,), bool)
            if rows.dtype == np.bool_:
                if rows.shape != (t.n,):
                    raise ValueError(f"mask shape {rows.shape} != ({t.n},)")
                kill |= rows
            else:
                idx = rows.reshape(-1).astype(np.int64)
                bad = idx[(idx < 0) | (idx >= t.n)]
                if bad.size:
                    raise ValueError(
                        f"delete indices out of range [0, {t.n}): "
                        f"{sorted(set(bad.tolist()))}")
                kill[idx] = True
            killed = int(kill.sum())
            if killed:
                self._compact(t, kill)
            return killed

    def evict(self, name: str, *, now: float | None = None) -> int:
        """Run the table's eviction policy now; returns rows evicted."""
        with self._lock:
            t = self._state(name)
            now = self._tick() if now is None else float(now)
            before = t.n
            self._make_room(t, 0, now)
            return before - t.n

    def _make_room(self, t: _TableState, m: int, now: float) -> None:
        """Evict per policy so ``m`` more rows fit under ``capacity``.

        The timestamps are read back only when a TTL or an overflow needs
        them, so an append that fits costs no host sync.
        """
        if t.n == 0 or (t.policy != "ttl" and t.n + m <= t.capacity):
            return
        kill = np.zeros((t.n,), bool)
        meta = t.table.meta[:t.n].cpu().numpy()
        if t.policy == "ttl":
            kill |= (now - meta[:, am.META_INSERT]) > t.ttl
        overflow = (t.n - int(kill.sum())) + m - t.capacity
        if overflow > 0:
            if t.policy == "reject":
                raise TableFullError(
                    f"table {t.name!r} is full ({t.capacity} rows) and "
                    f"policy 'reject' forbids eviction")
            # lru: least-recently-hit first; ttl overflow: oldest insert first
            col = am.META_LAST_HIT if t.policy == "lru" else am.META_INSERT
            alive = np.flatnonzero(~kill)
            order = alive[np.argsort(meta[alive, col], kind="stable")]
            kill[order[:overflow]] = True
        if kill.any():
            t.evicted += int(kill.sum())
            self._compact(t, kill)

    def _compact(self, t: _TableState, kill: np.ndarray) -> None:
        """Delete masked live rows and repack survivors at the slab front."""
        live = am.AMTable(codes=t.table.codes[:t.n], meta=t.table.meta[:t.n],
                          care=(None if t.table.care is None
                                else t.table.care[:t.n]),
                          bits=t.table.bits, distance=t.table.distance)
        live = am.delete(live, kill)               # the eviction-mask path
        keep = np.flatnonzero(~kill)
        n = live.n_rows

        def repacked(slab, rows, fill):
            out = torch.full_like(slab, fill)
            out[:n] = rows
            return out

        t.table = dataclasses.replace(
            t.table,
            codes=repacked(t.table.codes, live.codes, 0),
            meta=repacked(t.table.meta, live.meta, 0),
            care=(None if t.table.care is None
                  else repacked(t.table.care, live.care, 1)))
        t.values = [t.values[i] for i in keep]
        t.n = n
        t.version += 1
        if t.index_spec is not None:
            # compaction renumbered the surviving rows: the index's global
            # ids are stale, so rebuild (or drop below the build threshold)
            self._rebuild_index(t)

    def _rebuild_index(self, t: _TableState) -> None:
        """Lock held: (re)build the table's IVF index per its spec.

        Below the spec's ``build_threshold`` the index is dropped instead —
        dispatches fall back to the exact flat search until the table grows
        back (training centroids on a handful of rows is pure noise).
        """
        spec = t.index_spec
        if t.n < spec.build_threshold:
            t.index = None
            return
        live = am.AMTable(codes=t.table.codes[:t.n], bits=t.table.bits,
                          distance=t.table.distance)
        t.index = ivf.build(live, sets=spec.sets, method=spec.method,
                            seed=spec.seed, iters=spec.iters)
        t.index_builds += 1

    # -- admission -----------------------------------------------------------

    def _admission_verdict(self, t: _TableState,
                           now: float) -> str | None:
        """Refill the token bucket; return None (admit) or what's exceeded."""
        if t.max_queue is not None and t.queued >= t.max_queue:
            return "max_queue"
        if t.qps_budget is not None:
            t.tokens = min(t.burst,
                           t.tokens + (now - t.tokens_at) * t.qps_budget)
            t.tokens_at = now
            if t.tokens < 1.0:
                return "qps_budget"
        return None

    # -- lookups -------------------------------------------------------------

    def _request(self, name: str, t: _TableState, query, k, threshold,
                 backend, matches, submitted_at) -> SearchRequest:
        req = SearchRequest(
            rid=self._next_rid, table=name, query=query,
            k=min(k, t.capacity),
            threshold=None if threshold is None else float(threshold),
            backend=backend or t.backend, matches=matches,
            submitted_at=submitted_at)
        self._next_rid += 1
        return req

    def submit(self, name: str, query, *, k: int = 1,
               threshold: float | None = None,
               backend: str | None = None,
               matches: int | None = None) -> PendingSearch:
        """Queue one lookup; returns a handle whose ``result()`` blocks.

        Lookups against an empty table resolve immediately as misses.
        Admission control runs before anything queues.  ``matches=M``
        switches the lookup to TCAM multi-match semantics (mutually
        exclusive with ``k``).
        """
        if matches is not None:
            if k != 1:
                raise ValueError("pass either k= or matches=, not both")
            if matches < 1:
                raise ValueError(f"matches must be >= 1, got {matches}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        query = np.asarray(query, np.int32)
        if backend is not None:
            am.get_backend(backend)      # fail here, not at dispatch time
        blocked_once = False
        while True:
            with self._lock:
                t = self._state(name)
                if query.shape != (t.table.width,):
                    raise ValueError(
                        f"query shape {query.shape} != ({t.table.width},)")
                if matches is not None and t.index_spec is not None:
                    raise ValueError(
                        f"table {name!r} uses the index tier; multi-match "
                        "needs the full row scan (matches= is unavailable)")
                if (t.table.care is not None and backend is not None
                        and "masked" not in am.backend_capabilities(backend)):
                    raise ValueError(
                        f"backend {backend!r} lacks the 'masked' tier "
                        f"required by ternary table {name!r}")
                over = self._admission_verdict(t, self._now())
                if over is None:
                    if t.qps_budget is not None:
                        t.tokens -= 1.0
                    now = self._tick()
                    fut = PendingSearch(self, self._request(
                        name, t, query, k, threshold, backend, matches, now))
                    if t.n == 0:
                        self._resolve_empty(t, fut)
                        return fut
                    self._pending.append(fut)
                    t.queued += 1
                    due = (len(self._pending) >= self.max_batch
                           or self._deadline_due(now))
                    drv = self._driver
                    if drv is not None and drv.is_alive():
                        if due:
                            drv._wake.set()   # the driver owns the dispatch
                        return fut
                    if not due:
                        return fut
                    break                     # sync path: flush outside loop
                # over budget.  Non-admitted submits still advance the
                # logical clock, or an exhausted bucket would never refill.
                if self._time_fn is None and t.admission != "block":
                    self._tick()
                if t.admission == "reject":
                    t.rejected += 1
                    raise AdmissionError(
                        f"table {name!r} over {over} "
                        f"(admission='reject'): lookup refused")
                if t.admission == "shed":
                    t.shed += 1
                    fut = PendingSearch(self, self._request(
                        name, t, query, k, threshold, backend, matches,
                        self._now()))
                    fut._resolve(self._miss_response(fut.request,
                                                     admitted=False))
                    return fut
                # block: wait for headroom outside the lock
                if not blocked_once:
                    t.blocked += 1
                    blocked_once = True
                drv = self._driver
                queue_over = over == "max_queue"
            if queue_over:
                self.flush()                  # make room ourselves
                continue
            if self._time_fn is None:
                raise AdmissionError(
                    f"table {name!r} over qps_budget with admission='block' "
                    "but no real clock to wait on: construct AMService with "
                    "time_fn=time.monotonic, or use 'reject'/'shed'")
            if drv is not None and drv.is_alive():
                drv._wake.set()
            time.sleep(5e-4)
        self.flush()
        return fut

    def lookup(self, name: str, query, *, k: int = 1,
               threshold: float | None = None,
               backend: str | None = None,
               matches: int | None = None) -> SearchResponse:
        """Synchronous convenience: submit + flush in one call."""
        return self.submit(name, query, k=k, threshold=threshold,
                           backend=backend, matches=matches).result()

    @staticmethod
    def _miss_response(req: SearchRequest, *,
                       admitted: bool = True) -> SearchResponse:
        mm = req.matches is not None
        k = req.matches if mm else req.k
        return SearchResponse(
            rid=req.rid, table=req.table,
            indices=np.full((k,), -1, np.int32),
            distances=np.full((k,), np.inf, np.float32),
            exact=np.zeros((k,), bool), matched=np.zeros((k,), bool),
            admitted=admitted,
            match_count=0 if mm else None, overflow=False if mm else None)

    def _resolve_empty(self, t: _TableState, fut: PendingSearch) -> None:
        fut._resolve(self._miss_response(fut.request))
        t.misses += 1

    def _deadline_due(self, now: float) -> bool:
        """Lock held: has the oldest queued request crossed ``flush_after``?"""
        return (self.flush_after is not None and bool(self._pending)
                and now - self._pending[0].request.submitted_at
                >= self.flush_after)

    def _take_pending(self) -> dict[tuple, list[PendingSearch]]:
        """Lock held: drain the queue into signature groups.

        Lookups whose table has vanished resolve immediately as misses.
        """
        pending, self._pending = self._pending, []
        groups: dict[tuple, list[PendingSearch]] = {}
        for fut in pending:
            r = fut.request
            t = self._tables.get(r.table)
            if t is None:
                fut._resolve(self._miss_response(r))
                continue
            t.queued -= 1
            key = (r.table, r.k, r.backend, r.threshold is not None,
                   r.matches)
            groups.setdefault(key, []).append(fut)
        return groups

    def flush(self, *, now: float | None = None) -> int:
        """Dispatch and complete every queued lookup; returns how many.

        Each signature group becomes one search over queries padded to the
        next power of two, and one readback fans the batch out to the
        waiting futures.  Groups already in flight are retired first
        (FIFO).  This serial path is the bitwise reference the pipelined
        driver is tested against; use :meth:`drain` for quiescence under
        a live driver.
        """
        with self._lock:
            served = 0
            if self._pending:
                now = self._tick() if now is None else float(now)
                served = self._launch_pending(now)
        while self._complete_next():           # retire everything in flight
            pass
        return served

    def poll(self, *, now: float | None = None) -> int:
        """Flush the queue if the oldest queued request's deadline expired.

        Reads the clock without advancing the logical tick.  Returns the
        number of lookups served.
        """
        with self._lock:
            if not self._pending or self.flush_after is None:
                return 0
            now = self._now() if now is None else float(now)
            if not self._deadline_due(now):
                return 0
        return self.flush(now=now)

    def drain(self, timeout: float | None = None) -> bool:
        """Resolve everything queued and in flight; True when fully drained."""
        quiet = lambda: (not self._pending and not self._in_flight
                         and self._resolving == 0)
        drv = self._driver
        if drv is None or not drv.is_alive():
            self.flush()
            with self._cv:
                ok = self._cv.wait_for(
                    lambda: self._resolving == 0, timeout)
                return ok and quiet()
        with self._cv:
            self._drain_req = True
            drv._wake.set()
            ok = self._cv.wait_for(quiet, timeout)
            self._drain_req = False
        return ok

    # -- durability (repro_torch.serve.snapshot) -----------------------------

    def snapshot(self, directory, *, step: int | None = None,
                 keep: int = 2, app: dict | None = None,
                 drain_timeout: float | None = 60.0) -> int:
        """Durable snapshot of every table under ``directory``; returns step.

        Quiesces via :meth:`drain` first (every acknowledged append is
        included), copies the tables under the service lock, then commits
        one atomic checkpoint per table plus a ``service.json`` commit point
        — see :mod:`repro_torch.serve.snapshot` for the layout and manifest
        contract.
        """
        from repro_torch.serve import snapshot as _snap
        return _snap.snapshot_service(self, directory, step=step, keep=keep,
                                      app=app, drain_timeout=drain_timeout)

    @classmethod
    def restore(cls, directory, *, mesh=None, rules=None,
                step: int | None = None, time_fn=None,
                merge: str | None = None, max_batch: int | None = None,
                flush_after: float | None = None,
                device=None) -> "AMService":
        """Warm-restart a service from a :meth:`snapshot` directory.

        ``mesh`` may have another bank count than the snapshotting service
        (elastic: searches stay bitwise-identical).  ``device`` is where the
        tables go; ``None`` means the GPU, and raises without one.
        """
        from repro_torch.serve import snapshot as _snap
        return _snap.restore_service(directory, mesh=mesh, rules=rules,
                                     step=step, time_fn=time_fn, merge=merge,
                                     max_batch=max_batch,
                                     flush_after=flush_after, device=device)

    def _expedite(self, fut: PendingSearch) -> None:
        """Force progress for one future: dispatch its bucket, help retire."""
        with self._lock:
            if fut._response is not None:
                return
            if self._pending:
                self._launch_pending(self._tick())
        while fut._response is None and self._complete_next():
            pass

    # -- the two pipeline stages ---------------------------------------------

    def _launch_pending(self, now: float) -> int:
        """Lock held: dispatch every queued lookup as in-flight groups."""
        groups = self._take_pending()
        served = 0
        for (name, k, backend, has_thr, matches), futs in groups.items():
            with obs.span("am.driver.launch"):
                self._launch_group(self._state(name), futs, k, backend,
                                   has_thr, matches, now)
            served += len(futs)
        if served:
            self.flushes += 1
        return served

    def _launch_group(self, t: _TableState, futs: list[PendingSearch],
                      k: int, backend: str, has_thr: bool,
                      matches: int | None, now: float) -> _InFlightGroup:
        """Lock held: enqueue one search and its readback; no host sync.

        Identical (query, threshold) rows dispatch once; the shared result
        row fans out to every duplicate at completion.  Hashing happens
        before padding, so repeats can shrink the power-of-two bucket.
        """
        slot_of: list[int] = []
        slots: dict[tuple[bytes, float | None], int] = {}
        uniq: list[PendingSearch] = []
        for fut in futs:
            r = fut.request
            key = (r.query.tobytes(), r.threshold)
            slot = slots.setdefault(key, len(slots))
            if slot == len(uniq):
                uniq.append(fut)
            slot_of.append(slot)
        q = len(uniq)
        self.dispatched += len(futs)
        self.dedup_hits += len(futs) - q
        qb = _next_pow2(q)
        t.buckets[qb] = t.buckets.get(qb, 0) + 1
        queries = np.zeros((qb, t.table.width), np.int32)
        for i, fut in enumerate(uniq):
            queries[i] = fut.request.query
        thr = None
        if has_thr:
            tv = np.zeros((qb,), np.float32)
            tv[:q] = [fut.request.threshold for fut in uniq]
            thr = _to_device(tv, self.device)
        tab, index = t.table, t.index
        probes = t.index_spec.probes if index is not None else 0
        self._signatures.add((qb, k, backend, has_thr, matches,
                              tuple(tab.codes.shape), tab.bits, tab.distance,
                              tab.care is not None, probes,
                              None if index is None
                              else tuple(index.slabs.shape)))
        out = self._dispatch(tab, _to_device(queries, self.device), t.n, q,
                             thr, now, k=k, backend=backend, matches=matches,
                             index=index, probes=probes, mesh=self._mesh,
                             rules=self._rules, merge=self._merge)
        # the window of one candidate search: a bank's rows on a mesh; an
        # indexed top-k counts at the table's rows, as the reference does
        multi = matches is not None
        rows = tab.n_rows
        if self._mesh is not None and (index is None or multi):
            rows = -(-rows // self._mesh.shape[self._rules.tp])
        if am.dense_fallback(backend, min(matches if multi else k, rows),
                             multi=multi):
            self.fused_fallbacks += 1
        *arrays, new_meta = out
        host = tuple(_to_host(a) for a in arrays)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        g = _InFlightGroup(table=t, futs=futs, slot_of=slot_of, host=host,
                           event=event, new_meta=new_meta, version=t.version,
                           values=t.values, now=now)
        self._in_flight.append(g)
        return g

    def _complete_next(self, *, only_ready: bool = False) -> bool:
        """Retire the oldest in-flight group (FIFO); False if none retired.

        ``only_ready`` makes this a non-blocking probe.  A popped group
        counts in ``_resolving`` until its futures are resolved.
        """
        with self._lock:
            if not self._in_flight:
                return False
            g = self._in_flight[0]
            if only_ready and not g.ready():
                return False
            self._in_flight.popleft()
            self._resolving += 1
        try:
            self._resolve_group(g)
        finally:
            with self._cv:
                self._resolving -= 1
                self._cv.notify_all()
        return True

    def _resolve_group(self, g: _InFlightGroup) -> None:
        """Completion stage: the single host sync for one dispatched group.

        The event wait runs outside the service lock.  The deferred
        LRU-touch meta lands only if the table version is unchanged since
        launch — a racing append or eviction wins.
        """
        if g.event is not None:
            with obs.span("am.driver.readback"):
                g.event.synchronize()
        idx, dist, exact, matched, count, overflow, frac = (
            None if a is None else a.numpy() for a in g.host)
        with obs.span("am.driver.resolve"), self._cv:
            t = g.table
            if self._tables.get(t.name) is t and t.version == g.version:
                t.table = dataclasses.replace(t.table, meta=g.new_meta)
            if frac is not None:
                t.index_lookups += len(g.futs)
                t.index_groups += 1
                t.index_frac_sum += float(frac)
            self.readbacks += 1
            done_at = self._now()
            for fut, slot in zip(g.futs, g.slot_of):
                hit = bool(exact[slot, 0])
                if hit:
                    t.hits += 1
                else:
                    t.misses += 1
                fut._resolve(SearchResponse(
                    rid=fut.request.rid, table=t.name, indices=idx[slot],
                    distances=dist[slot], exact=exact[slot],
                    matched=matched[slot],
                    value=g.values[int(idx[slot, 0])] if hit else None,
                    match_count=(None if count is None
                                 else int(count[slot])),
                    overflow=(None if overflow is None
                              else bool(overflow[slot]))))
            self._waits.add([done_at - fut.request.submitted_at
                             for fut in g.futs])
            self._cv.notify_all()

    # -- driver lifecycle ----------------------------------------------------

    def start_driver(self, *, max_in_flight: int = 2,
                     poll_interval: float = 1e-3) -> "AMDriver":
        """Start a background :class:`AMDriver` thread; returns it."""
        if self._driver is not None and self._driver.is_alive():
            raise RuntimeError("a driver is already running")
        if self.flush_after is not None and self._time_fn is None:
            raise ValueError(
                "a background driver cannot own a flush_after deadline on "
                "the logical clock (it never advances between submits); "
                "construct AMService with time_fn=time.monotonic")
        drv = AMDriver(self, max_in_flight=max_in_flight,
                       poll_interval=poll_interval)
        self._driver = drv
        drv.start()
        return drv

    def stop_driver(self, *, drain: bool = True,
                    timeout: float = 10.0) -> "AMDriver | None":
        """Stop the background driver (draining first by default)."""
        drv, self._driver = self._driver, None
        if drv is not None:
            drv.stop(drain=drain, timeout=timeout)
        return drv

    def close(self) -> None:
        """Drain and stop any running driver; the sync path stays usable."""
        self.stop_driver(drain=True)

    @staticmethod
    def _dispatch(table: am.AMTable, queries, n_valid: int, q_valid: int,
                  thresholds, now: float, *, k: int, backend: str,
                  matches: int | None, index=None, probes: int = 0,
                  mesh=None, rules=None, merge: str = "auto"):
        """One search over a padded bucket, plus the LRU touch of its hits.

        With an ``index`` the search is :func:`ivf.search` at ``probes``;
        with a ``mesh`` the sharded variant of each search runs.
        Returns (idx, dist, exact, matched, count, overflow, frac,
        new_meta); ``count`` and ``overflow`` are None unless ``matches``
        is set, ``frac`` (the mean candidate fraction of the real queries)
        unless ``index`` is.
        """
        thr = None if thresholds is None else thresholds[:, None]
        count = overflow = frac = None
        placed = ({} if mesh is None
                  else {"mesh": mesh, "rules": rules, "merge": merge})
        search = am.search if mesh is None else am.search_sharded
        if matches is not None:
            res = search(table, queries, matches=matches, threshold=thr,
                         backend=backend, valid_rows=n_valid, **placed)
            count, overflow = res.match_count, res.overflow
            top = res.priority_index
        elif index is not None:
            # coarse-rank the centroids, fine-search only the probed sets'
            # slabs; the index holds exactly the live rows
            isearch = ivf.search if mesh is None else ivf.search_sharded
            r = isearch(index, queries, k=k, probes=probes, threshold=thr,
                        backend=backend, **placed)
            res = r.result
            live_q = torch.arange(queries.shape[0], device=queries.device) \
                < q_valid
            frac = (torch.where(live_q, r.candidate_fraction, 0.0).sum()
                    / max(q_valid, 1)).to(torch.float32)
            top = res.best_row
        else:
            res = search(table, queries, k=k, threshold=thr,
                         backend=backend, valid_rows=n_valid, **placed)
            top = res.best_row
        # exact best-row hits of real (non-padding) queries get their
        # last-hit stamped; n_rows is touch()'s "no row" sentinel
        q_live = torch.arange(queries.shape[0], device=queries.device) \
            < q_valid
        hit_rows = torch.where(q_live & res.exact[:, 0], top, table.n_rows)
        meta = am.touch(table, hit_rows, now).meta
        idx = torch.where(torch.isfinite(res.distances), res.indices, -1)
        dist, exact, matched = res.distances, res.exact, res.matched
        pad = (k if matches is None else matches) - idx.shape[1]
        if pad > 0:
            # an indexed search clamps k to its total slab capacity, which
            # can sit below a partly filled table's capacity; pad back out
            # so the response width holds
            idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
            dist = torch.nn.functional.pad(dist, (0, pad), value=torch.inf)
            exact = torch.nn.functional.pad(exact, (0, pad))
            matched = torch.nn.functional.pad(matched, (0, pad))
        return idx, dist, exact, matched, count, overflow, frac, meta

    # -- stats ---------------------------------------------------------------

    def stats(self, name: str | None = None) -> dict:
        """Service-level (or one table's) observability counters.

        Queue-wait percentiles are over every lookup resolved since the
        service started, in clock units (:class:`WaitHistogram`: exact up
        to 4,096 lookups, within one 2.33 % bucket past that).
        """
        with self._lock:
            if name is not None:
                t = self._state(name)
                return {
                    "rows": t.n, "capacity": t.capacity, "policy": t.policy,
                    "ttl": t.ttl, "backend": t.backend, "version": t.version,
                    "appends": t.appends, "evicted": t.evicted,
                    "hits": t.hits, "misses": t.misses,
                    "lookups": t.hits + t.misses,
                    "queued": t.queued,
                    "admission": t.admission,
                    "qps_budget": t.qps_budget, "max_queue": t.max_queue,
                    "rejected": t.rejected, "shed": t.shed,
                    "blocked": t.blocked,
                    "buckets": dict(t.buckets),
                    "index": None if t.index_spec is None else {
                        "sets": t.index_spec.sets,
                        "probes": t.index_spec.probes,
                        "built": t.index is not None,
                        "builds": t.index_builds,
                        "lookups": t.index_lookups,
                        "candidate_fraction":
                            t.index_frac_sum / max(1, t.index_groups),
                    },
                }
            p50, p99 = self._waits.percentiles([50, 99])
            drv = self._driver
            return {
                "tables": {n: self.stats(n) for n in self._tables},
                "pending": len(self._pending),
                "queue_depth": len(self._pending),
                "in_flight": len(self._in_flight),
                "flushes": self.flushes,
                "readbacks": self.readbacks,
                "dedup_hits": self.dedup_hits,
                "dedup_rate": self.dedup_hits / max(1, self.dispatched),
                "fused_fallbacks": self.fused_fallbacks,
                "compilations": len(self._signatures),
                "sharded": self._mesh is not None,
                "merge": self._merge,
                "driver": drv.state if drv is not None else None,
                "admission": {
                    "rejected": sum(t.rejected for t in
                                    self._tables.values()),
                    "shed": sum(t.shed for t in self._tables.values()),
                    "blocked": sum(t.blocked for t in
                                   self._tables.values()),
                },
                "index": {
                    "tables": sum(1 for t in self._tables.values()
                                  if t.index_spec is not None),
                    "built": sum(1 for t in self._tables.values()
                                 if t.index is not None),
                    "builds": sum(t.index_builds
                                  for t in self._tables.values()),
                    "lookups": sum(t.index_lookups
                                   for t in self._tables.values()),
                    "candidate_fraction":
                        sum(t.index_frac_sum for t in self._tables.values())
                        / max(1, sum(t.index_groups
                                     for t in self._tables.values())),
                },
                "queue_wait_p50": float(p50),
                "queue_wait_p99": float(p99),
            }


# ---------------------------------------------------------------------------
# The pipelined dispatch driver
# ---------------------------------------------------------------------------

class AMDriver:
    """Pipelined dispatch driver for one :class:`AMService`.

    Owns the flush deadline and overlaps the pipeline's three stages — host
    batching, device compute (up to ``max_in_flight`` dispatched groups)
    and readback (one event wait per group, retired in dispatch order).
    Step :meth:`run_once` by hand for deterministic tests, or start the
    background thread with :meth:`AMService.start_driver`; that thread
    launches the kernels on its own current stream.
    """

    def __init__(self, service: AMService, *, max_in_flight: int = 2,
                 poll_interval: float = 1e-3):
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self._service = service
        self.max_in_flight = max_in_flight
        self.poll_interval = poll_interval
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self.state = "idle"
        self.exception: BaseException | None = None

    def run_once(self, *, now: float | None = None,
                 force: bool = False) -> dict[str, int]:
        """One driver step: dispatch due work, then retire finished groups.

        Returns ``{"launched": lookups dispatched, "completed": groups
        retired}``.
        """
        svc = self._service
        launched = 0
        with svc._lock:
            force = force or svc._drain_req
            t_now = svc._now() if now is None else float(now)
            if svc._pending and (force
                                 or len(svc._pending) >= svc.max_batch
                                 or svc._deadline_due(t_now)):
                launched = svc._launch_pending(t_now)
        completed = 0
        while True:
            with svc._lock:
                over = (force or svc._drain_req
                        or len(svc._in_flight) > self.max_in_flight)
            if not svc._complete_next(only_ready=not over):
                break
            completed += 1
        return {"launched": launched, "completed": completed}

    # -- thread lifecycle ----------------------------------------------------

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "AMDriver":
        if self.is_alive():
            raise RuntimeError("driver already running")
        self._stop_evt.clear()
        self.exception = None
        self.state = "running"
        self._thread = threading.Thread(target=self._loop, name="am-driver",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the background thread; with ``drain`` retire all work first."""
        if self._thread is not None and self._thread.is_alive():
            if drain:
                self.state = "draining"
                self._service.drain(timeout)
            self._stop_evt.set()
            self._wake.set()
            self._thread.join(timeout)
        self.state = "stopped"

    def __enter__(self) -> "AMDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        try:
            while not self._stop_evt.is_set():
                r = self.run_once()
                if not r["launched"] and not r["completed"]:
                    self._wake.wait(self.poll_interval)
                    self._wake.clear()
        except BaseException as e:               # pragma: no cover - safety
            self.exception = e
            self.state = "stopped"
            with self._service._cv:
                self._service._cv.notify_all()

"""Serving API for associative search — the CAM as a service, on one device.

Port of the single-device part of :mod:`repro.serve.am_service`:

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
* **Admission control**, **cross-request dedup**, **ternary tables** and
  **multi-match lookups**, **LRU/TTL/reject eviction** and the logical or
  wall **clock** behave exactly as in the reference (see its module
  docstring).

Not yet ported: ``mesh=`` (multi-bank sharding, slice 9), ``index=`` (the
IVF tier, slice 8) and ``snapshot``/``restore`` (durability, slice 10)
raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import am
from repro_torch.device import resolve_device

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

#: Resolved queue-wait samples kept for the stats() percentiles.
_WAIT_SAMPLES = 4096


class TableFullError(RuntimeError):
    """An append would exceed capacity and the policy forbids eviction."""


class AdmissionError(RuntimeError):
    """A submit was refused by admission control (budget or queue cap)."""


def _not_ported(what: str, slice_no: int, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; it comes with port slice "
        f"{slice_no} ({name})")


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
    #                                 overflow); the last two are None
    #                                 unless the group is multi-match
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
      mesh: not ported yet (slice 9); must be None.
      max_batch: queued lookups that trigger an automatic flush.
      flush_after: deadline in clock units on the oldest queued request; as
        an idle deadline it needs a real clock (``time_fn``) and a driver.
      time_fn: clock source; ``None`` uses a deterministic logical tick
        (+1.0 per submit/append/flush).
      device: where every table lives; ``None`` means the GPU and raises
        when there is none.
    """

    def __init__(self, *, mesh=None, max_batch: int = 64,
                 flush_after: float | None = None,
                 time_fn: Callable[[], float] | None = None, device=None):
        if mesh is not None:
            raise _not_ported("AMService(mesh=...)", 9, "multi-bank sharding")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if flush_after is not None and time_fn is None:
            warnings.warn(
                "AMService(flush_after=...) with the default logical clock "
                "only observes the deadline at submit time: an idle "
                "half-full bucket never auto-flushes.  Pass "
                "time_fn=time.monotonic and run svc.start_driver() for a "
                "live idle deadline.", RuntimeWarning, stacklevel=2)
        self.device = resolve_device(device)
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
        self._wait_samples: collections.deque[float] = \
            collections.deque(maxlen=_WAIT_SAMPLES)
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
                     index=None,
                     ternary: bool = False) -> None:
        """Allocate an empty capacity-bounded table under ``name``.

        Admission control (all optional): ``qps_budget`` is a sustained
        lookups-per-clock-unit token bucket (depth ``burst``, default
        ``max(1, qps_budget)``), ``max_queue`` caps this table's queued
        lookups, and ``admission`` picks the over-budget behaviour.
        ``ternary`` allocates a care-mask plane beside the code slab (a
        masked backend required).  ``index`` is not ported yet (slice 8).
        """
        if index is not None:
            raise _not_ported("create_table(index=...)", 8, "the IVF index")
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
        am.get_backend(backend)          # fail fast on unknown backends
        if ternary and "masked" not in am.backend_capabilities(backend):
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
                admission=admission, tokens=burst, tokens_at=self._now())

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
            rows = slice(t.n, t.n + m)
            t.table.codes[rows] = _to_device(codes, self.device)
            t.table.meta[rows] = now
            if t.table.care is not None:
                t.table.care[rows] = _to_device(
                    (care != 0).astype(np.int32), self.device)
            t.values.extend(values)
            t.n += m
            t.appends += m
            t.version += 1

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

    # -- durability: not ported yet ------------------------------------------

    def snapshot(self, directory, **kwargs) -> int:
        """Not ported yet: durable snapshots come with port slice 10."""
        raise _not_ported("AMService.snapshot", 10, "durability")

    @classmethod
    def restore(cls, directory, **kwargs) -> "AMService":
        """Not ported yet: warm restarts come with port slice 10."""
        raise _not_ported("AMService.restore", 10, "durability")

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
            self._launch_group(self._state(name), futs, k, backend, has_thr,
                               matches, now)
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
        tab = t.table
        self._signatures.add((qb, k, backend, has_thr, matches,
                              tuple(tab.codes.shape), tab.bits, tab.distance,
                              tab.care is not None))
        # am.search counts each dense-tier fallback of a fused backend; the
        # lock serialises this service's dispatches, so the delta is this
        # group's unless another thread searches at the same moment
        before = am.fused_fallbacks()
        out = self._dispatch(tab, _to_device(queries, self.device), t.n, q,
                             thr, now, k=k, backend=backend, matches=matches)
        self.fused_fallbacks += am.fused_fallbacks() - before
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
            g.event.synchronize()
        idx, dist, exact, matched, count, overflow = (
            None if a is None else a.numpy() for a in g.host)
        with self._cv:
            t = g.table
            if self._tables.get(t.name) is t and t.version == g.version:
                t.table = dataclasses.replace(t.table, meta=g.new_meta)
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
                self._wait_samples.append(
                    done_at - fut.request.submitted_at)
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
                  matches: int | None):
        """One search over a padded bucket, plus the LRU touch of its hits.

        Returns (idx, dist, exact, matched, count, overflow, new_meta);
        ``count`` and ``overflow`` are None unless ``matches`` is set.
        """
        thr = None if thresholds is None else thresholds[:, None]
        count = overflow = None
        if matches is not None:
            res = am.search(table, queries, matches=matches, threshold=thr,
                            backend=backend, valid_rows=n_valid)
            count, overflow = res.match_count, res.overflow
            top = res.priority_index
        else:
            res = am.search(table, queries, k=k, threshold=thr,
                            backend=backend, valid_rows=n_valid)
            top = res.best_row
        # exact best-row hits of real (non-padding) queries get their
        # last-hit stamped; n_rows is touch()'s "no row" sentinel
        q_live = torch.arange(queries.shape[0], device=queries.device) \
            < q_valid
        hit_rows = torch.where(q_live & res.exact[:, 0], top, table.n_rows)
        meta = am.touch(table, hit_rows, now).meta
        idx = torch.where(torch.isfinite(res.distances), res.indices, -1)
        return (idx, res.distances, res.exact, res.matched, count, overflow,
                meta)

    # -- stats ---------------------------------------------------------------

    def stats(self, name: str | None = None) -> dict:
        """Service-level (or one table's) observability counters.

        Queue-wait percentiles are over the last ``_WAIT_SAMPLES`` resolved
        lookups, in clock units.
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
                }
            waits = np.asarray(self._wait_samples, np.float64)
            p50, p99 = (np.percentile(waits, [50, 99]) if waits.size
                        else (0.0, 0.0))
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
                "driver": drv.state if drv is not None else None,
                "admission": {
                    "rejected": sum(t.rejected for t in
                                    self._tables.values()),
                    "shed": sum(t.shed for t in self._tables.values()),
                    "blocked": sum(t.blocked for t in
                                   self._tables.values()),
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

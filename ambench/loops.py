"""The client: a closed, an open or a batch loop of lookups, timed from
its side.

The closed and open loops send single lookups to a ``system`` with
``submit(key) -> handle``, ``done(handle) -> bool`` and ``wait(handle,
timeout) -> answer``; the batch loop sends batches to one with
``search(keys) -> handle``, ``done(handle)``, ``answers(handle) -> arrays``
and ``unpack(arrays) -> [answer]``.  Each runs the set-up's share of the
traffic first, then calls ``hooks.open()`` and measures;
``hooks.close_slice()`` is called once the traced slice (the window's
first ``slice_s`` seconds) has passed.  The window's lookups are offered
to ``sample``, a seeded reservoir of (key, answer) pairs (of whole batches
in the batch loop) that the reference checks afterwards; an answer that
raises or never comes is counted as failed and offered as None.

One thread sends and collects.  In the window it takes an answer only once
the system says it is done, so the client never forces a dispatch: how
single lookups are grouped is the system's own (its batch size, its flush
deadline and its driver), as it would be for callers in other processes.
When nothing is due and nothing is answered, the client sleeps ``POLL_S``.
"""

from __future__ import annotations

import collections
import time

import numpy as np

#: Seconds to wait for one answer, a minute past the close at the most.
ANSWER_TIMEOUT_S = 60.0
#: Seconds the client sleeps when nothing is due and nothing is answered.
POLL_S = 2e-4
#: Seconds after a traced slice's close before lookups are untouched by it.
SETTLE_S = 5.0


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng(seed)
        self._u = self._rng.random(1 << 16)
        self._at = 0

    def offer(self, item) -> None:
        n = self.seen
        self.seen += 1
        if n < self.size:
            self.items.append(item)
            return
        if self._at == self._u.size:
            self._u, self._at = self._rng.random(1 << 16), 0
        j = int(self._u[self._at] * (n + 1))
        self._at += 1
        if j < self.size:
            self.items[j] = item


class Hooks:
    """What the loops call at the window's edges; the default does nothing."""

    def open(self) -> None:
        """The window starts right after this returns."""

    def close_slice(self) -> None:
        """The traced slice has passed."""

    def span(self, name: str):
        """A context around a blocking wait (a span when tracing)."""
        return _NO_SPAN


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _answer(system, handle, timeout: float = ANSWER_TIMEOUT_S):
    """The handle's answer, or None where it raised or never came."""
    try:
        return system.wait(handle, timeout)
    except Exception:                      # the run counts it as failed
        return None


def _idle(hooks: Hooks, seconds: float) -> None:
    with hooks.span("ambench.idle"):
        time.sleep(seconds)


def closed(system, keys, *, outstanding: int, warmup: int, seconds: float,
           slice_s: float, sample: Reservoir, hooks: Hooks) -> dict:
    """``outstanding`` lookups in flight; each answered one is replaced by
    a new one.  Throughput counts the lookups answered inside the window;
    those in flight at its close are drained.  ``per_s`` counts the
    window's answers second by second."""
    fifo = collections.deque()
    for _ in range(outstanding):
        key = keys.next()
        fifo.append((key, system.submit(key)))
    answered = 0
    while answered < warmup:
        if not system.done(fifo[0][1]):
            _idle(hooks, POLL_S)
            continue
        _answer(system, fifo.popleft()[1])
        answered += 1
        key = keys.next()
        fifo.append((key, system.submit(key)))
    hooks.open()
    t0 = time.perf_counter()
    end, slice_end = t0 + seconds, t0 + min(seconds, slice_s)
    per_s = [0] * int(np.ceil(seconds))
    completed = failed = 0
    in_slice = None
    while True:
        now = time.perf_counter()
        if in_slice is None and now >= slice_end:
            in_slice = completed
            hooks.close_slice()
        if now >= end:
            break
        if not system.done(fifo[0][1]):
            _idle(hooks, POLL_S)
            continue
        key, h = fifo.popleft()
        a = _answer(system, h)
        completed += 1
        per_s[int(now - t0)] += 1
        failed += a is None
        sample.offer((key, a))
        key = keys.next()
        fifo.append((key, system.submit(key)))
    attempted = completed + len(fifo)
    for key, h in fifo:
        a = _answer(system, h)
        failed += a is None
        sample.offer((key, a))
    return {"window_s": seconds, "completed": completed,
            "slice_completed": in_slice, "attempted": attempted,
            "failed": failed, "per_s": per_s}


def open_(system, due: np.ndarray, keys: np.ndarray, *, seconds: float,
          slice_s: float, sample: Reservoir, hooks: Hooks) -> dict:
    """Lookups sent at their due times (offsets in seconds) whatever the
    backlog, and collected as they are answered.  Each is timed from when
    it was due to when the client saw it answered; how late the client
    sent it is kept too.  Lookups unanswered a minute past the close are
    failed.  ``after_slice`` is the first lookup due ``SETTLE_S`` after a
    traced slice closed (0 where none was traced): the profiler's stop
    stalls the loop, and the lookups from there on were neither traced nor
    held up by it or by the backlog it left."""
    n = due.size
    lag = np.zeros(n)
    latency = np.zeros(n)
    handles: list = [None] * n
    failed = sent = got = 0
    in_slice = None
    hooks.open()
    t0 = time.perf_counter()
    slice_end = t0 + min(seconds, slice_s)
    give_up = t0 + seconds + ANSWER_TIMEOUT_S
    while got < n:
        now = time.perf_counter()
        busy = False
        while sent < n and t0 + due[sent] <= now:
            lag[sent] = now - (t0 + due[sent])
            try:
                handles[sent] = system.submit(int(keys[sent]))
            except Exception:              # counted as failed below
                handles[sent] = None
            sent += 1
            busy = True
            now = time.perf_counter()
        while got < sent and (handles[got] is None
                              or system.done(handles[got])):
            h = handles[got]
            a = None if h is None else _answer(system, h)
            latency[got] = now - (t0 + due[got])
            failed += a is None
            sample.offer((int(keys[got]), a))
            handles[got] = None
            got += 1
            busy = True
        if in_slice is None and now >= slice_end:
            in_slice = int(np.searchsorted(due, slice_end - t0))
            hooks.close_slice()
            after = 0 if slice_s >= seconds else int(np.searchsorted(
                due, time.perf_counter() - t0 + SETTLE_S))
        if now >= give_up:
            for i in range(got, n):
                latency[i] = now - (t0 + due[i])
                a = None if handles[i] is None else _answer(system,
                                                            handles[i], 0.0)
                failed += a is None
                sample.offer((int(keys[i]), a))
            break
        if not busy:
            wait = POLL_S if sent == n else min(POLL_S,
                                                t0 + due[sent] - now)
            if wait > 0:
                _idle(hooks, wait)
    if in_slice is None:
        in_slice, after = n, 0
        hooks.close_slice()
    return {"window_s": seconds, "completed": n, "attempted": n,
            "failed": failed, "latency_s": latency, "gen_lag_s": lag,
            "slice_completed": in_slice, "after_slice": after}


def batch(system, keys, *, size: int, in_flight: int, warmup: int,
          seconds: float, slice_s: float, sample: Reservoir,
          hooks: Hooks) -> dict:
    """``in_flight`` batches of ``size`` lookups launched; each answered
    batch is read back whole and replaced by a new one.  Throughput counts
    the lookups of the batches answered inside the window; those in flight
    at its close are drained.  ``sample`` draws whole batches; the
    returned ``items`` are their (key, answer) pairs."""
    fifo = collections.deque()

    def send():
        k = keys.draw(size)
        fifo.append((k, system.search(k)))

    def take(k, h) -> int:
        """Read one batch back and offer it; its failed lookups."""
        try:
            arrays = system.answers(h)
        except Exception:                  # the run counts them as failed
            arrays = None
        sample.offer((k, arrays))
        return size if arrays is None else 0

    for _ in range(in_flight):
        send()
    for _ in range(warmup):
        system.answers(fifo.popleft()[1])
        send()
    hooks.open()
    t0 = time.perf_counter()
    end, slice_end = t0 + seconds, t0 + min(seconds, slice_s)
    per_s = [0] * int(np.ceil(seconds))
    completed = failed = 0
    in_slice = None
    while True:
        now = time.perf_counter()
        if in_slice is None and now >= slice_end:
            in_slice = completed
            hooks.close_slice()
        if now >= end:
            break
        if not system.done(fifo[0][1]):
            _idle(hooks, POLL_S)
            continue
        failed += take(*fifo.popleft())
        completed += size
        per_s[int(now - t0)] += size
        send()
    attempted = completed + size * len(fifo)
    while fifo:
        failed += take(*fifo.popleft())
    items = []
    for k, arrays in sample.items:
        rows = [None] * size if arrays is None else system.unpack(arrays)
        items.extend(zip(k.tolist(), rows))
    return {"window_s": seconds, "completed": completed,
            "slice_completed": in_slice, "attempted": attempted,
            "failed": failed, "per_s": per_s, "items": items}

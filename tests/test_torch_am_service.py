"""The port's slice as a whole: repro_torch's AMService against repro's.

One script of ``create_table`` / ``append`` / ``submit`` / ``flush`` /
eviction / ``delete`` traffic runs, under the logical clock, through the
reference ``AMService`` (``backend="pallas"``, interpret mode, plus a
``"ref"`` table) and through the port's service on the CPU.  Every
``SearchResponse`` and the counters (hits, misses, dedup, readbacks,
compilations, evictions) must agree exactly.  The port's pipelined driver
must agree with its own synchronous ``flush()``.

Tolerance: bitwise for every response array and equality for counters.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.serve.am_service import AMService as JaxService
from repro_torch.serve import AMDriver, AMService, TableFullError

torch.set_num_threads(2)

WIDTH = 8


def _port(**kw):
    return AMService(device="cpu", **kw)


def _script(svc, kernel_backend):
    """Drive one service; returns everything observable, in order."""
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 8, (64, WIDTH)).astype(np.int32)
    svc.create_table("lru", width=WIDTH, bits=3, capacity=12, policy="lru",
                     backend=kernel_backend)
    svc.create_table("ttl", width=WIDTH, bits=3, distance="l1", capacity=10,
                     policy="ttl", ttl=6.0, backend="ref")
    svc.create_table("tcam", width=WIDTH, bits=3, capacity=16,
                     policy="reject", backend=kernel_backend, ternary=True)
    care = np.ones((8, WIDTH), np.int32)
    care[4:, WIDTH // 2:] = 0                         # wildcard tails
    svc.append("tcam", np.concatenate([pool[:4], pool[:4]]), care=care,
               values=list(range(8)))
    svc.append("lru", pool[:8], values=[f"v{i}" for i in range(8)])
    svc.append("ttl", pool[8:14], values=list(range(6)))
    futs = []
    for step in range(36):
        name = ("lru", "ttl", "tcam")[step % 3]
        r = rng.random()
        q = pool[rng.integers(0, 20)] if r < 0.7 else \
            rng.integers(0, 8, WIDTH).astype(np.int32)
        if name == "tcam":
            q = q.copy()
            if r < 0.5:
                q[WIDTH // 2:] = rng.integers(0, 8, WIDTH // 2)
            futs.append(svc.submit(name, q, matches=3,
                                   threshold=None if r < 0.6 else 1.0))
        else:
            futs.append(svc.submit(name, q, k=int(rng.choice([1, 3])),
                                   threshold=None if r < 0.5 else 5.0))
        if step % 4 == 3:
            futs.append(svc.submit(name, q, k=1) if name != "tcam"
                        else svc.submit(name, q, matches=3))   # dedup
        if step % 7 == 6:
            svc.flush()
        if step % 9 == 8:
            svc.append("lru", pool[20 + step:23 + step],
                       values=[step, step + 1, step + 2])      # evicts
        if step == 20:
            svc.evict("ttl")
            svc.delete("lru", [0, 2])
    svc.flush()
    out = []
    for f in futs:
        x = f.result()
        out.append((x.rid, x.table, x.indices.tolist(), x.distances.tolist(),
                    x.exact.tolist(), x.matched.tolist(), x.value,
                    x.admitted, x.match_count, x.overflow))
        assert x.indices.dtype == np.int32
        assert x.distances.dtype == np.float32
    s = svc.stats()
    out.append({k: s[k] for k in ("flushes", "readbacks", "dedup_hits",
                                  "dedup_rate", "fused_fallbacks",
                                  "compilations", "queue_wait_p50",
                                  "queue_wait_p99", "pending")})
    for name, ts in sorted(s["tables"].items()):
        out.append((name, {k: ts[k] for k in (
            "rows", "capacity", "version", "appends", "evicted", "hits",
            "misses", "lookups", "queued")}))
    return out


def test_service_script_matches_reference():
    want = _script(JaxService(), "pallas")
    got = _script(_port(), "cuda")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_admission_modes_match_reference():
    def run(svc, backend):
        svc.create_table("t", width=WIDTH, capacity=8, backend=backend,
                         qps_budget=0.5, burst=2, admission="shed")
        svc.create_table("u", width=WIDTH, capacity=8, backend=backend,
                         max_queue=2, admission="reject")
        rows = np.arange(4 * WIDTH, dtype=np.int32).reshape(4, WIDTH) % 8
        svc.append("t", rows)
        svc.append("u", rows)
        out = []
        for i in range(6):
            r = svc.submit("t", rows[i % 4])
            out.append((r.done, r.result().admitted, r.result().hit))
        for i in range(3):
            try:
                svc.submit("u", rows[i])
                out.append("queued")
            except Exception as e:           # compare the error types
                out.append(type(e).__name__)
        svc.flush()
        s = svc.stats()
        out.append(s["admission"])
        return out

    assert run(_port(), "ref") == run(JaxService(), "ref")


def test_fused_fallbacks_match_reference():
    """Windows above FUSED_K_MAX take the dense tier; the service counts
    each such group as the reference does (ternary multi-match included)."""
    def run(svc):
        rng = np.random.default_rng(5)
        codes = rng.integers(0, 8, (300, WIDTH)).astype(np.int32)
        svc.create_table("t", width=WIDTH, bits=3, capacity=320,
                         backend="cuda" if isinstance(svc, AMService)
                         else "pallas")
        svc.create_table("tc", width=WIDTH, bits=3, capacity=320,
                         ternary=True, backend="cuda"
                         if isinstance(svc, AMService) else "pallas")
        svc.append("t", codes)
        svc.append("tc", codes, care=np.ones_like(codes))
        out = []
        for k, m in ((10, None), (257, None), (300, None), (None, 256),
                     (None, 290)):
            for q in codes[:2]:
                if m is None:
                    svc.submit("t", q, k=k)
                else:
                    svc.submit("tc", q, matches=m)
            svc.flush()
            out.append(svc.stats()["fused_fallbacks"])
        return out

    got, want = run(_port()), run(JaxService())
    assert got == want == [0, 1, 2, 2, 3]


def test_bucket_counts():
    """stats(name)["buckets"] counts dispatched groups by padded size."""
    svc = _port()
    svc.create_table("t", width=WIDTH, bits=3, capacity=16, backend="cuda")
    svc.append("t", np.arange(4 * WIDTH).reshape(4, WIDTH) % 8)
    for n in (3, 4, 1, 5):
        for i in range(n):
            svc.submit("t", np.full((WIDTH,), i % 8))
        svc.flush()
    assert svc.stats("t")["buckets"] == {4: 2, 1: 1, 8: 1}


def test_one_signature_per_bucket():
    """The port counts dispatch signatures as the reference counts jit
    compilations (tests/test_am_service.py's sequence, same numbers)."""
    rng = np.random.default_rng(4)
    svc = _port()
    svc.create_table("t", width=6, bits=3, capacity=64, backend="cuda")
    svc.append("t", rng.integers(0, 8, (20, 6)), values=list(range(20)))

    def flush_n(n, k=1):
        for _ in range(n):
            svc.submit("t", rng.integers(0, 8, (6,)), k=k)
        svc.flush()

    assert svc.stats()["compilations"] == 0
    seq = [(3, 1, 1), (4, 1, 1), (2, 1, 2), (4, 1, 2), (5, 1, 3), (4, 2, 4),
           (4, 2, 4)]
    for i, (n, k, want) in enumerate(seq):
        if i == 2:
            svc.append("t", rng.integers(0, 8, (5, 6)))   # no new signature
        flush_n(n, k)
        assert svc.stats()["compilations"] == want


def _traffic(svc, step, settle, clock):
    """Interleaved submits and appends on a fake wall clock.

    ``step`` dispatches queued work (maybe leaving it in flight while more
    submits arrive); ``settle`` retires everything, and runs before every
    append so LRU touches land identically on both paths.
    """
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 8, (40, WIDTH)).astype(np.int32)
    svc.create_table("t", width=WIDTH, capacity=16, policy="lru",
                     backend="cuda")
    svc.append("t", pool[:10], values=list(range(10)))
    futs = []
    for i in range(48):
        clock[0] += 1.0
        q = pool[rng.integers(0, 24)]
        futs.append(svc.submit("t", q, k=int(rng.choice([1, 2])),
                               threshold=None if i % 2 else 3.0))
        if i % 5 == 4:
            step()
        if i % 11 == 10:
            settle()
            svc.append("t", pool[10 + i // 11:12 + i // 11])   # evicts late
    settle()
    return [(f.result().indices.tolist(), f.result().distances.tolist(),
             f.result().exact.tolist(), f.result().matched.tolist(),
             f.result().value) for f in futs]


def test_driver_matches_sync_flush():
    c_sync, c_piped = [0.0], [0.0]
    sync = _port(time_fn=lambda: c_sync[0])
    want = _traffic(sync, sync.flush, sync.flush, c_sync)

    piped = _port(time_fn=lambda: c_piped[0])
    drv = AMDriver(piped, max_in_flight=2)
    calls = [0]

    def step():                        # alternately: launch only / retire
        calls[0] += 1
        if calls[0] % 2:
            with piped._lock:
                piped._launch_pending(piped._now())
            assert piped.stats()["in_flight"] >= 1
        else:
            drv.run_once(force=True)

    got = _traffic(piped, step, lambda: drv.run_once(force=True), c_piped)
    assert got == want
    for key in ("readbacks", "compilations", "dedup_hits"):
        assert piped.stats()[key] == sync.stats()[key], key
    assert piped.stats("t") == sync.stats("t")


def test_background_driver_thread_resolves_and_stops():
    svc = _port(time_fn=time.monotonic, flush_after=0.01, max_batch=8)
    svc.create_table("t", width=WIDTH, capacity=32, backend="cuda")
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 8, (20, WIDTH)).astype(np.int32)
    svc.append("t", codes, values=list(range(20)))
    before = set(threading.enumerate())
    drv = svc.start_driver(max_in_flight=2)
    try:
        futs = [svc.submit("t", codes[i % 20]) for i in range(50)]
        for i, f in enumerate(futs):
            r = f.result(timeout=30)
            assert r.hit and r.value == i % 20
        assert svc.drain(timeout=30)
    finally:
        svc.stop_driver()
    assert drv.state == "stopped" and not drv.is_alive()
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


def test_capacity_bound_and_reject_policy():
    svc = _port()
    svc.create_table("r", width=4, capacity=3, policy="reject")
    svc.append("r", np.zeros((3, 4), np.int32))
    with pytest.raises(TableFullError):
        svc.append("r", np.ones((1, 4), np.int32))
    with pytest.raises(ValueError, match="unknown backend"):
        svc.create_table("x", width=4, backend="analog_mc")
    assert svc.stats("r")["rows"] == 3


def test_wait_histogram_is_exact_then_within_a_bucket():
    from repro_torch.serve.am_service import _EXACT_WAITS, WaitHistogram

    rng = np.random.default_rng(5)
    h = WaitHistogram()
    assert h.percentiles([50, 99]) == [0.0, 0.0]
    waits = np.concatenate([np.zeros(10), rng.lognormal(-6, 2, 3000)])
    h.add(waits[:1000])
    h.add(waits[1000:])
    assert h.percentiles([1, 50, 99]) == np.percentile(
        waits, [1, 50, 99]).tolist()
    more = rng.lognormal(-3, 1, 2 * _EXACT_WAITS)
    h.add(more)
    every = np.concatenate([waits, more])
    assert h.n == every.size
    step = 10 ** (1 / WaitHistogram.BUCKETS_PER_DECADE)
    for q, got in zip((50, 90, 99), h.percentiles([50, 90, 99])):
        want = np.percentile(every, q)
        assert want / step <= got <= want * step, (q, got, want)
    assert h.percentiles([0]) == [0.0]              # the zero waits
    h.add([2e9])
    assert h.percentiles([100]) == [WaitHistogram.HIGH]
    h.clear()
    assert h.n == 0 and h.percentiles([99]) == [0.0]


def test_port_queue_wait_percentiles_cover_every_lookup():
    """``stats()`` holds the queue waits of every resolved lookup, where
    the reference keeps the last 4,096: 6,000 lookups, the earliest of
    which waited longest, read p50 and p99 within one bucket of NumPy's
    over all 6,000."""
    from repro_torch.serve.am_service import WaitHistogram

    rng = np.random.default_rng(31)
    now = [0.0]
    svc = _port(time_fn=lambda: now[0], max_batch=1 << 20)
    svc.create_table("t", width=WIDTH, capacity=16)
    rows = rng.integers(0, 8, (16, WIDTH)).astype(np.int32)
    svc.append("t", rows)
    submitted = np.sort(rng.uniform(1.0, 1000.0, 6000))
    for i, t in enumerate(submitted):
        now[0] = t
        svc.submit("t", rows[i % 16])
    now[0] = 1000.5
    svc.flush()
    s = svc.stats()
    assert s["readbacks"] == 1
    step = 10 ** (1 / WaitHistogram.BUCKETS_PER_DECADE)
    waits = now[0] - submitted
    for q in (50, 99):
        want = np.percentile(waits, q)
        got = s[f"queue_wait_p{q}"]
        assert want / step <= got <= want * step, (q, got, want)

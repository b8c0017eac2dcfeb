"""AMService under a Zipfian lookup workload: hit-rate + latency vs capacity.

Port of ``benchmarks/bench_am_serve.py``, with its three sweeps, on the
port's service (the CUDA kernels on the card by default).  The serving
claim behind the paper's headline numbers is that an associative cache in
front of a model absorbs skewed traffic.  The default sweep streams a
Zipf(s)-distributed key workload through a capacity-bounded LRU table
(misses are appended, like a response cache) and reports, per capacity:

  * hit-rate once the cache is warm;
  * p50 / p99 single-lookup latency (submit + flush + readback, the full
    service path, not a bare ``am.search`` call);
  * micro-batched throughput (``--batch`` lookups coalesced per flush) and
    the cross-request dedup rate inside those batches.

``--saturation`` runs the pipelined-driver sweep instead: offered-load
waves through the synchronous flush path vs the background
:class:`AMDriver`, reporting throughput, p50/p99 queue wait, the estimated
device-compute fraction a pipeline can hide, throughput scaling with
concurrent tables, and the admission-control shed counters under
deliberate oversubmission.

``--snapshot`` runs the durability sweep instead: snapshot and restore
wall time and bytes on disk against the table's size in memory (the
snapshot split into drain + copy and write + fsync), and time from
``restore()`` to the first resolved lookup, on the same bank count and on
other ones (``LocalMesh`` banks of the one device).

  PYTHONPATH=src python torch_benchmarks/bench_am_serve.py          # GPU
  PYTHONPATH=src python torch_benchmarks/bench_am_serve.py --smoke --device cpu
  PYTHONPATH=src python torch_benchmarks/bench_am_serve.py --smoke --saturation
  PYTHONPATH=src python torch_benchmarks/bench_am_serve.py --smoke --snapshot

Every timed row names the device it ran on.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.dist import LocalMesh  # noqa: E402
from repro_torch.serve.am_service import AMService, _next_pow2  # noqa: E402
from torch_benchmarks.common import emit  # noqa: E402


def zipf_probs(population: int, s: float) -> np.ndarray:
    ranks = np.arange(1, population + 1, dtype=np.float64)
    p = ranks ** -s
    return p / p.sum()


def run(smoke: bool = False, *, capacities=None, population: int = 2048,
        requests: int = 20_000, dim: int = 64, zipf_s: float = 1.1,
        batch: int = 64, backend: str = "cuda", policy: str = "lru",
        ttl: float | None = None, device=None) -> None:
    dev = resolve_device(device)
    if smoke:
        capacities = capacities or (16, 32)
        population, requests, batch = 128, 400, 16
    else:
        capacities = capacities or (64, 256, 1024)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 8, (population, dim)).astype(np.int32)
    probs = zipf_probs(population, zipf_s)
    workload = rng.choice(population, size=requests, p=probs)

    for capacity in capacities:
        svc = AMService(max_batch=batch, device=dev)
        svc.create_table("kv", width=dim, bits=3, capacity=capacity,
                         policy=policy, ttl=ttl, backend=backend)
        warm = requests // 4           # hit-rate measured after warmup only
        hits = 0
        lat_us: list[float] = []
        for step, pid in enumerate(workload):
            t0 = time.perf_counter()
            resp = svc.lookup("kv", codes[pid])
            lat_us.append(1e6 * (time.perf_counter() - t0))
            if resp.hit:
                hits += step >= warm
            else:
                svc.append("kv", codes[pid], values=[int(pid)])
        hit_rate = hits / max(1, requests - warm)

        # micro-batched regime: `batch` coalesced lookups per flush —
        # duplicate keys inside each wave dispatch once (dedup)
        n_flushes = 20 if not smoke else 4
        for pid in workload[:batch]:   # warm the batch-bucket shape
            svc.submit("kv", codes[pid])
        svc.flush()
        base_dedup = svc.stats()["dedup_hits"]
        t0 = time.perf_counter()
        for i in range(n_flushes):
            futs = [svc.submit("kv", codes[pid])
                    for pid in workload[i * batch:(i + 1) * batch]]
            svc.flush()
            for fut in futs:
                fut.result()
        batched_us = 1e6 * (time.perf_counter() - t0) / (n_flushes * batch)
        dedup_rate = (svc.stats()["dedup_hits"] - base_dedup) \
            / (n_flushes * batch)

        stats = svc.stats()
        tstats = stats["tables"]["kv"]
        if tstats["rows"] > capacity:
            raise RuntimeError("capacity bound violated")
        p50, p99 = np.percentile(lat_us, [50, 99])
        emit(f"am_serve_cap{capacity}", p50,
             f"hit_rate={hit_rate:.3f};p99_us={p99:.0f};"
             f"batched_us_per_lookup={batched_us:.1f};"
             f"batched_dedup_rate={dedup_rate:.3f};"
             f"evicted={tstats['evicted']};"
             f"compilations={stats['compilations']};"
             f"readbacks={stats['readbacks']};device={dev.type}")


def _run_waves(svc, codes, workload, names, batch, waves, *,
               sync: bool) -> float:
    """Offer ``waves`` waves of ``batch`` lookups; return the wall seconds.

    ``sync``: flush inline after every wave (launch + readback serial).
    Otherwise the background driver dispatches and the submitting thread
    only blocks at the end — the next wave's host work overlaps the
    previous wave's device compute.
    """
    futs = []
    t0 = time.perf_counter()
    for w in range(waves):
        name = names[w % len(names)]
        for pid in workload[w * batch:(w + 1) * batch]:
            futs.append(svc.submit(name, codes[pid]))
        if sync:
            svc.flush()
    for fut in futs:
        fut.result(timeout=120.0)
    return time.perf_counter() - t0


def run_saturation(smoke: bool = False, *, dim: int = 64,
                   population: int = 256, batch: int = 32,
                   waves: int = 48, backend: str = "cuda",
                   table_counts=(1, 2, 4), device=None) -> None:
    """Pipelined driver vs synchronous flush at saturation."""
    dev = resolve_device(device)
    if smoke:
        batch, waves, table_counts = 16, 12, (1, 2)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 8, (population, dim)).astype(np.int32)
    workload = rng.integers(0, population, size=waves * batch)

    def mk(n_tables):
        svc = AMService(max_batch=batch, flush_after=0.05,
                        time_fn=time.monotonic, device=dev)
        names = [f"t{i}" for i in range(n_tables)]
        for name in names:
            svc.create_table(name, width=dim, bits=3, capacity=population,
                             policy="lru", backend=backend)
            svc.append(name, codes, values=list(range(population)))
        # warm every power-of-two padding bucket the run can produce: the
        # driver coalesces however many waves are pending at wake time, so
        # its bucket sizes are load-dependent, and a bucket's first
        # dispatch (allocations, the kernels' first load) must not land in
        # the measured region.  max_batch is lifted during warmup so the
        # inline auto-flush cannot split a warm wave below its bucket.
        svc.max_batch = 1 << 30
        size = 1
        while size <= _next_pow2(min(population, waves * batch)):
            futs = [svc.submit(names[0], codes[i % population])
                    for i in range(size)]
            svc.flush()
            for fut in futs:
                fut.result()
            size *= 2
        svc.max_batch = batch
        return svc, names

    # how much of one flush is device compute (the part a pipeline hides):
    # submit-only host time vs full launch+readback time for one wave
    svc, names = mk(1)
    _run_waves(svc, codes, workload, names, batch, waves, sync=True)
    svc.max_batch = 1 << 30           # keep the probe submits from flushing
    t_host = time.perf_counter()
    futs = [svc.submit(names[0], codes[pid]) for pid in workload[:batch]]
    t_host = time.perf_counter() - t_host
    t_full = time.perf_counter()
    svc.flush()
    t_full = time.perf_counter() - t_full + t_host
    for fut in futs:
        fut.result()
    device_frac = max(0.0, 1.0 - t_host / max(t_full, 1e-9))

    results = {}
    for n_tables in table_counts:
        # synchronous reference: launch + readback serial per wave
        svc, names = mk(n_tables)
        _run_waves(svc, codes, workload, names, batch, waves, sync=True)
        svc._wait_samples.clear()     # drop warmup waits from the p99
        sync_s = _run_waves(svc, codes, workload, names, batch, waves,
                            sync=True)
        sync_p99 = svc.stats()["queue_wait_p99"]

        # pipelined: background driver, dispatch overlapped with readback
        svc, names = mk(n_tables)
        _run_waves(svc, codes, workload, names, batch, waves, sync=True)
        svc._wait_samples.clear()
        svc.start_driver(max_in_flight=4)
        try:
            async_s = _run_waves(svc, codes, workload, names, batch, waves,
                                 sync=False)
            async_p99 = svc.stats()["queue_wait_p99"]
        finally:
            svc.stop_driver()
        n_req = waves * batch
        results[n_tables] = n_req / async_s
        emit(f"am_serve_saturation_t{n_tables}",
             1e6 * async_s / n_req,
             f"sync_us_per_lookup={1e6 * sync_s / n_req:.1f};"
             f"async_over_sync_throughput={sync_s / async_s:.2f};"
             f"sync_p99_us={1e6 * sync_p99:.0f};"
             f"async_p99_us={1e6 * async_p99:.0f};"
             f"device_frac={device_frac:.2f};"
             f"in_flight_cap=4;device={dev.type}")
        # the pipeline must not cost meaningful throughput even when the
        # host share dominates; the win tracks device_frac
        if async_s >= sync_s * 2.5:
            raise RuntimeError(
                f"pipelined path pathologically slow: {async_s:.3f}s vs "
                f"sync {sync_s:.3f}s")

    if len(results) > 1:
        counts = sorted(results)
        lo, hi = results[counts[0]], results[counts[-1]]
        emit("am_serve_table_scaling", 0.0,
             f"tables={counts};"
             f"throughput_per_s={[f'{results[c]:.0f}' for c in counts]};"
             f"hi_over_lo={hi / max(lo, 1e-9):.2f}")

    # admission control under deliberate oversubmission: the shed table
    # absorbs the burst without queueing it
    svc, names = mk(1)
    svc.max_batch = 1 << 30           # no inline flush: the queue must fill
    svc.create_table("hot", width=dim, bits=3, capacity=population,
                     policy="lru", backend=backend, max_queue=batch,
                     admission="shed")
    svc.append("hot", codes[:8])
    shed_futs = [svc.submit("hot", codes[pid])
                 for pid in workload[:4 * batch]]
    svc.flush()
    for fut in shed_futs:
        fut.result()
    hot = svc.stats("hot")
    if not hot["shed"]:
        raise RuntimeError("oversubmission never tripped admission")
    emit("am_serve_admission", 0.0,
         f"offered={4 * batch};shed={hot['shed']};"
         f"admitted={4 * batch - hot['shed']};max_queue={batch}")


def _disk_bytes(directory) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(directory).rglob("*")
               if p.is_file())


def run_snapshot(smoke: bool = False, *, dim: int = 64,
                 sizes=(1024, 8192), backend: str = "cuda",
                 device=None) -> None:
    """Durability sweep: snapshot/restore cost + elastic recovery time."""
    import torch

    dev = resolve_device(device)
    if smoke:
        sizes = (128, 512)
    rng = np.random.default_rng(0)
    meshes = {1: None, 2: LocalMesh((2,), ("model",)),
              4: LocalMesh((4,), ("model",))}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for rows in sizes:
        codes = rng.integers(0, 8, (rows, dim)).astype(np.int32)
        svc = AMService(max_batch=32, device=dev)
        svc.create_table("kv", width=dim, bits=3, capacity=rows,
                         backend=backend)
        svc.append("kv", codes, values=list(range(rows)))
        query = codes[rng.integers(rows)]
        svc.lookup("kv", query)        # warm the dispatch
        table = svc._tables["kv"].table
        table_bytes = sum(x.numel() * x.element_size()
                          for x in (table.codes, table.meta))

        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            svc.snapshot(d)
            snap_s = time.perf_counter() - t0
            stages = svc._last_snapshot
            size_mb = _disk_bytes(d) / 1e6
            restore, recov = {}, {}
            for banks, mesh in meshes.items():
                t0 = time.perf_counter()
                restored = AMService.restore(d, mesh=mesh, device=dev)
                sync()
                restore[banks] = time.perf_counter() - t0
                resp = restored.lookup("kv", query)
                recov[banks] = time.perf_counter() - t0
                if not resp.hit:
                    raise RuntimeError("restored table lost the queried row")
        emit(f"am_snapshot_rows{rows}", 1e6 * snap_s,
             f"disk_mb={size_mb:.2f};table_mb={table_bytes / 1e6:.2f};"
             f"drain_capture_ms={1e3 * stages['drain_capture_s']:.1f};"
             f"write_ms={1e3 * stages['write_s']:.1f};"
             + "".join(f"restore_b{b}_ms={1e3 * s:.0f};"
                       for b, s in sorted(restore.items()))
             + ";".join(f"recovery_b{b}_ms={1e3 * s:.0f}"
                        for b, s in sorted(recov.items()))
             + f";device={dev.type}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny workload + capacities (CI guard)")
    ap.add_argument("--saturation", action="store_true",
                    help="pipelined-driver saturation sweep instead of the "
                         "Zipfian capacity sweep")
    ap.add_argument("--snapshot", action="store_true",
                    help="durability sweep (snapshot/restore cost + elastic "
                         "recovery time) instead of the capacity sweep")
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    if args.saturation:
        run_saturation(smoke=args.smoke, backend=args.backend,
                       device=args.device)
    elif args.snapshot:
        run_snapshot(smoke=args.smoke, backend=args.backend,
                     device=args.device)
    else:
        run(smoke=args.smoke, backend=args.backend, batch=args.batch,
            device=args.device)

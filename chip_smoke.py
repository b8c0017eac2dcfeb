#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — multi-bit codes in a capacity-bounded table,
searched through ``AMService`` and its pipelined ``AMDriver`` on the
hand-written CUDA kernels — and checks it, in four phases; any failure
exits non-zero without the final ``ok`` line:

1. device and build: the card's name and power limit, then ``nvcc`` builds
   every kernel of ``src/repro_torch/csrc`` for sm_90a;
2. each kernel against its plain PyTorch version on the card, bitwise,
   over hamming (bits 1 and 3), thermometer-expanded L1, care planes,
   threshold counts, ``valid_rows`` below k, k in {1, 10, 256} and ragged
   N and D;
3. the service at full size: a 256-wide, 3-bit table of capacity 2^20
   holding 1,000,000 rows, 4,096 lookups at k = 10 through the driver
   (half exact, half with 8 of 256 symbols perturbed), 64 of them checked
   bitwise against the plain top-k; then an L1 table at k = 10 and at
   k = 300 (the dense tier) and a ternary table with ``matches=16``.  Each
   of these four paths runs with the launch counts set to 0 just before it
   and read just after, and must launch its kernel once per group;
4. each kernel held bitwise against its plain version and timed with CUDA
   events at every bucket shape its path dispatched (the fused kernel at
   the k = 10 service path's, the dense one at the L1 k = 300 path's),
   beside its bound, its plain version and, for the dense kernel,
   ``torch.cdist(p=0)``; also at Q = 64, and at Q <= 16 with 16- and with
   64-query blocks; and the service's lookups/s and queue waits.

It imports nothing of the JAX package.  Needs one CUDA card, ``nvcc`` and
``nvidia-smi``; the build goes to ``build/repro_torch/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20231007

# H100 SXM peaks from the data sheet, dense: HBM3 bytes/s and int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

WIDTH, BITS = 256, 3
CAPACITY, ROWS, CHUNK = 1 << 20, 1_000_000, 65_536
LOOKUPS, K = 4096, 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"build: {len(paths)} librar{'y' if len(paths) == 1 else 'ies'} "
          f"in {dt:.1f} s")
    for name, (_, log) in _build.build_logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    return dt


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _thermo(x, bits):
    m = 1 << bits
    return (x[..., None] >= np.arange(1, m)).astype(np.int32).reshape(
        *x.shape[:-1], x.shape[-1] * (m - 1))


def kernel_cases():
    """(name, bits, Q, N, D, care?, count_le?, valid_rows, k, l1?)."""
    return [
        ("b1-ragged", 1, 5, 1000, 37, False, False, None, 1, False),
        ("b1-ties", 1, 8, 513, 16, False, True, None, 256, False),
        ("b3-vr<k", 3, 17, 300, 100, False, False, 5, 10, False),
        ("b3-care-count", 3, 64, 4099, 256, True, True, 4000, 256, False),
        ("b3-q1", 3, 1, 777, 48, True, False, None, 10, False),
        ("l1-care", 3, 33, 2000, 20, True, True, 1500, 10, True),
        ("b3-wide", 3, 64, 131_072, 256, False, False, 120_000, 10, False),
    ]


def phase_kernels():
    import torch
    from repro_torch.kernels.cam_search import ops, ref
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    err = {"cam_search": 0.0, "cam_search_topk": 0.0}
    for name, bits, qn, n, d, has_care, counted, vr, k, l1 in kernel_cases():
        m = 1 << bits
        codes = rng.integers(0, m, (n, d)).astype(np.int32)
        codes[1::7] = codes[0]                  # duplicate rows: ties
        q = rng.integers(0, m, (qn, d)).astype(np.int32)
        q[0] = codes[0]
        care = ((rng.random((n, d)) > 0.25).astype(np.int32)
                if has_care else None)
        if l1:
            if care is not None:
                care = np.repeat(care, m - 1, axis=-1)
            codes, q, bits = _thermo(codes, bits), _thermo(q, bits), 1
        t_q = torch.from_numpy(q).to(dev).to(torch.int8)
        t_t = torch.from_numpy(codes).to(dev).to(torch.int8)
        t_c = None if care is None else torch.from_numpy(care).to(dev)
        thr = None
        if counted:
            thr = torch.from_numpy(
                rng.integers(0, d // 2, (qn, 1)).astype(np.float32)).to(dev)
        # dense tier
        want = ref.mismatch_counts(t_q, t_t, t_c)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got = ops.mismatch_counts(t_q, t_t, bits, care=t_c)
            torch.cuda.synchronize()
            check(got.dtype == torch.int32
                  and got.shape == (qn, codes.shape[0]),
                  f"{name}: dense dtype/shape {got.dtype} {tuple(got.shape)}")
            diff = (got.long() - want.long()).abs().max().item()
            err["cam_search"] = max(err["cam_search"], float(diff))
            check(diff == 0,
                  f"{name}/{tile}: cam_search differs from plain by {diff}")
        # fused tier
        want = ref.topk(t_q, t_t, k, valid_rows=vr, care=t_c, count_le=thr)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got = ops.topk_fused(t_q, t_t, k, bits, valid_rows=vr,
                                     care=t_c, count_le=thr)
            torch.cuda.synchronize()
            for part, g, w in zip(("rows", "distances", "counts"), got, want):
                check(torch.equal(g, w), f"{name}/{tile}: cam_search_topk "
                      f"{part} differ from plain")
        print(f"  {name}: Q={qn} N={codes.shape[0]} D={codes.shape[1]} "
              f"k={k} bitwise equal (query tiles {_tiles(qn)})")
    return err


def _tiles(qn):
    """Query tiles a batch of ``qn`` queries takes: 16 or 64, and for a
    small batch also the 64-query tile the wrapper passes over."""
    return (16, 64) if qn <= 16 else (64,)


@contextlib.contextmanager
def _query_tile(tile):
    """Make the kernel wrappers use ``tile``-query blocks (16 or 64)."""
    from repro_torch.kernels.cam_search import kernel
    saved = kernel.SMALL_TILE_MAX_Q
    kernel.SMALL_TILE_MAX_Q = saved if tile == 16 else 0
    try:
        yield
    finally:
        kernel.SMALL_TILE_MAX_Q = saved


# ---------------------------------------------------------------------------
# phase 3: the service at full size
# ---------------------------------------------------------------------------

def _perturb(rng, word, n_sym, levels):
    out = word.copy()
    pos = rng.choice(word.shape[0], n_sym, replace=False)
    out[pos] = (out[pos] + rng.integers(1, levels, n_sym)) % levels
    return out


def _drive(svc, path, table, queries, **kw):
    """One path: submit ``queries`` to ``table`` and wait for them all.

    The launch counts are set to 0 just before the first submit and read
    just after the last lookup resolved, so they are this path's alone; the
    groups it dispatched are read from the table's bucket counts.  Each
    group is one search, which launches one kernel: the fused one, or the
    dense one for k above 256.
    """
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import kernel
    check(svc.drain(timeout=600), f"{path}: driver busy before the path")
    before = svc.stats(table)["buckets"]
    kernel.reset_launches()
    t0 = time.perf_counter()
    futs = [svc.submit(table, q, **kw) for q in queries]
    check(svc.drain(timeout=600), f"{path}: driver did not drain")
    seconds = time.perf_counter() - t0
    launches = dict(kernel.launches)
    after = svc.stats(table)["buckets"]
    buckets = {b: n - before.get(b, 0) for b, n in sorted(after.items())
               if n > before.get(b, 0)}
    groups = sum(buckets.values())
    tier = ("cam_search" if kw.get("k", 1) > am.FUSED_K_MAX
            else "cam_search_topk")
    want = {name: groups if name == tier else 0 for name in launches}
    check(launches == want, f"{path}: launches {launches}, expected {want} "
          f"for {groups} groups")
    print(f"  {path}: {len(queries)} lookups, {groups} groups "
          f"(buckets {buckets}), launches {launches}, {seconds:.3f} s")
    return futs, {"table": table, **kw, "lookups": len(queries),
                  "seconds": seconds, "launches": launches,
                  "buckets": buckets}


def phase_service():
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import ref
    from repro_torch.serve import AMService

    rng = np.random.default_rng(SEED + 1)
    svc = AMService(time_fn=time.monotonic)
    svc.create_table("responses", width=WIDTH, bits=BITS, distance="hamming",
                     capacity=CAPACITY, policy="lru", backend="cuda")
    stored = np.empty((ROWS, WIDTH), np.int8)
    t0 = time.perf_counter()
    for s in range(0, ROWS, CHUNK):
        m = min(CHUNK, ROWS - s)
        chunk = rng.integers(0, 1 << BITS, (m, WIDTH), dtype=np.int32)
        stored[s:s + m] = chunk
        svc.append("responses", chunk, values=list(range(s, s + m)))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    print(f"  filled {ROWS} rows in {fill_s:.2f} s")

    l1_codes = rng.integers(0, 1 << BITS, (CHUNK, WIDTH), dtype=np.int32)
    base = rng.integers(0, 1 << BITS, (4096, WIDTH), dtype=np.int32)
    t_codes = np.tile(base, (16, 1))
    copy_no = np.repeat(np.arange(16), 4096)
    t_care = (np.arange(WIDTH)[None, :]
              < (WIDTH - 16 * copy_no)[:, None]).astype(np.int32)
    svc.create_table("l1", width=WIDTH, bits=BITS, distance="l1",
                     capacity=CHUNK, policy="lru", backend="cuda")
    svc.append("l1", l1_codes, values=list(range(CHUNK)))
    svc.create_table("tcam", width=WIDTH, bits=BITS, capacity=CHUNK,
                     policy="lru", backend="cuda", ternary=True)
    svc.append("tcam", t_codes, care=t_care, values=list(range(CHUNK)))

    rows = rng.integers(0, ROWS, LOOKUPS)
    exact = np.arange(LOOKUPS) < LOOKUPS // 2
    queries = [stored[r].astype(np.int32) if e
               else _perturb(rng, stored[r].astype(np.int32), 8, 1 << BITS)
               for r, e in zip(rows, exact)]
    l1_rows = rng.integers(0, CHUNK, 64)
    t_rows = rng.integers(0, 4096, 64)
    t_queries = [base[r] if i % 2 else _perturb(rng, base[r], 8, 1 << BITS)
                 for i, r in enumerate(t_rows)]
    for i in range(1, 64, 2):          # perturb only don't-care tail cells
        t_queries[i] = base[t_rows[i]].copy()
        t_queries[i][-8:] = (t_queries[i][-8:] + 1) % (1 << BITS)
    torch.cuda.synchronize()

    # -- the slice's paths, each with its own launch counts -----------------
    svc.start_driver(max_in_flight=2)
    paths = {}
    futs, paths["responses_k10"] = _drive(svc, "responses_k10", "responses",
                                          queries, k=K)
    main_stats = svc.stats()
    l1_futs, paths["l1_k10"] = _drive(svc, "l1_k10", "l1",
                                      l1_codes[l1_rows], k=K)
    l1_dense, paths["l1_k300"] = _drive(svc, "l1_k300", "l1",
                                        l1_codes[l1_rows[:4]], k=300)
    t_futs, paths["tcam_m16"] = _drive(svc, "tcam_m16", "tcam", t_queries,
                                       matches=16)
    svc.stop_driver()

    resp = [f.result() for f in futs]
    for i, (r, e) in enumerate(zip(rows, exact)):
        check(resp[i].best_row == r,
              f"lookup {i}: best row {resp[i].best_row} != stored row {r}")
        check(resp[i].hit == bool(e), f"lookup {i}: hit={resp[i].hit}")
        check(e or resp[i].distances[0] == 8.0,
              f"lookup {i}: perturbed distance {resp[i].distances[0]}")
    # 64 dispatched lookups, bitwise against the chunked plain top-k
    pick = np.concatenate([np.arange(32), LOOKUPS // 2 + np.arange(32)])
    table = svc._tables["responses"].table
    q_dev = torch.from_numpy(np.stack([queries[i] for i in pick])).cuda()
    p_idx, p_dist = ref.topk(q_dev, table.codes, K, valid_rows=ROWS)
    p_idx, p_dist = p_idx.cpu().numpy(), p_dist.cpu().numpy()
    for j, i in enumerate(pick):
        check(np.array_equal(resp[i].indices, p_idx[j])
              and np.array_equal(resp[i].distances, p_dist[j]),
              f"lookup {i}: service result differs from the plain top-k")
    # L1 table: exact hits, and the dense tier against the ref backend
    for f, r in zip(l1_futs, l1_rows):
        check(f.result().hit and f.result().best_row == r, "l1 exact lookup")
    l1_table = am.make_table(l1_codes, bits=BITS, distance="l1")
    want = am.search(l1_table, l1_codes[l1_rows[:4]], k=300, backend="ref")
    for j, f in enumerate(l1_dense):
        check(np.array_equal(f.result().indices, want.indices[j].cpu().numpy())
              and np.array_equal(f.result().distances,
                                 want.distances[j].cpu().numpy()),
              "l1 k=300 (dense tier) differs from the ref backend")
    # ternary table: exact base words match all 16 copies, tail-perturbed
    # words the 15 copies whose don't-care tail covers the change
    for i in range(1, 64, 2):
        r = t_futs[i].result()
        check(r.match_count == 15 and not r.overflow,
              f"tcam lookup {i}: match_count {r.match_count} != 15")
        check(r.indices[0] == t_rows[i] + 4096,
              f"tcam lookup {i}: priority row {r.indices[0]}")
    exact_t = svc.lookup("tcam", base[7], matches=16)
    check(exact_t.match_count == 16 and exact_t.indices[0] == 7,
          f"tcam exact word: {exact_t.match_count} matches")

    s = main_stats
    main_s = paths["responses_k10"]["seconds"]
    print(f"  service: {LOOKUPS} lookups in {main_s:.3f} s, "
          f"readbacks={s['readbacks']} flushes={s['flushes']} "
          f"dedup_hits={s['dedup_hits']} compilations={s['compilations']} "
          f"fused_fallbacks={svc.stats()['fused_fallbacks']}")
    service = {"lookups": LOOKUPS, "seconds": main_s,
               "lookups_per_s": LOOKUPS / main_s,
               "queue_wait_p50_s": s["queue_wait_p50"],
               "queue_wait_p99_s": s["queue_wait_p99"],
               "groups": s["readbacks"], "fill_s": fill_s}
    return {"svc": svc, "paths": paths, "service": service,
            "queries": queries, "l1_queries": l1_codes[l1_rows[:4]]}


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def _time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _timed_once(fn):
    """(ms, result) of one call, timed with CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def _bound_parts(bytes_moved, ops):
    """(ms at the memory rate, ms at the int8 operation rate)."""
    return bytes_moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def _time_dense(q8, t8, levels, groups, err):
    """One shape of the dense kernel: held against plain, then timed, with
    ``torch.cdist(p=0)`` on float copies as the library call."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    plain_ms, want = _timed_once(lambda: ref.mismatch_counts(q8, t8))
    got = kernel.cam_search(q8, t8, levels=levels)
    diff = float((got.long() - want.long()).abs().max().item())
    err["cam_search"] = max(err["cam_search"], diff)
    check(diff == 0, f"cam_search differs from plain by {diff} at "
          f"Q={qn} N={n} D={d}")
    del got, want
    ms = _time_ms(lambda: kernel.cam_search(q8, t8, levels=levels), 10)
    qf, tf = q8.float(), t8.float()
    lib_ms = _time_ms(lambda: torch.cdist(qf, tf, p=0), 5, 1)
    del qf, tf
    t_b, t_o = _bound_parts(qn * d + n * d + qn * n * 4, qn * n * d)
    return {"Q": qn, "N": n, "D": d, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes_ms": t_b, "ops_ms": t_o}


def _time_fused(q8, t8, vr, levels, k, groups, err):
    """One shape of the fused kernel: held against plain, then timed.  Its
    bound counts the live rows only, the ones the result depends on."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    plain_ms, want = _timed_once(lambda: ref.topk(q8, t8, k, valid_rows=vr))
    got = kernel.cam_search_topk(q8, t8, vr, levels=levels, k=k)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"cam_search_topk differs from plain at Q={qn} N={n} D={d} k={k}")
    del got, want
    ms = _time_ms(lambda: kernel.cam_search_topk(q8, t8, vr, levels=levels,
                                                 k=k), 10)
    live = int(vr.item())
    t_b, t_o = _bound_parts(qn * d + live * d + 4 + qn * k * 8,
                            qn * live * d)
    return {"Q": qn, "N": n, "D": d, "k": k, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bytes_ms": t_b, "ops_ms": t_o}


def _tile_ms(fn):
    """The kernel call ``fn`` timed with 16- and with 64-query blocks."""
    out = {}
    for tile in (16, 64):
        with _query_tile(tile):
            out[f"ms_tile{tile}"] = _time_ms(fn, 10)
    return out


def _row(name, replaces, path, paths, shapes, err):
    """One kernel's line.  ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are means over the groups that ``path`` dispatched, each
    group's shape timed alone; ``launches`` sums the counts of every path,
    and ``launches_by_path`` gives each."""
    main = [s for s in shapes if s["groups"]]
    g = sum(s["groups"] for s in main)

    def mean(key):
        return sum(s[key] * s["groups"] for s in main) / g

    t_b, t_o = mean("bytes_ms"), mean("ops_ms")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/cam_search.cu",
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "max_abs_err": err[name], "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": (None if main[0]["library_ms"] is None
                           else mean("library_ms")),
            "timed_path": path,
            "launches_by_path": {p: v["launches"][name]
                                 for p, v in paths.items()},
            "shapes": shapes}


def phase_timing(run, err):
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import kernel
    svc, paths = run["svc"], run["paths"]
    levels = 1 << BITS
    codes = svc._tables["responses"].table.codes          # (2^20, 256) int32
    t8 = codes.to(torch.int8)
    dev = t8.device
    vr = torch.full((1,), ROWS, dtype=torch.int32, device=dev)
    cast_ms = _time_ms(lambda: codes.to(torch.int8), 10)
    order = np.random.default_rng(SEED + 2).permutation(LOOKUPS)
    q_all = torch.from_numpy(np.stack(run["queries"])[order]).to(dev)

    def batch(qn):
        return q_all[:qn].to(torch.int8).contiguous()

    # fused kernel: each bucket size the main path dispatched, then Q = 64
    # and the small batches, these also with 64-query blocks
    buckets = paths["responses_k10"]["buckets"]
    fused = [_time_fused(batch(qb), t8, vr, levels, K, n, err)
             for qb, n in buckets.items()]
    if 64 not in buckets:
        fused.append(_time_fused(batch(64), t8, vr, levels, K, 0, err))
    for qn in (1, 4, 16):
        q8 = batch(qn)
        shape = _time_fused(q8, t8, vr, levels, K, 0, err)
        shape.update(_tile_ms(lambda: kernel.cam_search_topk(
            q8, t8, vr, levels=levels, k=K)))
        fused.append(shape)

    # dense kernel: the L1 k = 300 path's thermometer-expanded table (its
    # queries padded to the bucket as the service pads them), then the
    # responses table at Q = 64
    l1_codes = svc._tables["l1"].table.codes                # (65536, 256)
    l1_expand_ms = _time_ms(
        lambda: am.thermometer(l1_codes, BITS).to(torch.int8), 5)
    l1_t8 = am.thermometer(l1_codes, BITS).to(torch.int8)
    l1_q = am.thermometer(torch.from_numpy(run["l1_queries"]).to(dev),
                          BITS).to(torch.int8)
    dense = []
    for qb, n in paths["l1_k300"]["buckets"].items():
        q8 = torch.zeros((qb, l1_q.shape[1]), dtype=torch.int8, device=dev)
        q8[:min(qb, l1_q.shape[0])] = l1_q[:qb]
        shape = _time_dense(q8, l1_t8, 2, n, err)
        if qb <= 16:
            shape.update(_tile_ms(lambda: kernel.cam_search(
                q8, l1_t8, levels=2)))
        dense.append(shape)
    del l1_t8
    dense.append(_time_dense(batch(64), t8, levels, 0, err))

    rows = [
        _row("cam_search", "src/repro/kernels/cam_search/kernel.py:114",
             "l1_k300", paths, dense, err),
        _row("cam_search_topk", "src/repro/kernels/cam_search/kernel.py:402",
             "responses_k10", paths, fused, err),
    ]
    for r in rows:
        for s in r["shapes"]:
            tiles = "".join(f" {key}={s[key]:.4f}" for key in s
                            if key.startswith("ms_tile"))
            print(f"  {r['name']}: Q={s['Q']} N={s['N']} D={s['D']} "
                  f"groups={s['groups']} ms={s['ms']:.4f} "
                  f"plain_ms={s['plain_ms']:.2f}{tiles}")
    kernel_ms = sum(s["ms"] * s["groups"] for s in fused)
    print(f"  int32->int8 table cast {cast_ms:.4f} ms per call; L1 "
          f"thermometer expansion + cast {l1_expand_ms:.4f} ms per search; "
          f"fused kernel time of the main path {kernel_ms:.2f} ms")
    return rows, {"table_cast_ms": cast_ms, "l1_expand_ms": l1_expand_ms,
                  "main_path_kernel_ms": kernel_ms}


def main() -> int:
    try:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available()"
                  " is False)", file=sys.stderr)
            return 1
        sys.path.insert(0, os.path.join(ROOT, "src"))
        import repro_torch  # noqa: F401  (fail before printing anything)
        print("phase 1: device and build")
        card = phase_device()
        phase_build()
        print("phase 2: kernels against their plain versions")
        err = phase_kernels()
        print("phase 3: the service at full size")
        run = phase_service()
        print("phase 4: timing")
        rows, costs = phase_timing(run, err)
        service = {**run["service"], **costs}
        print(card)
        print(json.dumps({"kernels": rows, "service": service,
                          "paths": run["paths"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception as e:                       # report, then fail the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

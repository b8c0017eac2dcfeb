"""Serving driver: continuous-batching engine fronted by the AM cache service.

Port of :mod:`repro.launch.serve` on one device.  Requests are drawn from a
small prompt pool (so the workload repeats itself, like real traffic);
every prompt is first batch-looked-up in an
:class:`repro_torch.serve.AMService` response table (one micro-batched
dispatch for the whole wave), only the unique misses run through the
:class:`ContinuousBatcher`, and their generations are appended back so
later repeats hit.

The cache service runs on a wall-clock ``flush_after`` deadline owned by a
background :class:`AMDriver` (``svc.start_driver()``); waiting is
event-driven (``fut.result(timeout=...)``).

  python -m repro_torch.launch.serve --arch yi-6b --full      # on the GPU
  python -m repro_torch.launch.serve --device cpu             # smoke config

``--am-index SETS`` / ``--am-probes P`` route the cache's lookups through
the set-associative IVF tier (:mod:`repro_torch.index`), as in the
reference.  ``--am-sharded`` banks the cache's rows over the ``model``
axis of the serving mesh (:func:`repro_torch.launch.mesh.make_test_mesh`,
a local mesh of one bank on one card, as the reference's test mesh is on
one device) and ``--am-merge`` picks the cross-bank merge.
``--am-snapshot-dir DIR`` commits a snapshot of the cache on exit, and
``--am-restore`` warm-restarts the cache from the one committed there,
onto this run's mesh (:mod:`repro_torch.serve.snapshot`); with nothing
committed yet the cache starts cold.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from repro_torch.configs.registry import ALIASES, get_config
from repro_torch.core import hdc
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer
from repro_torch.serve import AMService, IndexSpec
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import ContinuousBatcher, Request

CACHE_DIM = 128        # hypervector width of the response-cache key
CACHE_BITS = 3


def parse_args(argv=None):
    """Parse the serving driver's CLI flags (``argv=None`` -> ``sys.argv``):
    the reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--am-cache", type=int, default=8, metavar="CAPACITY",
                    help="AM response-cache capacity (0 disables the cache)")
    ap.add_argument("--am-sharded", action="store_true",
                    help="route the AM cache through am.search_sharded on "
                         "the serving mesh (rows banked over `model`)")
    ap.add_argument("--am-merge",
                    choices=("auto", "allgather", "tree", "ring"),
                    default="auto",
                    help="cross-bank candidate merge topology for the "
                         "sharded AM cache")
    ap.add_argument("--am-index", type=int, default=0, metavar="SETS",
                    help="route cache lookups through the set-associative "
                         "IVF tier with this many sets (0 = flat scan)")
    ap.add_argument("--am-probes", type=int, default=1, metavar="P",
                    help="sets probed per indexed lookup (only with "
                         "--am-index)")
    ap.add_argument("--am-snapshot-dir", default=None, metavar="DIR",
                    help="durable-cache directory: the AM cache is "
                         "snapshotted here (atomically, keep-2 versioned) "
                         "on exit")
    ap.add_argument("--am-restore", action="store_true",
                    help="warm-restart the AM cache from --am-snapshot-dir "
                         "before serving (elastic: the mesh may have a "
                         "different bank count than the snapshotting run); "
                         "ignored when the directory holds no committed "
                         "snapshot yet")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the GPU)")
    return ap.parse_args(argv)


def build_cache_service(args, mesh=None, *, start_driver=True):
    """Build the AM response-cache service the parsed flags describe.

    Returns ``None`` when ``--am-cache 0`` disabled the cache.  Otherwise a
    deadline-batched :class:`AMService` on ``args.device`` — sharded over
    ``mesh`` (default :func:`make_test_mesh`) iff ``--am-sharded``, merge
    from ``--am-merge`` — holding one
    ``"responses"`` table (``pallas`` backend, which the port runs on its
    CUDA kernels; LRU at ``--am-cache`` rows): a flat scan, or with
    ``--am-index SETS`` an :class:`IndexSpec` of that many sets probed
    ``--am-probes`` at a time.  ``start_driver=False`` skips the background
    driver so tests can step the service deterministically.

    With ``--am-restore`` and a committed snapshot under
    ``--am-snapshot-dir``, the service warm-restarts from it instead:
    tables, payloads and row counts survive the process boundary, and the
    snapshot's rows bank onto this run's mesh, whatever its bank count.
    """
    if not args.am_cache:
        return None
    if args.am_sharded and mesh is None:
        mesh = make_test_mesh()
    mesh = mesh if args.am_sharded else None
    # deadline-batched: submits queue until the 5 ms flush_after expires;
    # the background driver owns the deadline
    placed = dict(mesh=mesh, merge=args.am_merge,
                  max_batch=max(64, args.requests), flush_after=0.005,
                  time_fn=time.monotonic, device=args.device)
    if (args.am_restore and args.am_snapshot_dir and
            (pathlib.Path(args.am_snapshot_dir) / "service.json").exists()):
        svc = AMService.restore(args.am_snapshot_dir, **placed)
    else:
        svc = AMService(**placed)
        spec = (IndexSpec(sets=args.am_index, probes=args.am_probes)
                if args.am_index else None)
        svc.create_table("responses", width=CACHE_DIM, bits=CACHE_BITS,
                         capacity=args.am_cache, policy="lru",
                         backend="pallas", index=spec)
    if start_driver:
        svc.start_driver()
    return svc


def main(argv=None) -> dict:
    """Serve the workload; print the report; return what was served.

    The returned dict holds ``results`` (request id -> generated tokens),
    ``generated`` (the ids the LM generated), ``workload`` (the prompts),
    ``ticks``, ``wall_s``, ``cache`` (the response table's stats, or None)
    and the ``engine`` (its ``cfg`` and ``params`` included).
    """
    args = parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.arch, args.arch), smoke=args.smoke)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    # the reference's serving mesh: an ep config's MoE layers decode
    # expert-parallel over its one bank
    engine = Engine.create(cfg, params, batch=args.slots,
                           max_len=args.max_len, device=dev,
                           mesh=make_test_mesh())
    batcher = ContinuousBatcher(engine)

    rng = np.random.default_rng(0)
    pool = [rng.integers(2, cfg.vocab_size,
                         size=rng.integers(3, 9)).astype(np.int32)
            for _ in range(max(2, args.requests // 2))]
    workload = [pool[rng.integers(len(pool))] for _ in range(args.requests)]

    svc = build_cache_service(args)
    if svc is not None:
        proj = hdc.token_key_projection(cfg.vocab_size, CACHE_DIM,
                                        device=dev)
        keys = [hdc.prompt_key(proj, p, CACHE_BITS).cpu().numpy()
                for p in workload]

    def drain(futs):
        """Event-driven wait on the driver's completion stage (no busy loop)."""
        for f in futs:
            f.result(timeout=60.0)

    t0 = time.time()
    results: dict[int, np.ndarray] = {}
    rep_of: dict[int, int] = {}

    if svc is not None:
        # wave 1: one micro-batched CAM lookup for the whole workload,
        # dispatched by the driver when the deadline expires
        futs = [svc.submit("responses", key) for key in keys]
        drain(futs)
        miss_ids = [i for i, f in enumerate(futs) if not f.result().hit]
        for i, f in enumerate(futs):
            if f.result().hit:
                results[i] = f.result().value
        # only unique missed prompts reach the LM batcher
        unique: dict[bytes, list[int]] = {}
        for i in miss_ids:
            unique.setdefault(keys[i].tobytes(), []).append(i)
        for ids in unique.values():
            for i in ids:
                rep_of[i] = ids[0]
        reps = [ids[0] for ids in unique.values()]
    else:
        reps = list(range(len(workload)))

    for rid in reps:
        batcher.submit(Request(rid=rid, prompt=workload[rid],
                               max_new_tokens=args.max_new))
    done = batcher.run()
    for r in done:
        gen = np.asarray(r.generated, np.int32)
        results[r.rid] = gen
        if svc is not None:
            svc.append("responses", keys[r.rid], values=[gen])

    if svc is not None:
        # wave 2: repeats of missed prompts — again one batch.  A repeat can
        # still miss when the LRU table is smaller than the number of unique
        # prompts generated above; it then falls back to its representative's
        # generation (same prompt, so the same greedy output).
        wave2 = {i: svc.submit("responses", keys[i])
                 for i in range(len(workload)) if i not in results}
        drain(list(wave2.values()))
        for i, fut in wave2.items():
            resp = fut.result()
            results[i] = resp.value if resp.hit else results[rep_of[i]]
        svc.stop_driver()
        if args.am_snapshot_dir:
            step = svc.snapshot(args.am_snapshot_dir)
            print(f"AM cache snapshot committed: step {step} -> "
                  f"{args.am_snapshot_dir}")
    wall = time.time() - t0

    generated = {r.rid for r in done}
    for i, gen in sorted(results.items()):
        src = "GEN" if i in generated else "CAM"
        print(f"req{i}: prompt[{len(workload[i])}] {src} -> "
              f"{[int(x) for x in gen]}")
    print(f"\n{len(results)}/{args.requests} requests, "
          f"{len(done)} generated, {batcher.ticks} engine ticks "
          f"({args.slots} slots), {wall:.1f}s wall")
    cache = None
    if svc is not None:
        s = svc.stats()
        cache = s["tables"]["responses"]
        placement = f"sharded/{s['merge']}" if s["sharded"] else "local"
        print(f"AM cache [{placement}]: {cache['hits']}/{cache['lookups']} "
              f"hits, {cache['rows']}/{cache['capacity']} rows, "
              f"{s['readbacks']} readbacks, "
              f"{s['compilations']} compilations, "
              f"{s['dedup_hits']} deduped ({s['dedup_rate']:.0%})")
        assert cache["rows"] <= cache["capacity"]
    assert len(results) == args.requests
    return {"results": results, "generated": sorted(generated),
            "workload": workload, "ticks": batcher.ticks, "wall_s": wall,
            "cache": cache, "engine": engine}


if __name__ == "__main__":
    main()

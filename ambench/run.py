"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 ambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the window's first timed lookup): the inputs made
on the card from the seed, the system built and filled from them, and the
set-up's share of the cell's own traffic.  Then the window: ``--seconds``
of the cell's loop, timed from the client's side; with ``--trace 1`` the
profiler records the window's first ``TRACE_SLICE_S`` seconds and the
per-layer metrics are read over that slice.  Then the check: a seeded
sample of the window's answers against the plain reference, once the
program's state is freed.  The last line of standard output is the result;
the numbers compared, each beside its limit, close standard error and the
result line.  No card, or fewer than the cell asks for: exit 2 and no
result.  ``jax``, ``jaxlib``, ``flax`` or ``repro`` loaded: exit 3.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from ambench import loops, registry, traffic  # noqa: E402

#: Top-level modules that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Answers of a window that the reference checks, drawn from the seed.
CHECK_LOOKUPS = 4096
#: Seconds of the window that a traced run records.
TRACE_SLICE_S = 6.0


class NoCard(RuntimeError):
    """The run needs CUDA cards that this machine does not have."""


class Forbidden(RuntimeError):
    """A module that the benchmark may not load was loaded."""


def forbidden_modules() -> list[str]:
    """Loaded top-level modules of :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def settle() -> None:
    """End of the build: collect once, then freeze what set-up made.

    Imported modules, the inputs and the filled system are long-lived; left
    in the collector's oldest generation, every full collection in the
    window would scan them (pauses of 0.1-0.2 s on the card's host).
    Frozen, a full collection scans only what the window allocated.
    """
    gc.collect()
    gc.freeze()


def _update(base: dict, over: dict | None) -> dict:
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _update(base[k], v)
        else:
            base[k] = v
    return base


class _Hooks(loops.Hooks):
    """Set-up's end, counters and the profiler at the window's edges."""

    def __init__(self, system, tracer, start: float):
        self.system, self.tracer, self.start = system, tracer, start
        self.setup_s = self.c0 = self.c1 = None

    def open(self) -> None:
        self.setup_s = time.perf_counter() - self.start
        self.c0 = self.system.counters()
        if self.tracer is not None:
            self.tracer.start()

    def close_slice(self) -> None:
        self.c1 = self.system.counters()
        if self.tracer is not None:
            self.tracer.stop()

    def span(self, name: str):
        if self.tracer is None:
            return super().span(name)
        from torch.profiler import record_function
        return record_function(name)


def _delta(c0: dict, c1: dict) -> dict:
    return {k: (_delta(c0[k], v) if isinstance(v, dict) else v - c0[k])
            for k, v in c1.items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, need_card: bool = True, device=None,
             config_over: dict | None = None, mix_over: dict | None = None,
             start: float = _START) -> dict:
    """One run of cell ``name``; returns its result (the ``checks`` last).

    ``need_card=False`` skips the look for a card and runs on ``device``
    (the CPU tests do, at sizes given by ``config_over``/``mix_over``).
    """
    bench = registry.benchmark(root)
    cell = registry.cell(bench, name)
    cfg = _update(registry.config(bench, cell["config"], root), config_over)
    mix = _update(registry.traffic(cell["traffic"], root), mix_over)
    import torch
    if need_card:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            raise NoCard(f"{name} needs {cell['chips']} CUDA card(s); "
                         f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "ambench" / "cache" / sub)
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))
    seeds = traffic.seeds(seed)

    systems = registry.module("systems", cfg["system"], root)
    inputs = systems.make_inputs(cfg, mix, seeds["rows"], device)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    system = systems.open_system(cfg, mix, inputs, device)
    settle()
    tracer = None
    if trace:
        from ambench.trace import Tracer
        tracer = Tracer(root / "build" / "ambench" / "traces" / f"{name}.json")
    hooks = _Hooks(system, tracer, start)
    sample = loops.Reservoir(CHECK_LOOKUPS, seeds["sample"])
    population = inputs.words.shape[0]
    keys = traffic.Keys(mix, population, seeds["keys"], seeds["order"])
    slice_s = TRACE_SLICE_S if trace else seconds
    if mix["loop"] == "closed":
        out = loops.closed(system, keys, outstanding=mix["outstanding"],
                           warmup=mix["warmup_lookups"], seconds=seconds,
                           slice_s=slice_s, sample=sample, hooks=hooks)
    elif mix["loop"] == "batch":
        size = mix["batch_lookups"]
        sample = loops.Reservoir(max(1, CHECK_LOOKUPS // size),
                                 seeds["sample"])
        out = loops.batch(system, keys, size=size,
                          in_flight=mix["batches_in_flight"],
                          warmup=mix["warmup_batches"], seconds=seconds,
                          slice_s=slice_s, sample=sample, hooks=hooks)
    elif mix["loop"] == "open":
        warm = traffic.Keys(mix, population, seeds["warmup"], seeds["order"])
        due = traffic.arrivals(mix["rate_per_s"], mix["warmup_s"],
                               seeds["warmup_arrivals"])
        loops.open_(system, due, warm.draw(due.size), seconds=mix["warmup_s"],
                    slice_s=mix["warmup_s"], sample=loops.Reservoir(0, 0),
                    hooks=loops.Hooks())
        due = traffic.arrivals(mix["rate_per_s"], seconds, seeds["arrivals"])
        out = loops.open_(system, due, keys.draw(due.size), seconds=seconds,
                          slice_s=slice_s, sample=sample, hooks=hooks)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    if forbidden_modules():
        raise Forbidden(f"loaded after the window: {forbidden_modules()}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counters = _delta(hooks.c0, hooks.c1)
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    summary = None
    if trace:
        from ambench.trace import summarize
        summary = summarize(tracer.save())

    reference = registry.module("references", cfg["reference"], root)
    items = out.pop("items", sample.items)
    checked = reference.check(inputs, cfg, mix, items, device)
    record = {"cell": name, "config": cfg, "traffic": mix,
              "setup_s": hooks.setup_s, "peak_bytes": peak,
              "counters": counters, "trace": summary,
              "reference": checked["facts"], **out}
    metrics = {}
    for m in registry.metrics(bench, name, trace):
        value = registry.module("metrics", m["name"], root).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {"mismatched_answers": {"value": checked["mismatched"],
                                     "limit": 0},
              "failed_lookups": {"value": out["failed"], "limit": 0}}
    correct = (len(items) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    result["window"] = {"groups": counters["groups"],
                        "dispatched": counters["dispatched"]}
    if out.get("per_s") is not None:
        result["window"]["per_s"] = out["per_s"]
    if out.get("latency_s") is not None:
        q = np.percentile(out["latency_s"], [50, 90, 99]) * 1e3
        result["window"]["latency_ms"] = dict(zip(("p50", "p90", "p99"),
                                                  q.tolist()))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        print(f"ambench: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(f"ambench: {e}", file=sys.stderr)
        return 3
    if forbidden_modules():
        print(f"ambench: loaded: {forbidden_modules()}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        if isinstance(c, dict):
            print(f"check {key} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

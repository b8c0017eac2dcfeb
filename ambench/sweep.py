"""Find the knee of an open-loop cell: the highest offered rate it sustains.

    python3 ambench/sweep.py --workload am_flat_1m.zipf_open --seed 11 \
        --seconds 6 --rates 5000,10000,15000

The cell may be one of ``later.json``'s, left out of ``BENCHMARK.json``
until its knee and bounds hold.  One process sets the cell's system up
once, then offers each rate in turn for ``--seconds`` (after a short
warm-up at that rate) through the same open loop as a run, and prints one
JSON line a rate: p50 and p99 latency, the p50 of the window's first and
last thirds, the sender's p99 lateness, the lookups still unanswered at
the window's close, and ``sustained``: p99 within ``LIMIT_P99_MS``, the
last third's p50 within twice the first third's plus 2 ms (a backlog that
grows through the window fails it), and the sender's p99 lateness within
``LIMIT_LAG_MS`` (past it the client, not the system, sets the schedule).
Every rate is offered; the last line names the knee: the highest
sustained rate below the first one that is not.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ambench import loops, registry, run, traffic  # noqa: E402

WARMUP_S = 0.5
#: The latency limit a sustained rate meets at its p99.
LIMIT_P99_MS = 100.0
#: How late, at its p99, the sender may send at a sustained rate.
LIMIT_LAG_MS = 10.0


def _q(values, p: int) -> float:
    return statistics.quantiles(values, n=100)[p - 1]


def step(system, mix: dict, population: int, rate: float, seconds: float,
         seed: int) -> dict:
    """One rate: warm-up, then a window; the window's readings."""
    s = traffic.seeds(seed)
    warm = traffic.Keys(mix, population, s["warmup"], s["order"])
    due = traffic.arrivals(rate, WARMUP_S, s["warmup_arrivals"])
    loops.open_(system, due, warm.draw(due.size), seconds=WARMUP_S,
                slice_s=WARMUP_S, sample=loops.Reservoir(0, 0),
                hooks=loops.Hooks())
    keys = traffic.Keys(mix, population, s["keys"], s["order"])
    due = traffic.arrivals(rate, seconds, s["arrivals"])
    c0 = system.counters()
    out = loops.open_(system, due, keys.draw(due.size), seconds=seconds,
                      slice_s=seconds, sample=loops.Reservoir(0, 0),
                      hooks=loops.Hooks())
    c1 = system.counters()
    lat, lag = out["latency_s"], out["gen_lag_s"]
    third = due.size // 3
    first = statistics.median(lat[:third])
    last = statistics.median(lat[-third:])
    open_at_close = int(((due + lat) > seconds).sum())
    dispatched = c1["dispatched"] - c0["dispatched"]
    return {"rate_per_s": rate, "lookups": int(due.size),
            "p50_ms": statistics.median(lat) * 1e3, "p99_ms": _q(lat, 99) * 1e3,
            "p50_first_third_ms": first * 1e3, "p50_last_third_ms": last * 1e3,
            "gen_lag_p99_ms": _q(lag, 99) * 1e3,
            "unanswered_at_close": open_at_close,
            "group_lookups_mean": dispatched / max(1, c1["groups"] - c0["groups"]),
            "dedup_pct": 100.0 * (c1["dedup_hits"] - c0["dedup_hits"])
            / max(1, dispatched),
            "failed": out["failed"],
            "sustained": bool(last <= 2 * first + 0.002
                              and _q(lat, 99) * 1e3 <= LIMIT_P99_MS
                              and _q(lag, 99) * 1e3 <= LIMIT_LAG_MS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="am_flat_1m.zipf_open")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", required=True,
                    help="comma-separated offered rates, lookups/s")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ambench.sweep: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    sys.path.insert(0, str(ROOT / "src"))
    later = json.loads((ROOT / "ambench" / "later.json").read_text())
    bench = registry.merge(registry.benchmark(), later)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    systems = registry.module("systems", cfg["system"])
    inputs = systems.make_inputs(cfg, mix, traffic.seeds(args.seed)["rows"],
                                 device)
    system = systems.System(cfg, mix, inputs, device)
    run.settle()
    print(json.dumps({"card": torch.cuda.get_device_name(device),
                      "workload": args.workload, "seed": args.seed,
                      "seconds": args.seconds}), flush=True)
    rows = []
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        t0 = time.perf_counter()
        row = step(system, mix, inputs.words.shape[0], rate, args.seconds,
                   args.seed + i)
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    knee = None
    for row in rows:
        if not row["sustained"]:
            break
        knee = row["rate_per_s"]
    system.close()
    print(json.dumps({"knee_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

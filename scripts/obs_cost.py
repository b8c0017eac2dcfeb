#!/usr/bin/env python3
"""What the port's tracing (``repro_torch.obs``) costs on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/obs_cost.py [--parent-source OLD.cu]
                                               [--out build/obs_cost.json]
                                               [--host-only]

At the bulk cells' shape (1,024 queries of 128 3-bit symbols against
1,000,000 rows, k = 10 and 100):

1. ``kernel_us``: the partial pass of the fused top-k, device us a launch
   from the profiler's records of 40 launches in one run, every other one
   traced: the traced kernel's own cost.  ``events_ms``: the same by CUDA
   events with no profiler, a whole ``cam_search_topk`` call around runs of
   20 calls, every launch traced against none, 10 rounds in turns; the
   difference over the untraced partial pass of ``kernel_us`` is the
   traced kernel's cost with nothing of the profiler in it.  ``call_ms``:
   a whole ``cam_search_topk`` call by CUDA events around runs of 20 calls, with
   no profiler and under a CPU-only profiler (one launch in
   ``obs.TRACE_EVERY`` traced), 6 rounds in turns: what a profiled run
   costs the card.  ``span_us``: host us of one ``obs.span`` with no
   profiler and under one.
2. ``host_us``: host microseconds an ``am.search`` call takes to return
   (median and mean of 200 calls, a sync every 4), with no profiler, a CPU
   profiler and a CPU and CUDA profiler.
3. With ``--parent-source``: ``nvcc -Xptxas -v`` of that source and of
   ``csrc/cam_search.cu``, each ``cam_topk_partial*`` entry's registers,
   spills and shared memory, and for each untraced entry whether its SASS
   (``cuobjdump -sass``, addresses stripped) is the same in both.

Prints the readings and writes them, with the card's name and power limit,
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

Q, N, D, BITS = 1024, 1_000_000, 128, 3
KS = (10, 100)
#: Calls before a timing; launches profiled for the kernel times; calls a
#: timed run, and rounds of (off, profiled) runs, each side first in every
#: other round; spans timed.
WARMUP_CALLS, LAUNCHES, CALLS, ROUNDS, SPANS = 10, 40, 20, 6, 100_000
#: Rounds of (untraced, traced) runs timed by CUDA events alone.
EVENT_ROUNDS = 10
PARTIAL = "cam_topk_partial"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def inputs(device):
    import torch
    gen = torch.Generator(device=device).manual_seed(2024)
    table = torch.randint(0, 1 << BITS, (N, D), generator=gen, device=device,
                          dtype=torch.int8)
    queries = table[torch.randint(0, N, (Q,), generator=gen,
                                  device=device)].clone()
    queries[::2, :4] = (queries[::2, :4] + 1) % (1 << BITS)
    return table, queries


def kernel_us(table, queries) -> dict:
    """k -> mean device us a launch of the untraced and of the traced
    partial pass, from the profiler's records of ``LAUNCHES`` launches in
    one run, every other one traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels.cam_search import kernel
    vr = torch.full((1,), N, dtype=torch.int32, device=table.device)
    shipped, out = obs.TRACE_EVERY, {}
    try:
        obs.TRACE_EVERY = 2
        for k in KS:
            for _ in range(WARMUP_CALLS):
                kernel.cam_search_topk(queries, table, vr, levels=1 << BITS,
                                       k=k)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(LAUNCHES):
                    kernel.cam_search_topk(queries, table, vr,
                                           levels=1 << BITS, k=k)
                torch.cuda.synchronize()
            row = {}
            for e in prof.key_averages():
                if PARTIAL in e.key and e.count:
                    total = (getattr(e, "device_time_total", 0)
                             or getattr(e, "cuda_time_total", 0))
                    side = "traced" if "traced" in e.key else "untraced"
                    row[side] = {"us": total / e.count, "launches": e.count}
            row["traced_over_untraced"] = (row["traced"]["us"]
                                           / row["untraced"]["us"])
            out[k] = row
            print(f"partial pass k={k}: {row}")
    finally:
        obs.TRACE_EVERY = shipped
    return out


def _timed_calls(kernel, queries, table, vr, k) -> float:
    """ms a ``cam_search_topk`` call, by CUDA events around ``CALLS``
    calls (the card never waits for the host)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CALLS):
        kernel.cam_search_topk(queries, table, vr, levels=1 << BITS, k=k)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / CALLS


def events_ms(table, queries, untraced_us: dict) -> dict:
    """k -> ms a whole call with every launch traced and with none, by
    CUDA events and no profiler (``obs.enabled`` is forced on for the
    traced side, which turns on the counters alone: spans check the
    profiler itself), in ``EVENT_ROUNDS`` rounds in turns; and the traced
    kernel over the untraced one, as the difference of the medians over
    ``untraced_us[k]``, the untraced partial pass's device us."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels.cam_search import kernel
    vr = torch.full((1,), N, dtype=torch.int32, device=table.device)
    shipped, out = (obs.enabled, obs.TRACE_EVERY), {}
    try:
        obs.TRACE_EVERY = 1
        for k in KS:
            def timed(side):
                obs.enabled = ((lambda: True) if side == "traced"
                               else shipped[0])
                return _timed_calls(kernel, queries, table, vr, k)

            for _ in range(2):
                timed("untraced"), timed("traced")
            runs = {"untraced": [], "traced": []}
            for r in range(EVENT_ROUNDS):
                for side in (("untraced", "traced") if r % 2 == 0
                             else ("traced", "untraced")):
                    runs[side].append(timed(side))
            med = {side: statistics.median(v) for side, v in runs.items()}
            row = {**runs, "call_traced_over_untraced":
                   med["traced"] / med["untraced"],
                   "kernel_traced_over_untraced":
                   1 + (med["traced"] - med["untraced"]) * 1e3
                   / untraced_us[k]}
            out[k] = row
            print(f"events k={k}: untraced {runs['untraced']} ms, traced "
                  f"{runs['traced']} ms, call ratio of medians "
                  f"{row['call_traced_over_untraced']:.5f}, partial pass "
                  f"{row['kernel_traced_over_untraced']:.5f}")
    finally:
        obs.enabled, obs.TRACE_EVERY = shipped
        obs.reset()
    return out


def call_ms(table, queries) -> dict:
    """k -> ms a whole ``cam_search_topk`` call by CUDA events around runs
    of ``CALLS`` calls (the card never waits for the host), with no
    profiler and under a CPU-only profiler (one launch in
    ``obs.TRACE_EVERY`` traced), in turns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cam_search import kernel
    vr = torch.full((1,), N, dtype=torch.int32, device=table.device)
    out = {}
    for k in KS:
        def timed():
            return _timed_calls(kernel, queries, table, vr, k)

        for _ in range(WARMUP_CALLS):
            timed()
        runs = {"off": [], "profiled": []}
        for r in range(ROUNDS):
            for side in (("off", "profiled") if r % 2 == 0
                         else ("profiled", "off")):
                if side == "profiled":
                    with profile(activities=[ProfilerActivity.CPU]):
                        runs[side].append(timed())
                else:
                    runs[side].append(timed())
        ratio = (statistics.median(runs["profiled"])
                 / statistics.median(runs["off"]))
        out[k] = {**runs, "profiled_over_off": ratio}
        print(f"call k={k}: off {runs['off']} ms, profiled "
              f"{runs['profiled']} ms, ratio of medians {ratio:.5f}")
    return out


def span_us() -> dict:
    """us a ``with obs.span(...)`` costs the host, with no profiler and
    under a CPU-only profiler (the mean of ``SPANS`` in a loop)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    def loop():
        t0 = time.perf_counter()
        for _ in range(SPANS):
            with obs.span("obs_cost.span"):
                pass
        return (time.perf_counter() - t0) / SPANS * 1e6

    out = {"off": loop()}
    with profile(activities=[ProfilerActivity.CPU]):
        out["cpu_profiler"] = loop()
    print(f"us a span: {out}")
    return out


def host_us(table32) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import am
    dev = table32.codes.device
    out = {}
    for k in KS:
        q = torch.randint(0, 1 << BITS, (Q, D), dtype=torch.int32,
                          device=dev)

        def calls(n=200):
            for _ in range(8):
                am.search(table32, q, k=k, backend="cuda")
            torch.cuda.synchronize()
            us = []
            for i in range(n):
                t0 = time.perf_counter()
                am.search(table32, q, k=k, backend="cuda")
                us.append((time.perf_counter() - t0) * 1e6)
                if i % 4 == 3:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            return {"median": statistics.median(us),
                    "mean": statistics.mean(us)}

        row = {"off": calls()}
        with profile(activities=[ProfilerActivity.CPU]):
            row["cpu_profiler"] = calls()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            row["cpu_cuda_profiler"] = calls()
        out[k] = row
        print(f"host us per am.search, k={k}: {row}")
    return out


def _build(src: Path, out: Path) -> str:
    from repro_torch.kernels import _build as b
    r = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def _key(name: str) -> str | None:
    """A partial-pass entry's mangled name from its kernel's name on (the
    anonymous namespace's part differs between two source files)."""
    i = name.find(PARTIAL)
    return None if i < 0 else name[i:]


def _ptxas(log: str) -> dict:
    """entry -> [lines] of ptxas -v for the partial-pass entries."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)'?", line)
        if m:
            name = _key(m.group(1))
            continue
        if name and ("Used" in line or "spill" in line or "stack" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def _sass(so: Path) -> dict:
    """entry -> instructions (addresses and encodings stripped)."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _key(m.group(1))
            if name:
                out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:      # a call names the anonymous namespace too
            out[name].append(re.sub(r"_GLOBAL__N__\w*?_cu_[0-9a-f]+", "",
                                    m.group(1)))
    return out


def compare_builds(parent_src: Path) -> dict:
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        logs, sass = {}, {}
        for side, src in (("parent", parent_src),
                          ("change", ROOT / "src" / "repro_torch" / "csrc"
                           / "cam_search.cu")):
            so = tmp / f"{side}.so"
            logs[side] = _ptxas(_build(src, so))
            sass[side] = _sass(so)
    out = {"ptxas": logs, "same_sass": {}}
    for name, ins in sass["parent"].items():
        out["same_sass"][name] = (sass["change"].get(name) == ins
                                  and len(ins) > 0)
    for side, entries in logs.items():
        for name, lines in sorted(entries.items()):
            print(f"{side}: {name}: {' | '.join(lines)}")
    print(f"untraced entries with the parent's SASS: "
          f"{sum(out['same_sass'].values())} of {len(out['same_sass'])}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-source", type=Path)
    ap.add_argument("--out", default="build/obs_cost.json")
    ap.add_argument("--host-only", action="store_true",
                    help="time only the host side of am.search (part 2)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("obs_cost: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import am
    result = {"card": card()}
    print(result["card"])
    if args.parent_source is not None:
        (ROOT / "build").mkdir(exist_ok=True)
        result["builds"] = compare_builds(args.parent_source)
    dev = torch.device("cuda", 0)
    table, queries = inputs(dev)
    if not args.host_only:
        result["kernel_us"] = kernel_us(table, queries)
        result["events_ms"] = events_ms(
            table, queries,
            {k: v["untraced"]["us"] for k, v in result["kernel_us"].items()})
        result["call_ms"] = call_ms(table, queries)
        result["span_us"] = span_us()
    table32 = am.make_table(table.to(torch.int32), bits=BITS, device=dev)
    del table
    result["host_us"] = host_us(table32)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The device trace of a run's traced slice, read from ``torch.profiler``.

The profiler records CPU and CUDA activity from just before the window opens
until the slice closes; ``ambench.window`` (a ``record_function`` span)
marks the slice in the trace's own clock.  ``summarize`` reads the exported
Chrome trace: the seconds in which some kernel, copy or fill ran (the union
of their intervals inside the slice), the device time of each kernel name,
and the idle gaps named by what the host was doing at their middle: the
innermost CPU op of any thread, else the client's blocking wait, else the
client's own Python (submits and answers).
"""

from __future__ import annotations

import heapq
import json
from pathlib import Path

WINDOW_SPAN = "ambench.window"
#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Label of a gap with no CPU op and no blocking wait in any thread.
CLIENT = "client python (submit, answers)"


class Tracer:
    """Starts and stops the profiler and the window span around a slice."""

    def __init__(self, out: Path):
        self.out = out
        self._prof = None
        self._span = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._torch = torch

    def stop(self) -> None:
        self._span.__exit__(None, None, None)
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._prof.stop()

    def save(self) -> Path:
        """Write the stopped profile as a Chrome trace; returns its path."""
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.out))
        self._prof = None
        return self.out


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(path: Path, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``device_ops_s`` (every kernel name) and
    the ``breakdown`` lists of the slice in ``path``."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("name") == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"no {WINDOW_SPAN} span in {path}")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    device, host = [], []
    ops: dict[str, float] = {}
    for e in events:
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
                ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
        elif cat in ("cpu_op", "user_annotation") and e["name"] != WINDOW_SPAN:
            if b > w0 and a < w1:
                host.append((a, b, cat == "cpu_op", e["name"]))
    busy = _union(device)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle: dict[str, float] = {}
    host.sort()
    active: list = []                       # heap of (end, start, is_op, name)
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            s, e, is_op, name = host[j]
            heapq.heappush(active, (e, s, is_op, name))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = CLIENT
        if active:
            best = max(active, key=lambda x: (x[2], x[1]))
            label = best[3]
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_ops_s": ops,
            "breakdown": {"device_ops": rank(ops), "idle_gaps": rank(idle)}}

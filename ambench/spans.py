"""The program's spans in a traced slice, read from its Chrome trace.

``run.py`` writes the traced slice's profile to
``<root>/build/ambench/traces/<cell>.json``.  :func:`read` clips it to the
``ambench.window`` span and returns each program span's host intervals
(``record_function`` ranges, category ``user_annotation``, merged over
threads) and the device time of the work launched inside it.

A kernel, copy or fill belongs to the innermost span that encloses, on the
same thread, the runtime or driver call that launched it, matched by the
``correlation`` arg.  Where that call is not in the trace, the work counts
as unlinked: it is never placed by its name.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

from ambench.trace import DEVICE_CATS, WINDOW_SPAN, _union

#: Chrome-trace categories of the host calls that launch device work.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_file(record: dict, root: Path) -> Path:
    """Where ``run.py`` under ``root`` wrote the traced slice of the
    record's cell."""
    return root / "build" / "ambench" / "traces" / f"{record['cell']}.json"


def of_record(record: dict, root: Path) -> dict | None:
    """:func:`read` of the record's trace, or None if the run was not
    traced (so a stale file is never read) or wrote none."""
    if record.get("trace") is None:
        return None
    path = trace_file(record, root)
    return read(path) if path.exists() else None


def read(path: Path) -> dict | None:
    """The slice's spans; None without an ``ambench.window`` span, or where
    the trace links none of the slice's device work to the host.

    ``window_s``; ``busy`` and ``gaps``, the merged intervals (us, the
    trace's clock) in which some device work ran and none did; ``host``,
    span name -> merged host intervals inside the window; ``device_s``,
    span name -> seconds of device work inside the window that the span
    launched (innermost span only; ``None`` for work launched outside any
    span); ``linked_s``, seconds of device work linked by ``correlation``
    and by ``none``.
    """
    path = Path(path)
    st = path.stat()
    return _read(str(path), st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=2)
def _read(path: str, mtime_ns: int, size: int) -> dict | None:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and e.get("cat") == "user_annotation"]
    if not window:
        return None
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    spans: dict[tuple, list] = {}           # thread -> [(a, b, name)]
    launches: dict[int, tuple] = {}         # correlation -> (thread, ts)
    device = []                             # (a, b, correlation)
    for e in events:
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        where = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and e["name"] != WINDOW_SPAN:
            spans.setdefault(where, []).append((a, b, e["name"]))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (where, a)
        elif cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b,
                               (e.get("args") or {}).get("correlation")))

    by_launch = _innermost_at(
        spans, [(launches[c][0], launches[c][1], i)
                for i, (_, _, c) in enumerate(device) if c in launches])
    device_s: dict = {}
    linked = {"correlation": 0.0, "none": 0.0}
    for i, (a, b, _) in enumerate(device):
        s = (b - a) * 1e-6
        if i not in by_launch:
            linked["none"] += s
            continue
        linked["correlation"] += s
        device_s[by_launch[i]] = device_s.get(by_launch[i], 0.0) + s
    if device and not linked["correlation"]:
        return None                     # the trace links no work at all

    busy = _union((a, b) for a, b, _ in device)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    host: dict[str, list] = {}
    for intervals in spans.values():
        for a, b, name in intervals:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                host.setdefault(name, []).append((a, b))
    return {"window_s": (w1 - w0) * 1e-6,
            "busy": [tuple(x) for x in busy], "gaps": gaps,
            "host": {n: [tuple(x) for x in _union(v)]
                     for n, v in host.items()},
            "device_s": device_s, "linked_s": linked}


def _innermost_at(spans: dict, points: list) -> dict:
    """For (where, t, key) points: key -> name of the innermost span of
    ``spans[where]`` that holds t (the latest started; None if none)."""
    out = {}
    by_where: dict = {}
    for where, t, key in points:
        by_where.setdefault(where, []).append((t, key))
    for where, pts in by_where.items():
        order = sorted(spans.get(where, []), key=lambda s: (s[0], -s[1]))
        active: list = []
        j = 0
        for t, key in sorted(pts):
            while j < len(order) and order[j][0] <= t:
                active.append(order[j])
                j += 1
            active = [s for s in active if s[1] >= t]
            out[key] = max(active, key=lambda s: (s[0], -s[1]))[2] \
                if active else None
    return out


def overlap_s(xs: list, ys: list) -> float:
    """Seconds in both of two merged, sorted lists of (a, b) us intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total * 1e-6


def counters() -> dict | None:
    """The program's in-kernel counters (``repro_torch.obs``), which count
    only while a profiler records, so over a traced run's slice; None for
    a program without them."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.counters()

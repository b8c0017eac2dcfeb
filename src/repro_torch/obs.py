"""Tracing of the port: program spans and in-kernel counters.

Both are on exactly while a ``torch.profiler`` (or the autograd profiler)
records, and off otherwise; there is no flag.  An operator who wants them
profiles the program, which is how the spans are read anyway.

* :func:`span` is a ``record_function`` range while a profiler records and
  one shared no-op context otherwise.  The check costs a fraction of a
  microsecond; an idle ``record_function`` costs about ten, so hot paths
  enter only :func:`span`.  Spans land in the profiler's trace beside the
  kernels, on its clock: a kernel launched inside a span, or an idle gap
  of the card while the host was in one, is placed under it, and span
  nesting says which call caused which.
* In-kernel counters are written by a traced variant of a kernel
  (``cam_topk_partial_traced_kernel`` in ``csrc/cam_search.cu``), into one
  device buffer per counter group and device that this module owns.  While
  a profiler records, one launch in :data:`TRACE_EVERY` runs the traced
  variant, which takes a few per cent longer, and the rest the untraced
  one.  :func:`counters` reads the buffers, scaled
  by the launches over the traced launches: the one host sync, made only
  when called.  :func:`reset` zeroes them.

Counters (``<group>.<field>``, summed over the traced launches and scaled
to all of them; ``<group>.launches`` and ``<group>.traced_launches`` count
the launches made while a profiler recorded and those traced):

``cam_topk.votes``
    per-query votes of the fused top-k's partial pass: one a query a
    128-row tile, so Q x ceil(N / 128) a launch.
``cam_topk.inserts``
    the votes that passed, so that the warp offered the tile's rows to the
    query's list (``insert_rows``).
``cam_topk.cycles_compare``, ``cam_topk.cycles_select``
    SM clock cycles, summed over warps, spent in the tile compare
    (``tile_counts``, with its loads) and in the rest of each tile: the
    distance store, two barriers, the vote and the inserts.
``cam_topk.offered``
    the keys those votes offered to the lists: the tile's rows below the
    list's largest key when ``insert_rows`` was called (below the largest
    key as each key came, up to k = 32, where they go in one at a time).
    Above k = 32 one merge takes a vote's keys at once, so offered over
    inserts is how many single inserts each merge stands for.
"""

from __future__ import annotations

import contextlib
import threading

import torch

#: The counter groups and their fields, in the order kernels write them.
COUNTERS = {"cam_topk": ("votes", "inserts", "cycles_compare",
                         "cycles_select", "offered")}

#: While a profiler records, one launch in this many runs traced.
TRACE_EVERY = 8

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def enabled() -> bool:
    """True while a profiler records: spans and counters are on."""
    return _profiling()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared no-op context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _Counters:
    """Device buffers of the in-kernel counters, one per group and device,
    and the launches of each group made while a profiler recorded."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bufs: dict[tuple[str, torch.device], torch.Tensor] = {}
        self._launches = {g: [0, 0] for g in COUNTERS}   # [made, traced]

    def launch_buffer(self, group: str,
                      device: torch.device) -> torch.Tensor | None:
        """For a launch of ``group`` made while a profiler records: the
        int64 buffer (one word a field of ``COUNTERS[group]``, zeros at
        first) that a traced launch adds into, for one launch in
        :data:`TRACE_EVERY`, the first included; else None."""
        key = (group, torch.device(device))
        with self._lock:
            made = self._launches[group]
            made[0] += 1
            if (made[0] - 1) % TRACE_EVERY:
                return None
            made[1] += 1
            buf = self._bufs.get(key)
            if buf is None:
                buf = torch.zeros(len(COUNTERS[group]), dtype=torch.int64,
                                  device=key[1])
                self._bufs[key] = buf
            return buf

    def read(self) -> dict[str, int]:
        """Every counter, summed over devices and scaled by the group's
        launches over its traced launches (a host sync per buffer)."""
        with self._lock:
            bufs = list(self._bufs.items())
            launches = {g: list(v) for g, v in self._launches.items()}
        raw = {g: [0] * len(fields) for g, fields in COUNTERS.items()}
        for (group, _), buf in bufs:
            raw[group] = [a + b for a, b in zip(raw[group], buf.tolist())]
        out = {}
        for group, fields in COUNTERS.items():
            made, traced = launches[group]
            for field, v in zip(fields, raw[group]):
                out[f"{group}.{field}"] = (v * made // traced if traced
                                           else 0)
            out[f"{group}.launches"] = made
            out[f"{group}.traced_launches"] = traced
        return out

    def reset(self) -> None:
        with self._lock:
            for buf in self._bufs.values():
                buf.zero_()
            for made in self._launches.values():
                made[:] = [0, 0]


_counters = _Counters()
launch_buffer = _counters.launch_buffer
counters = _counters.read
reset = _counters.reset

"""Shared benchmark utilities of the port: timing + CSV emission.

Port of ``benchmarks/common.py``: :func:`time_call` blocks on the card with
``torch.cuda.synchronize()`` where the reference blocks on JAX's outputs.
"""

from __future__ import annotations

import time

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_call(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall time per call in microseconds (synchronises the card
    after every call, so queued kernels are inside the time)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)

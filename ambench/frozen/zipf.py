"""Zipf key sampler.

Copied from ``torch_benchmarks/bench_am_serve.py`` (``zipf_probs`` and its
``rng.choice(population, size, p=probs)``); ranks map to words through a
seeded permutation, so the hottest word differs from seed to seed.
"""

from __future__ import annotations

import numpy as np


def zipf_probs(population: int, s: float) -> np.ndarray:
    """Probability of each rank 1..population under Zipf(s)."""
    ranks = np.arange(1, population + 1, dtype=np.float64)
    p = ranks ** -s
    return p / p.sum()


def zipf_keys(rng: np.random.Generator, population: int, s: float,
              size: int, order: np.ndarray) -> np.ndarray:
    """``size`` keys: Zipf(s) ranks, rank r read as word ``order[r]``."""
    ranks = rng.choice(population, size=size, p=zipf_probs(population, s))
    return order[ranks]

"""The one generator of lookup traffic, driven by a mix's parameter file.

A mix (``traffic/<name>.json``) gives:

* ``loop``: ``"closed"`` (``outstanding`` lookups always in flight, the next
  sent when the oldest resolves), ``"open"`` (Poisson arrivals at
  ``rate_per_s``, sent when due whatever the backlog) or ``"batch"``
  (``batches_in_flight`` batches of ``batch_lookups`` lookups, the next
  launched when the oldest is read back);
* ``keys``: ``"uniform"`` or ``"zipf"`` (with ``zipf_s``) over the query
  population, one word per stored row;
* ``exact_share``: the share of the population that is a stored word;
  the rest have ``perturbed_symbols`` symbols changed;
* ``k``: the neighbours each lookup asks for;
* ``warmup_lookups`` (closed), ``warmup_batches`` (batch) or ``warmup_s``
  (open): the set-up's share of the same traffic.

An open loop's arrivals in a window are ``round(rate * seconds)`` times,
uniform over the window and sorted: a Poisson process given its count, so
every seed offers the same number of lookups.
"""

from __future__ import annotations

import numpy as np

from ambench.frozen.zipf import zipf_keys

#: Keys drawn at a time by a closed loop's stream.
_BLOCK = 1 << 16


def seeds(seed: int) -> dict[str, int]:
    """Independent sub-seeds of one run's ``--seed``."""
    names = ("rows", "keys", "arrivals", "warmup", "warmup_arrivals",
             "sample", "order")
    state = np.random.SeedSequence(seed).generate_state(len(names),
                                                        np.uint64)
    return {n: int(s) for n, s in zip(names, state)}


class Keys:
    """Keys of one mix over a population of ``population`` words."""

    def __init__(self, mix: dict, population: int, seed: int,
                 order_seed: int):
        self.mix = mix
        self.population = population
        self.rng = np.random.default_rng(seed)
        self.order = (np.random.default_rng(order_seed).permutation(
            population) if mix["keys"] == "zipf" else None)
        if mix["keys"] not in ("uniform", "zipf"):
            raise ValueError(f"unknown key distribution {mix['keys']!r}")
        self._buf = np.empty(0, np.int64)
        self._at = 0

    def draw(self, size: int) -> np.ndarray:
        """The next ``size`` keys."""
        if self.mix["keys"] == "uniform":
            return self.rng.integers(0, self.population, size)
        return zipf_keys(self.rng, self.population, self.mix["zipf_s"], size,
                         self.order)

    def next(self) -> int:
        """One key, for a loop that does not know how many it will send."""
        if self._at == self._buf.size:
            self._buf, self._at = self.draw(_BLOCK), 0
        self._at += 1
        return int(self._buf[self._at - 1])


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Sorted due times in [0, seconds) of an open loop at ``rate``/s."""
    n = int(round(rate * seconds))
    return np.sort(np.random.default_rng(seed).uniform(0.0, seconds, n))

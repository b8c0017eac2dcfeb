"""The AM lookup path of ``repro_torch`` as the system under test.

An open or closed loop of single lookups drives the service (``System``); a
batch loop drives the table's batched search (``TableSearch``), as a bulk
job that holds its queries calls it.  ``open_system`` picks by the mix's
``loop``.

The service: one ``AMService`` with one table, built from a configuration
file:
``table`` (rows, width, bits, distance, capacity, policy, backend,
fill_chunk), ``index`` (an ``IndexSpec``'s fields, or null) and ``service``
(max_batch, flush_after_s, max_in_flight).  The service runs its background
driver; a lookup is ``submit`` and then ``PendingSearch.result()`` once
``PendingSearch.done`` says it is answered, timed by the client.  The
inputs are the benchmark's own: stored rows and a query population of one
word per row, made on the device from the seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ambench.frozen import workload

TABLE = "cells"


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands to the program and to the reference."""

    stored: np.ndarray         # (N, D) int8 stored rows
    words: np.ndarray          # (N, D) int32 query population


#: Seed of the stored rows.  Every run holds the same rows, in the order
#: its own seed draws: the index tier's sets, and so the work and memory of
#: a run, would otherwise change with the seed.
ROWS_SEED = 0x5EEC4A3


def make_inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    """Rows uniform over the levels (one fixed set, put in the seed's order);
    a seeded ``exact_share`` of the words are their rows, the rest have
    ``perturbed_symbols`` symbols changed."""
    t = config["table"]
    n, levels = t["rows"], 1 << t["bits"]
    gen = torch.Generator(device=device)
    gen.manual_seed(ROWS_SEED)
    rows = torch.randint(0, levels, (n, t["width"]), generator=gen,
                         device=device, dtype=torch.int8)
    gen.manual_seed(seed)
    rows = rows[torch.randperm(n, generator=gen, device=device)]
    moved = torch.randperm(n, generator=gen, device=device)[
        int(round(n * mix["exact_share"])):]
    words = rows.clone()
    words[moved] = workload.perturb(rows[moved], mix["perturbed_symbols"],
                                    levels, gen)
    return Inputs(stored=rows.cpu().numpy(),
                  words=words.to(torch.int32).cpu().numpy())


class System:
    """The service, filled and driven; ``submit``/``wait`` are one lookup."""

    def __init__(self, config: dict, mix: dict, inputs: Inputs, device):
        from repro_torch.index import IndexSpec
        from repro_torch.kernels.cam_search.kernel import launches
        from repro_torch.serve import AMService

        t, s = config["table"], config["service"]
        self._launches = launches
        self.k = mix["k"]
        self.words = inputs.words
        self.svc = AMService(time_fn=time.monotonic,
                             max_batch=s["max_batch"],
                             flush_after=s["flush_after_s"], device=device)
        index = config.get("index")
        self.svc.create_table(
            TABLE, width=t["width"], bits=t["bits"], distance=t["distance"],
            capacity=t["capacity"], policy=t["policy"], backend=t["backend"],
            index=None if index is None else IndexSpec(**index))
        workload.fill(lambda codes, values: self.svc.append(
            TABLE, codes, values=values), inputs.stored, t["fill_chunk"])
        if index is not None and not self.svc.stats(TABLE)["index"]["built"]:
            raise RuntimeError("the index was not built by the fill")
        self.svc.start_driver(max_in_flight=s["max_in_flight"])

    def submit(self, key: int):
        return self.svc.submit(TABLE, self.words[key], k=self.k)

    @staticmethod
    def done(handle) -> bool:
        return handle.done

    @staticmethod
    def wait(handle, timeout: float | None = None):
        return handle.result(timeout)

    def counters(self) -> dict:
        """The program's own counters: groups read back, lookups
        dispatched, of those resolved from a shared row, launches."""
        svc = self.svc
        return {"groups": svc.readbacks, "dispatched": svc.dispatched,
                "dedup_hits": svc.dedup_hits,
                "launches": dict(self._launches)}

    def close(self) -> None:
        self.svc.stop_driver(drain=True)
        self.svc.drop_table(TABLE)
        self.svc = None


class Answer:
    """One lookup's answer in the service's shape, from a batch's arrays:
    an exact hit's payload is its row id, as the service's fill stores."""

    __slots__ = ("indices", "distances", "exact", "matched", "value")

    def __init__(self, indices, distances, exact, matched):
        self.indices, self.distances = indices, distances
        self.exact, self.matched = exact, matched
        self.value = int(indices[0]) if exact[0] else None


class TableSearch:
    """The configuration's table as one ``AMTable`` of the stored rows,
    searched a batch at a time by ``am.search`` on the table's backend;
    ``search(keys)`` launches one batch, ``answers`` reads it back."""

    def __init__(self, config: dict, mix: dict, inputs: Inputs, device):
        from repro_torch.core import am

        if config.get("index") is not None:
            raise ValueError("a batch loop searches a flat table only")
        t = config["table"]
        self._am = am
        self.k = mix["k"]
        self.words = inputs.words
        self.backend = t["backend"]
        self.device = torch.device(device)
        self.table = am.make_table(inputs.stored.astype(np.int32),
                                   bits=t["bits"], distance=t["distance"],
                                   device=self.device)
        self.batches = self.lookups = 0

    def search(self, keys: np.ndarray):
        """Launch the search of ``keys``' words; a handle, no host sync."""
        q = torch.from_numpy(self.words[keys]).to(self.device,
                                                  non_blocking=True)
        r = self._am.search(self.table, q, k=self.k, backend=self.backend)
        host = tuple(_to_host(a) for a in (r.indices, r.distances, r.exact,
                                           r.matched))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.batches += 1
        self.lookups += len(keys)
        return event, host

    @staticmethod
    def done(handle) -> bool:
        return handle[0] is None or handle[0].query()

    @staticmethod
    def answers(handle) -> tuple:
        """The batch's arrays, read back: indices, distances, exact and
        matched flags, a row a lookup."""
        event, host = handle
        if event is not None:
            event.synchronize()
        return tuple(a.numpy() for a in host)

    @staticmethod
    def unpack(arrays) -> list:
        """A batch's arrays as one :class:`Answer` a lookup."""
        return [Answer(*row) for row in zip(*arrays)]

    def counters(self) -> dict:
        """Batches and lookups launched (one group a batch, no sharing)."""
        return {"groups": self.batches, "dispatched": self.lookups,
                "dedup_hits": 0, "launches": {}}

    def close(self) -> None:
        self.table = None


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy of ``t`` into pinned host memory."""
    if t.device.type != "cuda":
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=True).copy_(t, non_blocking=True)


def open_system(config: dict, mix: dict, inputs: Inputs, device):
    """The system a mix's loop drives: the table's batched search for a
    batch loop, the service otherwise."""
    make = TableSearch if mix["loop"] == "batch" else System
    return make(config, mix, inputs, device)

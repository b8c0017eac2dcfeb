"""The served HDC classifier of ``repro_torch`` as the system under test.

A bulk inference job scores a stream of feature vectors against the class
hypervectors held in the CAM: ``hdc.classify`` on a ``Classifier`` built
once, a batch at a time (the fused encode + quantize kernel, then the L1
search of the class table).  The configuration file gives ``table``
(features, classes, dim, bits, distance, backend), ``population`` (the
feature vectors a job draws from) and ``projection_seed``.

The inputs are the benchmark's own, from the frozen ISOLET stand-in
(``ambench/frozen/hdc_standin.py``): the projection N(0, 1) from a fixed
seed; the class codes from one pass over the stand-in's training rows,
Z-quantized over the whole class matrix; and the feature store, drawn from
the stand-in's mixture on the device from the run's seed.  The store stays
on the device, and a batch sends only its key ids there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ambench.frozen import hdc_standin


class Model(NamedTuple):
    """What the device holds of the classifier."""

    codes: torch.Tensor        # (K, D) int32 class level codes
    projection: torch.Tensor   # (n, D) float32


class Inputs(NamedTuple):
    """What the benchmark hands to the program and to the reference."""

    stored: Model              # the class codes and the projection
    words: torch.Tensor        # (population, n) float32 feature store


def projection(features: int, dim: int, seed: int) -> np.ndarray:
    """(features, dim) float32, N(0, 1) from ``seed``."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.standard_normal((features, dim), dtype=np.float32)


def class_codes(proj: np.ndarray, data: dict) -> np.ndarray:
    """(K, D) int32 codes of the class hypervectors: each class's training
    rows summed through the projection (one pass, no retraining), then the
    Z-score quantizer over the whole class matrix."""
    y = data["y_train"]
    sums = np.zeros((hdc_standin.CLASSES, proj.shape[0]))
    np.add.at(sums, y, data["x_train"].astype(np.float64))
    return hdc_standin.zscore_codes(sums @ proj.astype(np.float64))


def make_inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    """The classifier's model (the same in every run) and a feature store
    of ``population`` rows drawn from the stand-in's mixture: a class
    uniform at random, its centre plus the noise through the mixing."""
    t = config["table"]
    if (t["features"], t["classes"]) != (hdc_standin.FEATURES,
                                         hdc_standin.CLASSES):
        raise ValueError("the stand-in has 617 features and 26 classes")
    data = hdc_standin.dataset()
    proj = projection(t["features"], t["dim"], config["projection_seed"])
    codes = class_codes(proj, data)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = config["population"]
    centers = torch.from_numpy(data["centers"]).float().to(dev)
    mixing = torch.from_numpy(data["mix"]).float().to(dev)
    y = torch.randint(0, t["classes"], (n,), generator=gen, device=dev)
    eps = torch.randn((n, t["features"]), generator=gen, device=dev)
    words = centers[y] + hdc_standin.NOISE * (eps @ mixing)
    return Inputs(stored=Model(torch.from_numpy(codes).to(dev),
                               torch.from_numpy(proj).to(dev)),
                  words=words)


class Answer:
    """One lookup's answer: its class ids and L1 distances, nearest
    first."""

    __slots__ = ("indices", "distances")

    def __init__(self, indices, distances):
        self.indices, self.distances = indices, distances


class Classify:
    """``hdc.classify`` on the configuration's classifier, a batch at a
    time: ``search(keys)`` launches one batch, ``answers`` reads it back."""

    def __init__(self, config: dict, mix: dict, inputs: Inputs, device):
        from repro_torch.core import hdc

        t = config["table"]
        self._hdc = hdc
        self.k = mix["k"]
        self.backend = t["backend"]
        self.device = torch.device(device)
        self.words = inputs.words
        self.clf = hdc.make_classifier(
            inputs.stored.projection, inputs.stored.codes, bits=t["bits"],
            distance=t["distance"], device=self.device)
        # Keys go up from pinned buffers, one a batch in flight and one
        # spare: a buffer is reused only after its batch was read back.
        on_card = self.device.type == "cuda"
        self._keys = [torch.empty(mix["batch_lookups"], dtype=torch.int64,
                                  pin_memory=on_card)
                      for _ in range(mix["batches_in_flight"] + 1)]
        self.batches = self.lookups = 0

    def search(self, keys: np.ndarray):
        """Launch the classification of ``keys``' feature vectors; a
        handle, no host sync."""
        buf = self._keys[self.batches % len(self._keys)][:len(keys)]
        buf.numpy()[:] = keys
        x = self.words.index_select(0, buf.to(self.device, non_blocking=True))
        r = self._hdc.classify(self.clf, x, k=self.k, backend=self.backend)
        host = (_to_host(r.indices), _to_host(r.distances))
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
        """The batch's arrays, read back: class ids and distances, a row a
        lookup."""
        event, host = handle
        if event is not None:
            event.synchronize()
        return tuple(a.numpy() for a in host)

    @staticmethod
    def unpack(arrays) -> list:
        """A batch's arrays as one :class:`Answer` a lookup."""
        return [Answer(*row) for row in zip(*arrays)]

    def counters(self) -> dict:
        """Batches and lookups launched (one group a batch)."""
        return {"groups": self.batches, "dispatched": self.lookups,
                "dedup_hits": 0, "launches": {}}

    def close(self) -> None:
        self.clf = None


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy of ``t`` into pinned host memory."""
    if t.device.type != "cuda":
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=True).copy_(t, non_blocking=True)


def open_system(config: dict, mix: dict, inputs: Inputs, device):
    """The batch classifier; a classifier serves batches only."""
    if mix["loop"] != "batch":
        raise ValueError("the HDC classifier is driven by a batch loop")
    return Classify(config, mix, inputs, device)

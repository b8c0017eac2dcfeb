"""Deterministic synthetic LM token pipeline.

A copy of :mod:`repro.data.lm_synth` (numpy only), so the port's batches
are bitwise the reference's for every ``(seed, step, shard, n_shards)``.
Produces Zipf-distributed packed token streams with document boundaries;
every batch is a pure function of (seed, step, dp_rank), so checkpoint
resume and elastic rescaling reproduce the exact stream with no data-state
files.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataCfg:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    mean_doc_len: int = 512
    bos_id: int = 1


def batch_at(cfg: LMDataCfg, step: int, shard: int = 0,
             n_shards: int = 1) -> dict[str, np.ndarray]:
    """The shard's slice of global batch ``step``: tokens/labels/mask."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    b_local = cfg.global_batch // n_shards
    rng = np.random.Generator(np.random.PCG64(
        [cfg.seed, step, shard]))
    # Zipf over the vocab, clipped, with BOS-delimited documents packed in.
    tok = rng.zipf(cfg.zipf_a, size=(b_local, cfg.seq_len + 1))
    tok = (tok - 1) % (cfg.vocab_size - 2) + 2
    doc_break = rng.random((b_local, cfg.seq_len + 1)) < 1.0 / cfg.mean_doc_len
    tok = np.where(doc_break, cfg.bos_id, tok).astype(np.int32)
    return {
        "tokens": tok[:, :-1],
        "labels": tok[:, 1:],
        "mask": np.ones((b_local, cfg.seq_len), np.float32),
    }


class Prefetcher:
    """Background-thread prefetch of the next N batches."""

    def __init__(self, cfg: LMDataCfg, start_step: int = 0, depth: int = 2,
                 shard: int = 0, n_shards: int = 1):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = batch_at(cfg, step, shard, n_shards)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()

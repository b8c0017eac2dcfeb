"""Continuous-batching request scheduler (a numpy-only copy of
:mod:`repro.serve.scheduler`).

vLLM-style slot management on one decode step: requests queue,
claim freed slots mid-flight (no batch barrier) and retire on EOS/length.
Prompt prefill happens *in-band*: an admitted slot teacher-forces its prompt
tokens through the shared decode stream (chunk size 1) while other slots
keep generating — per-slot positions + active masks in the engine make this
exact (inactive/prefilling slots never pollute each other's KV).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S0,) int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    prompt_cursor: int = 0             # next prompt token to feed
    remaining: int = 0


class ContinuousBatcher:
    """Drives an :class:`repro_torch.serve.engine.Engine` with rolling
    admission."""

    def __init__(self, engine, eos_id: int | None = None):
        self.engine = engine
        self.eos_id = eos_id
        self.slots = [_Slot() for _ in range(engine.batch)]
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self._next = np.zeros((engine.batch,), np.int32)
        self.ticks = 0

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.request is None and self.queue:
                req = self.queue.popleft()
                slot.request = req
                slot.prompt_cursor = 0
                slot.remaining = req.max_new_tokens

    def _tick(self) -> None:
        feed = self._next.copy()
        active = np.zeros((self.engine.batch,), bool)
        prefilling = np.zeros((self.engine.batch,), bool)
        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None:
                continue
            active[i] = True
            if slot.prompt_cursor < len(req.prompt):
                feed[i] = int(req.prompt[slot.prompt_cursor])
                slot.prompt_cursor += 1
                prefilling[i] = slot.prompt_cursor < len(req.prompt)
        logits = self.engine.step_logits(feed, active)
        ids = np.argmax(logits, axis=-1)
        self.ticks += 1

        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None or not active[i]:
                continue
            if prefilling[i]:
                continue               # mid-prompt: output ignored
            tok = int(ids[i])
            req.generated.append(tok)
            slot.remaining -= 1
            self._next[i] = tok
            if slot.remaining <= 0 or (self.eos_id is not None
                                       and tok == self.eos_id):
                req.done = True
                self.completed.append(req)
                slot.request = None
                self._next[i] = 0

    def run(self, max_ticks: int = 10_000) -> list:
        """Run until queue + slots drain (or tick budget)."""
        for _ in range(max_ticks):
            self._admit()
            if not self.queue and all(s.request is None for s in self.slots):
                break
            self._tick()
        return self.completed

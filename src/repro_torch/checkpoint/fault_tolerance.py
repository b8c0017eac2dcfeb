"""Fault-tolerance runtime: watchdog, straggler monitor, preemption handling,
fault injection, and the restartable training loop that composes them.

Port of :mod:`repro.checkpoint.fault_tolerance` on the port's
:class:`~repro_torch.checkpoint.checkpointer.Checkpointer`.  The loop's
contract:

* every N steps an **async** checkpoint is committed atomically;
* a **watchdog** deadline per step turns hangs into exceptions;
* on any exception the loop restores the latest checkpoint and replays —
  the data pipeline is a pure function of step, so replay is exact;
* SIGTERM triggers a synchronous save before exit (preemption);
* per-step wall times feed a **straggler monitor** whose flags a scheduler
  would use to re-shard or evict (here: logged + queryable).

The port's train steps update their state in place, so a restart that
finds no checkpoint cannot go back to the state the loop was given: pass
``init_state`` as a function that makes a fresh state, and the loop calls
it at the start and at every such restart.  Restored leaves go to the
device of the state's first tensor.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Any, Callable

from repro_torch.checkpoint.checkpointer import Checkpointer, \
    leaves_with_paths


class StepWatchdog:
    """Raises in the main thread (via exception flag) if a step exceeds its
    deadline — converts silent hangs into restartable failures."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._timer: threading.Timer | None = None
        self.fired = threading.Event()

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self.fired.set)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer:
            self._timer.cancel()
        return False

    def check(self):
        if self.fired.is_set():
            raise TimeoutError(
                f"step exceeded watchdog deadline of {self.timeout_s}s")


class StragglerMonitor:
    """Flags steps slower than median * threshold over a sliding window."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float):
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        if len(self.times) >= 10 and dt > self.threshold * med:
            self.flagged.append((step, dt))
            return True
        return False


@dataclasses.dataclass
class LoopReport:
    final_step: int
    restarts: int
    straggler_flags: list
    losses: list


class FaultTolerantLoop:
    """Restartable training loop.

    ``init_state``: the state to start from, or a zero-argument function
    that makes one (see the module docstring; a state given as such serves
    one start only).  ``fault_injector(step)``: test hook; raise to
    simulate a failure at a given step.  The loop must converge to the
    same final state as a clean run.
    """

    def __init__(self, step_fn: Callable, init_state: Any,
                 batch_fn: Callable[[int], Any], ckpt: Checkpointer,
                 ckpt_every: int = 10, watchdog_s: float = 300.0,
                 max_restarts: int = 5,
                 fault_injector: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.init_state = init_state
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.watchdog_s = watchdog_s
        self.max_restarts = max_restarts
        self.fault_injector = fault_injector
        self.straggler = StragglerMonitor()
        self._preempted = threading.Event()
        self._started = False

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted.set()
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on main thread (tests)

    def run(self, num_steps: int) -> tuple[Any, LoopReport]:
        self._install_signal_handlers()
        restarts = 0
        losses: list[float] = []
        state, start = self._restore_or_init(None)

        step = start
        while step < num_steps:
            try:
                t0 = time.time()
                with StepWatchdog(self.watchdog_s) as wd:
                    if self.fault_injector is not None:
                        self.fault_injector(step)
                    batch = self.batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    wd.check()
                dt = time.time() - t0
                self.straggler.record(step, dt)
                losses.append(float(metrics["loss"]))
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, state, {"step": step})
            except (Exception, KeyboardInterrupt):
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                state, step = self._restore_or_init(state)
            if self._preempted.is_set():
                self.ckpt.wait()
                self.ckpt.save(step, state, {"step": step, "preempted": True})
                break

        self.ckpt.wait()
        self.ckpt.save(step, state, {"step": step})
        return state, LoopReport(final_step=step, restarts=restarts,
                                 straggler_flags=self.straggler.flagged,
                                 losses=losses)

    def _fresh_state(self):
        if callable(self.init_state):
            return self.init_state()
        if self._started:
            raise RuntimeError(
                "no checkpoint to restart from, and the state the loop was "
                "given has been updated in place; pass init_state as a "
                "function that makes a fresh one")
        self._started = True
        return self.init_state

    def _restore_or_init(self, template):
        """(state, step): the latest checkpoint restored into the
        structure of ``template`` (a fresh state when None), else a fresh
        state at step 0."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return self._fresh_state(), 0
        if template is None:
            template = self._fresh_state()
        device = leaves_with_paths(template)[0][1].device
        state, meta = self.ckpt.restore(template, device=device)
        return state, int(meta["step"])

"""Fault tolerance at 1000+ node scale: heartbeats, stragglers, restart.

The container is a single host, so node failure and stragglers are
*injected*: the coordinator tracks per-worker heartbeats and per-stage
timing EMAs, a FailureInjector flips workers dead/slow according to a
schedule, and the policies below decide requeue/restart.  The same
coordinator logic drives the real multi-host deployment (heartbeats over
the JAX distributed client), so the policies are tested here and reused
there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float = 0.0
    alive: bool = True
    slow_factor: float = 1.0


@dataclass
class StragglerDetector:
    """EMA of per-stage durations; flags samples > threshold x EMA."""
    alpha: float = 0.2
    threshold: float = 3.0
    ema: dict = field(default_factory=dict)

    def observe(self, stage: str, duration: float) -> bool:
        prev = self.ema.get(stage)
        is_straggler = prev is not None and duration > self.threshold * prev
        # stragglers don't poison the EMA
        if not is_straggler:
            self.ema[stage] = (duration if prev is None
                               else self.alpha * duration + (1 - self.alpha) * prev)
        return is_straggler


class FailureInjector:
    """Deterministic failure/slowdown schedule keyed by (step, worker)."""

    def __init__(self, kill_at: dict[int, int] | None = None,
                 slow_at: dict[int, tuple[int, float]] | None = None):
        self.kill_at = kill_at or {}
        self.slow_at = slow_at or {}

    def apply(self, step: int, workers: dict[int, WorkerState]):
        if step in self.kill_at:
            workers[self.kill_at[step]].alive = False
        if step in self.slow_at:
            wid, f = self.slow_at[step]
            workers[wid].slow_factor = f


class Coordinator:
    """Detects dead workers via heartbeat timeout; decides restart points.

    Policy: on worker death -> restore from the latest checkpoint with the
    surviving worker set (elastic mesh reshape, see checkpoint.restore);
    on straggler -> requeue its work item (data path) or proceed without
    its gradient contribution for one step (compute path, bounded count).
    """

    def __init__(self, n_workers: int, heartbeat_timeout: float = 5.0,
                 clock=None):
        """``clock`` makes failure detection deterministic: pass an engine
        ``VirtualClock`` (its ``makespan`` is the time source) or any
        zero-arg callable returning seconds; None keeps wall-clock
        ``time.monotonic`` for live deployments."""
        self.workers = {i: WorkerState(i) for i in range(n_workers)}
        self.timeout = heartbeat_timeout
        self.detector = StragglerDetector()
        self.events: list = []
        if clock is None:
            self._now = time.monotonic
        elif callable(clock):
            self._now = clock
        else:
            self._now = clock.makespan

    def _t(self, now: float | None) -> float:
        # explicit None check: virtual time legitimately starts at 0.0,
        # which a truthiness test would silently replace with wall-clock
        return self._now() if now is None else now

    def heartbeat(self, worker_id: int, now: float | None = None):
        self.workers[worker_id].last_heartbeat = self._t(now)

    def dead_workers(self, now: float | None = None) -> list[int]:
        now = self._t(now)
        return [w.worker_id for w in self.workers.values()
                if not w.alive or now - w.last_heartbeat > self.timeout]

    def step_plan(self, step: int, now: float | None = None) -> dict:
        """Decide the action for this step given current health."""
        dead = self.dead_workers(now)
        if dead:
            survivors = [w for w in self.workers if w not in dead]
            self.events.append(("restart", step, tuple(dead)))
            return {"action": "restore_and_reshape",
                    "survivors": survivors, "dead": dead}
        return {"action": "proceed"}

    def observe_stage(self, step: int, stage: str, duration: float,
                      worker_id: int = 0) -> dict:
        if self.detector.observe(stage, duration):
            self.events.append(("straggler", step, stage, worker_id))
            return {"action": "requeue", "stage": stage, "worker": worker_id}
        return {"action": "ok"}

"""SLO-aware admission + open-loop workload generation for GNN serving.

Requests carry a priority class with a virtual latency budget.  The
scheduler forms micro-batches under a size/time window: a batch closes as
soon as ``max_requests`` are available or the window elapses past the
earliest queued arrival.  Higher-priority (lower ``level``) requests are
packed first; requests whose queue delay has already blown their budget
are shed *at admission*, before any sampling or IO is spent on them.

All times are virtual seconds on the ``core.simulator`` envelope — the
server schedules batch work on a ``VirtualClock``, so queueing delay and
tail percentiles follow the paper's hardware ratios.
"""
from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class PriorityClass:
    name: str
    level: int                  # lower = more urgent; packed first
    budget_v: float             # end-to-end virtual latency budget (s)


INTERACTIVE = PriorityClass("interactive", 0, 2e-3)
BULK = PriorityClass("bulk", 1, 50e-3)


@dataclass(eq=False)          # identity equality: seeds arrays don't compare
class ServeRequest:
    seeds: np.ndarray           # unique vertex ids to classify
    arrival_v: float            # open-loop virtual arrival time
    klass: PriorityClass = INTERACTIVE
    future: Future = field(default_factory=Future)
    rid: int = 0


class SLOScheduler:
    """Micro-batch formation with priority packing and deadline shedding."""

    def __init__(self, window_v: float = 1e-3, max_requests: int = 8):
        self.window_v = window_v
        self.max_requests = max_requests
        self.est_service_v = 0.0        # EWMA of observed batch service
        self._queue: list[ServeRequest] = []

    def __len__(self) -> int:
        return len(self._queue)

    def enqueue(self, req: ServeRequest):
        self._queue.append(req)

    def observe_service(self, service_v: float):
        """Feed back a completed batch's service time; admission sheds
        requests whose queue delay + expected service already exceeds
        their budget, so doomed work is never sampled or fetched."""
        self.est_service_v = (service_v if not self.est_service_v
                              else 0.5 * self.est_service_v + 0.5 * service_v)

    # ------------------------------------------------------------------
    def next_batch(self, now_v: float):
        """Form the next micro-batch.

        Returns ``(admitted, start_v, rejected)``: requests packed into the
        batch, the virtual time the batch starts (window close or, under
        backlog, when the server frees up), and requests shed because their
        budget was already exhausted by queueing delay.
        """
        if not self._queue:
            return [], now_v, []
        t0 = min(r.arrival_v for r in self._queue)
        close = t0 + self.window_v
        ready = [r for r in self._queue if r.arrival_v <= max(close, now_v)]
        ready.sort(key=lambda r: (r.klass.level, r.arrival_v, r.rid))
        if len(ready) >= self.max_requests:
            # size window filled first: start as soon as enough requests
            # have arrived (no need to wait the full time window)
            start_v = max(now_v, ready[self.max_requests - 1].arrival_v)
        else:
            start_v = max(now_v, close)
        # shed-then-pack: expired requests must not consume batch slots —
        # under overload, slots they would have wasted are backfilled with
        # in-budget requests so batch occupancy stays full
        admitted, rejected = [], []
        for r in ready:
            if start_v - r.arrival_v + self.est_service_v > r.klass.budget_v:
                self._queue.remove(r)
                rejected.append(r)
            elif len(admitted) < self.max_requests:
                self._queue.remove(r)
                admitted.append(r)
        if admitted:
            start_v = max(start_v, max(r.arrival_v for r in admitted))
        return admitted, start_v, rejected


# ---------------------------------------------------------------------------
# Open-loop workload generation
# ---------------------------------------------------------------------------

def zipf_workload(n_vertices: int, n_requests: int, seeds_per_request: int,
                  rate_rps: float, skew: float = 1.2,
                  degrees: np.ndarray | None = None,
                  classes: tuple = (INTERACTIVE, BULK),
                  class_mix: tuple = (0.5, 0.5), seed: int = 0):
    """Open-loop request trace with Zipf-skewed seed popularity.

    Arrivals are Poisson at ``rate_rps`` (virtual), independent of service
    times (open loop: a slow server accumulates backlog instead of slowing
    the arrival process).  Seed popularity follows ``degrees`` when given —
    matching ``synth_graph``'s degree skew exactly, so concurrent requests
    share hot neighborhoods the way production traffic over a power-law
    graph does — else a Zipf(``skew``) over a random vertex permutation.

    Returns a list of ``(seeds, arrival_v, klass)`` tuples sorted by
    arrival.
    """
    rng = np.random.default_rng(seed)
    if degrees is not None:
        pop = degrees.astype(np.float64) + 1.0
    else:
        ranks = rng.permutation(n_vertices)
        pop = (ranks + 1.0) ** (-skew)
    pop = pop / pop.sum()
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    mix = np.asarray(class_mix, np.float64)
    mix = mix / mix.sum()
    which = rng.choice(len(classes), size=n_requests, p=mix)
    out = []
    for i in range(n_requests):
        seeds = rng.choice(n_vertices, size=min(seeds_per_request, n_vertices),
                           replace=False, p=pop)
        out.append((seeds, float(arrivals[i]), classes[which[i]]))
    return out

"""Metrics registry: counters, gauges, and streaming percentile histograms.

Existing stats objects (``IOStats``, ``CacheStats``, ``ServingStats``)
keep their public dataclass/dict shapes; they *publish into* this
registry (when observability is on) so dashboards and the ``obs`` bench
read one namespace — e.g. ``io.read.bytes``, ``cache.hit_rate``,
``serve.latency_v`` — without any caller-visible change.

Histograms are streaming: a bounded deterministic reservoir (default
4096 samples) plus exact count/sum/min/max, so p50/p95/p99 are
available at any point with O(1) memory and no per-sample sort.
"""
from __future__ import annotations

import random
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_v", "_lk")

    def __init__(self, name):
        self.name = name
        self._v = 0.0
        self._lk = threading.Lock()

    def inc(self, n=1.0):
        with self._lk:
            self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_v", "_lk")

    def __init__(self, name):
        self.name = name
        self._v = 0.0
        self._lk = threading.Lock()

    def set(self, v):
        with self._lk:
            self._v = float(v)

    @property
    def value(self):
        return self._v


class Histogram:
    """Streaming histogram with reservoir-sampled percentiles.

    The reservoir uses a seeded PRNG (seeded from the metric name) so a
    given observation sequence always yields the same percentiles —
    determinism the rest of the system's bit-identity gates rely on.
    """

    __slots__ = ("name", "cap", "count", "sum", "min", "max",
                 "_res", "_rng", "_lk")

    def __init__(self, name, cap=4096):
        self.name = name
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._res = []
        self._rng = random.Random(hash(name) & 0xFFFFFFFF)
        self._lk = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lk:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._res) < self.cap:
                self._res.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.cap:
                    self._res[j] = v

    def percentile(self, q):
        """q in [0, 100]; returns 0.0 on an empty histogram."""
        with self._lk:
            if not self._res:
                return 0.0
            xs = sorted(self._res)
        idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def summary(self):
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class Registry:
    """Named instrument namespace.  ``counter``/``gauge``/``histogram`` are
    get-or-create; ``snapshot()`` flattens everything to a plain dict."""

    def __init__(self):
        self._lk = threading.Lock()
        self._instruments = {}

    def _get(self, name, klass, **kw):
        with self._lk:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = klass(name, **kw)
            elif not isinstance(inst, klass):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {klass.__name__}")
            return inst

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, cap=4096):
        return self._get(name, Histogram, cap=cap)

    def snapshot(self):
        with self._lk:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            if isinstance(inst, Histogram):
                for k, v in inst.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = inst.value
        return out

    def reset(self):
        with self._lk:
            self._instruments = {}


#: Process-global registry; stats publishers use this by default.
REGISTRY = Registry()


def publish_qwait(prefix: str, qwait_summary: dict,
                  registry: Registry | None = None) -> None:
    """Publish an engine's per-stream-class queue-delay summaries (the
    ``engine.qwait_summary()`` dict: StreamClass name -> Histogram
    ``summary()``) as ``<prefix>.<CLASS>.<stat>`` gauges.  The engines keep
    their qwait histograms standalone (one engine's DEMAND delays must not
    blend into another's), so this is the explicit bridge into a shared
    registry — see docs/streams.md for the class taxonomy."""
    reg = registry if registry is not None else REGISTRY
    for cls_name, summ in qwait_summary.items():
        for stat, val in summ.items():
            reg.gauge(f"{prefix}.{cls_name}.{stat}").set(val)

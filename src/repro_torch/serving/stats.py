"""Serving metrics: latency percentiles, per-class SLO accounting, and the
cross-request dedup savings that justify micro-batching over the IO stack.

Latencies are *virtual* seconds on the calibrated hardware envelope
(``core.simulator``), so p50/p95/p99 ratios between engines are
hardware-faithful rather than container wall-clock noise.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ServingStats:
    submitted: int = 0
    served: int = 0
    batches: int = 0
    rejected: dict = field(default_factory=dict)      # class name -> count
    latencies: dict = field(default_factory=dict)     # class name -> [virt s]
    # dedup accounting: rows the micro-batch *would* have fetched had each
    # request been served alone vs. rows actually fetched after dedup
    rows_requested: int = 0
    rows_fetched: int = 0
    storage_rows_naive: int = 0
    storage_rows_issued: int = 0
    virtual_end: float = 0.0
    # always-on per-LOGICAL-resource virtual busy time (host/io/device),
    # accumulated by the server per micro-batch — feeds overlap efficiency
    # and bubble attribution exactly like the pipeline's resource_busy
    resource_busy: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    def record(self, klass: str, latency_v: float):
        self.served += 1
        self.latencies.setdefault(klass, []).append(latency_v)

    def add_busy(self, **virt_s):
        for k, v in virt_s.items():
            self.resource_busy[k] = self.resource_busy.get(k, 0.0) + v

    def overlap_report(self) -> dict:
        from repro_torch.obs.analyze import overlap_report
        return overlap_report(self.resource_busy, self.virtual_end)

    def publish(self, prefix: str = "serve", registry=None) -> None:
        """Publish counters + latency percentiles into the obs metrics
        registry without changing the summary() dict."""
        from repro_torch.obs.metrics import REGISTRY
        reg = registry if registry is not None else REGISTRY
        for k, v in self.summary().items():
            if isinstance(v, (int, float)):
                reg.gauge(f"{prefix}.{k}").set(v)
        h = reg.histogram(f"{prefix}.latency_v")
        for lat in self.latencies.values():
            for v in lat:
                h.observe(v)

    def reject(self, klass: str):
        self.rejected[klass] = self.rejected.get(klass, 0) + 1

    def all_latencies(self) -> np.ndarray:
        vals = [v for lat in self.latencies.values() for v in lat]
        return np.asarray(vals, np.float64)

    def percentile(self, p: float, klass: str | None = None) -> float:
        lat = (np.asarray(self.latencies.get(klass, []), np.float64)
               if klass is not None else self.all_latencies())
        return float(np.percentile(lat, p)) if len(lat) else 0.0

    def throughput_rps(self) -> float:
        return self.served / self.virtual_end if self.virtual_end else 0.0

    @property
    def rejected_total(self) -> int:
        return sum(self.rejected.values())

    @property
    def dedup_row_savings(self) -> float:
        """Fraction of per-request feature rows eliminated by dedup."""
        if not self.rows_requested:
            return 0.0
        return 1.0 - self.rows_fetched / self.rows_requested

    @property
    def dedup_storage_savings(self) -> float:
        """Fraction of storage reads eliminated by dedup before submission."""
        if not self.storage_rows_naive:
            return 0.0
        return 1.0 - self.storage_rows_issued / self.storage_rows_naive

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        ov = self.overlap_report()
        return {
            "submitted": self.submitted,
            "served": self.served,
            "rejected": dict(self.rejected),
            "batches": self.batches,
            "rps": self.throughput_rps(),
            "p50_v": self.percentile(50),
            "p95_v": self.percentile(95),
            "p99_v": self.percentile(99),
            "dedup_row_savings": self.dedup_row_savings,
            "dedup_storage_savings": self.dedup_storage_savings,
            "virtual_end": self.virtual_end,
            "overlap_efficiency": ov["overlap_efficiency"],
            "bubble_frac": ov["bubble_frac"],
        }

"""Observability: virtual-time tracing, metrics, and overlap attribution.

The subsystem is zero-overhead when off: every instrumented call site
reads one module global (``trace.TRACER``) and checks ``enabled`` before
doing any work, and the default state is ``TRACER is None``.  Installing
a tracer (``trace.install`` / ``HELIOS_TRACE``) lights up nested spans
stamped with both wall and virtual time across the IO stack, the cache,
the pipeline, the remote/fleet layers, and the serving path; the
Chrome-trace exporter (``export``) writes them for Perfetto and the
overlap analyzer (``analyze``) reconstructs per-batch critical paths,
overlap efficiency, and pipeline-bubble attribution from them.
"""
from repro_torch.obs import analyze, export, metrics, trace
from repro_torch.obs.analyze import analyze_epoch, critical_path, overlap_report
from repro_torch.obs.export import to_chrome_trace, validate_trace, write_trace
from repro_torch.obs.metrics import REGISTRY, Registry
from repro_torch.obs.trace import Span, Tracer, get_tracer, install, uninstall

__all__ = [
    "analyze", "export", "metrics", "trace",
    "analyze_epoch", "critical_path", "overlap_report",
    "to_chrome_trace", "validate_trace", "write_trace",
    "REGISTRY", "Registry",
    "Span", "Tracer", "get_tracer", "install", "uninstall",
]

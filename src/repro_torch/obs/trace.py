"""Virtual-time tracer: nested spans stamped with wall AND virtual time.

Design constraints (see ISSUE 9):

* **Zero overhead when off.**  The tracer is a module global ``TRACER``
  that defaults to ``None``.  Every instrumented call site follows the
  same pattern as the FT layer's clean-path short-circuit::

      tr = _trace.TRACER
      if tr is not None and tr.enabled:
          ...

  so the disabled cost is one global load and an ``is None`` test.

* **Two timebases.**  The system runs on a :class:`VirtualClock`
  (simulated SSD/PCIe/NVLink seconds) while threads burn real wall
  time.  Spans carry both: ``t0``/``t1`` are wall seconds relative to
  the tracer epoch, ``v0``/``v1`` are virtual seconds when the layer
  knows them (pipeline ops, IO tickets, serve phases) and ``None``
  for pure host work (queue waits, reaps).

* **Thread-safe, allocation-light.**  Spans are ``__slots__`` records
  appended to a plain list (``list.append`` is atomic under the GIL);
  parenting uses a thread-local stack plus explicit parent ids for
  spans that cross threads (engine workers parenting to the submit
  span via the completion object).

``HELIOS_TRACE=<path>`` in the environment installs a tracer at import
time and registers an atexit Chrome-trace export, so any entry point —
including an unmodified pytest run — can be traced without code
changes.
"""
from __future__ import annotations

import atexit
import itertools
import os
import threading
import time

__all__ = ["Span", "Tracer", "TRACER", "get_tracer", "install", "uninstall"]


class Span:
    """One closed interval of work, in wall time and (optionally) virtual time."""

    __slots__ = ("sid", "parent", "name", "cat", "track",
                 "t0", "t1", "v0", "v1", "args", "tname")

    def __init__(self, sid, parent, name, cat, track, t0, tname):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.track = track
        self.t0 = t0
        self.t1 = t0
        self.v0 = None
        self.v1 = None
        self.args = None
        self.tname = tname

    def set_virtual(self, v0, v1):
        """Stamp the span with its virtual-clock interval (seconds)."""
        self.v0 = float(v0)
        self.v1 = float(v1)

    @property
    def wall_s(self):
        return self.t1 - self.t0

    @property
    def virt_s(self):
        if self.v0 is None or self.v1 is None:
            return 0.0
        return self.v1 - self.v0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, sid={self.sid}, parent={self.parent}, "
                f"wall={self.wall_s * 1e6:.1f}us, virt={self.virt_s * 1e6:.1f}us)")


class _SpanCtx:
    """Context manager wrapping a Span: closes wall time, pops the TLS stack."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer, span):
        self.tracer = tracer
        self.span = span

    def __enter__(self):
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.tracer._close(self.span, exc_type is not None)
        return False


class Tracer:
    """Collects spans and instant events; exported via ``repro_torch.obs.export``.

    Parameters
    ----------
    path:
        Optional output path for the atexit / explicit Chrome-trace
        export.  ``None`` keeps spans in memory only.
    """

    def __init__(self, path=None):
        self.enabled = True
        self.path = path
        self.epoch = time.perf_counter()
        self.spans = []
        self.events = []
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # ---------------------------------------------------------------- helpers
    def now(self):
        """Wall seconds since the tracer epoch."""
        return time.perf_counter() - self.epoch

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self):
        """Span id of the innermost open span on this thread (or None).

        Use this to parent work that completes on another thread: capture
        the id at submit time, pass it alongside the completion object,
        and hand it to :meth:`record` / ``span(..., parent=...)`` there.
        """
        st = self._stack()
        return st[-1].sid if st else None

    # ----------------------------------------------------------------- spans
    def span(self, name, track=None, cat=None, parent=None, args=None):
        """Open a nested span as a context manager.

        Parenting defaults to the innermost open span on the calling
        thread; pass ``parent=<sid>`` to stitch across threads.  Set
        virtual stamps on the yielded span via ``sp.set_virtual(v0, v1)``.
        """
        st = self._stack()
        if parent is None and st:
            parent = st[-1].sid
        sp = Span(next(self._ids), parent, name, cat, track,
                  time.perf_counter() - self.epoch,
                  threading.current_thread().name)
        if args:
            sp.args = dict(args)
        st.append(sp)
        return _SpanCtx(self, sp)

    def _close(self, span, errored=False):
        span.t1 = time.perf_counter() - self.epoch
        if errored:
            if span.args is None:
                span.args = {}
            span.args["error"] = True
        st = self._stack()
        # pop down to (and including) this span; tolerates mismatched nesting
        while st:
            top = st.pop()
            if top is span:
                break
        self.spans.append(span)

    def record(self, name, t0, t1, track=None, cat=None, parent=None,
               v0=None, v1=None, args=None):
        """Append a closed span directly (for sites that measured their own
        wall interval, e.g. engine workers).  ``t0``/``t1`` are absolute
        ``time.perf_counter()`` readings; they are re-based to the epoch."""
        sp = Span(next(self._ids), parent, name, cat, track,
                  t0 - self.epoch, threading.current_thread().name)
        sp.t1 = t1 - self.epoch
        if v0 is not None and v1 is not None:
            sp.v0 = float(v0)
            sp.v1 = float(v1)
        if args:
            sp.args = dict(args)
        self.spans.append(sp)
        return sp.sid

    def instant(self, name, track=None, cat=None, args=None):
        """Record an instant event (retry, hedge, reroute, degrade...)."""
        self.events.append((name, time.perf_counter() - self.epoch, track,
                            cat, threading.current_thread().name,
                            dict(args) if args else None))

    # ------------------------------------------------------------------ misc
    def clear(self):
        self.spans = []
        self.events = []

    def export(self, path=None):
        """Write the Chrome-trace JSON (convenience re-export)."""
        from repro_torch.obs.export import write_trace
        return write_trace(self, path or self.path)


#: The installed tracer, or None.  Hot paths read this global directly.
TRACER = None


def get_tracer():
    return TRACER


def install(path=None):
    """Install (and return) a fresh global tracer."""
    global TRACER
    TRACER = Tracer(path)
    return TRACER


def uninstall():
    """Remove the global tracer; returns it (spans intact) for analysis."""
    global TRACER
    tr = TRACER
    TRACER = None
    return tr


def _atexit_export():  # pragma: no cover - exercised via subprocess in tests
    tr = TRACER
    if tr is not None and tr.path and (tr.spans or tr.events):
        try:
            tr.export()
        except Exception:
            pass


_env = os.environ.get("HELIOS_TRACE")
if _env:
    install(_env if _env.lower() not in ("1", "true", "on") else "helios_trace.json")
    atexit.register(_atexit_export)

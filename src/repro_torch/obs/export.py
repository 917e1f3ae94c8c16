"""Chrome-trace-event JSON exporter (Perfetto / ``chrome://tracing``).

Layout
------
Two synthetic processes, one per timebase:

* pid 1 ``virtual`` — spans that carry virtual-clock stamps (pipeline
  ops, IO tickets, serve phases).  ``ts``/``dur`` are virtual
  microseconds, so the Perfetto timeline *is* the simulated schedule:
  one track per shard worker (``ssd0``..), per pipeline stage resource
  (``host``/``io``/``device``), per peer, per serve phase.
* pid 2 ``wall`` — spans without virtual stamps (queue waits, reaps,
  host-side bookkeeping), on real wall-clock microseconds.

Span args carry ``sid``/``parent`` so the nesting tree survives the
flat event list; instant events (retries, hedges, reroutes) become
``ph:"i"`` thread-scoped instants.
"""
from __future__ import annotations

import json

__all__ = ["to_chrome_trace", "write_trace", "validate_trace"]

_PID_VIRT = 1
_PID_WALL = 2


class _Tids:
    """Stable track-name -> tid mapping with name metadata events."""

    def __init__(self, events, pid_names):
        self.events = events
        self.by_pid = {}
        for pid, pname in pid_names.items():
            self.by_pid[pid] = {}
            self.events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": pname},
            })

    def tid(self, pid, track):
        m = self.by_pid[pid]
        t = m.get(track)
        if t is None:
            t = m[track] = len(m) + 1
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                "args": {"name": track},
            })
        return t


def to_chrome_trace(tracer):
    """Render a :class:`~repro_torch.obs.trace.Tracer` to a Chrome trace dict."""
    events = []
    tids = _Tids(events, {_PID_VIRT: "virtual", _PID_WALL: "wall"})

    for sp in tracer.spans:
        args = {"sid": sp.sid}
        if sp.parent is not None:
            args["parent"] = sp.parent
        if sp.args:
            args.update(sp.args)
        if sp.v0 is not None and sp.v1 is not None:
            pid = _PID_VIRT
            ts = sp.v0 * 1e6
            dur = (sp.v1 - sp.v0) * 1e6
            args["wall_us"] = round((sp.t1 - sp.t0) * 1e6, 3)
        else:
            pid = _PID_WALL
            ts = sp.t0 * 1e6
            dur = (sp.t1 - sp.t0) * 1e6
        ev = {
            "name": sp.name, "ph": "X", "pid": pid,
            "tid": tids.tid(pid, sp.track or sp.tname),
            "ts": round(ts, 3), "dur": round(max(0.0, dur), 3),
            "args": args,
        }
        if sp.cat:
            ev["cat"] = sp.cat
        events.append(ev)

    for name, t, track, cat, tname, args in tracer.events:
        ev = {
            "name": name, "ph": "i", "pid": _PID_WALL,
            "tid": tids.tid(_PID_WALL, track or tname),
            "ts": round(t * 1e6, 3), "s": "t",
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        events.append(ev)

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(tracer, path):
    """Export ``tracer`` as Chrome-trace JSON at ``path``; returns the dict."""
    doc = to_chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_trace(doc):
    """Check Chrome trace-event schema; raises ValueError on violations.

    Accepts the JSON-object form (``{"traceEvents": [...]}``).  Verifies
    per-event required keys, known phases, numeric non-negative
    timestamps/durations, and that metadata events name their tracks.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with a traceEvents list")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}")
        ph = ev["ph"]
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph in ("X", "B", "E", "i", "I", "C"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"event {i} has bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} has bad dur {dur!r}")
        if ph == "M" and not isinstance(ev.get("args", {}).get("name"), str):
            raise ValueError(f"metadata event {i} missing args.name")
    return True

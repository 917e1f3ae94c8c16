"""Overlap analyzer: critical paths, overlap efficiency, bubble attribution.

Two entry points at two costs:

* :func:`overlap_report` — the always-on cheap path.  The pipeline and
  the serving loop accumulate a ``{resource: busy_virtual_seconds}``
  dict as they schedule work (two dict ops per op, no tracer needed);
  this function turns that plus the makespan into overlap efficiency
  and compute-bubble fraction, so the trainer IO report and
  ``serve_slo`` always carry the headline numbers.

* :func:`analyze_epoch` — the full path over an installed tracer's
  span tree: virtual-time coverage, per-phase attribution, per-batch
  critical paths reconstructed from exact span adjacency (a pipeline
  span's virtual begin always coincides with its dependency's end, a
  resource release, or epoch start — that is how ``VirtualClock.
  schedule`` works), and the same overlap metrics derived purely from
  spans.

Definitions
-----------
With S = sum of per-op virtual durations, M = makespan (epoch virtual
time), and L = the busiest single resource's total virtual time::

    overlap_efficiency = clamp((S - M) / (S - L), 0, 1)

i.e. 0 when nothing overlaps (serial: M = S) and 1 at the physical
limit (M = L: the schedule is as short as the busiest resource
allows).  ``bubble_frac = 1 - device_busy / M`` is the fraction of the
epoch the compute resource sat idle.
"""
from __future__ import annotations

__all__ = ["overlap_report", "critical_path", "analyze_epoch", "union_len"]

_EPS = 1e-9


def union_len(intervals, lo=None, hi=None):
    """Total length of the union of ``(a, b)`` intervals, optionally
    clipped to ``[lo, hi]``."""
    ivs = []
    for a, b in intervals:
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            ivs.append((a, b))
    ivs.sort()
    total = 0.0
    cur_a = cur_b = None
    for a, b in ivs:
        if cur_b is None or a > cur_b + _EPS:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        elif b > cur_b:
            cur_b = b
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def overlap_report(busy, makespan, device_keys=("device",)):
    """Overlap metrics from a ``{resource: busy_virtual_s}`` dict.

    ``busy`` must be keyed by *logical* resource (host/io/device/...),
    even when the executor serialized everything onto one physical
    resource — that way serial mode reports efficiency 0 rather than a
    degenerate division.
    """
    busy = {k: float(v) for k, v in busy.items() if v > 0}
    makespan = float(makespan)
    s = sum(busy.values())
    busiest = max(busy.values(), default=0.0)
    denom = s - busiest
    if denom <= _EPS or makespan <= _EPS:
        eff = 0.0
    else:
        eff = (s - makespan) / denom
        eff = 0.0 if eff < 0.0 else (1.0 if eff > 1.0 else eff)
    device_busy = sum(busy.get(k, 0.0) for k in device_keys)
    bubble = 1.0 - device_busy / makespan if makespan > _EPS else 0.0
    bubble = 0.0 if bubble < 0.0 else (1.0 if bubble > 1.0 else bubble)
    return {
        "overlap_efficiency": eff,
        "bubble_frac": bubble,
        "makespan_s": makespan,
        "busy_s": dict(sorted(busy.items())),
        "sum_busy_s": s,
    }


def critical_path(spans, eps=_EPS):
    """Longest chain of exactly-adjacent virtual spans.

    ``spans`` is any iterable of objects with ``name``/``v0``/``v1``.
    Two spans chain when the successor's virtual begin equals the
    predecessor's virtual end (within ``eps``) — the invariant the
    virtual clock guarantees for dependency hand-offs and resource
    waits.  Returns ``(total_virtual_s, [names along the chain])``.
    The result is always <= the plain sum of span durations, and the
    chain is one feasible schedule walk, so it lower-bounds the true
    critical path while matching it exactly on clock-scheduled spans.
    """
    items = [s for s in spans
             if s.v0 is not None and s.v1 is not None and s.v1 > s.v0 + eps]
    if not items:
        return 0.0, []
    items.sort(key=lambda s: (s.v0, s.v1))

    def q(t):
        return int(round(t / eps))

    best_end = {}          # quantized end time -> (cum_duration, item index)
    cum = [0.0] * len(items)
    prev = [-1] * len(items)
    best_i = 0
    for i, sp in enumerate(items):
        d = sp.v1 - sp.v0
        at = best_end.get(q(sp.v0))
        if at is not None:
            cum[i] = at[0] + d
            prev[i] = at[1]
        else:
            cum[i] = d
        cur = best_end.get(q(sp.v1))
        if cur is None or cum[i] > cur[0]:
            best_end[q(sp.v1)] = (cum[i], i)
        if cum[i] > cum[best_i]:
            best_i = i

    names = []
    i = best_i
    while i >= 0:
        names.append(items[i].name)
        i = prev[i]
    names.reverse()
    return cum[best_i], names


def _span_resource(sp):
    if sp.args and "resource" in sp.args:
        return sp.args["resource"]
    return sp.track or "unknown"


def analyze_epoch(tracer, makespan=None, device_resources=("device",),
                  cats=("pipe", "serve")):
    """Full span-tree analysis of one traced run.

    Coverage is computed over *all* virtual-stamped spans; overlap /
    critical-path / per-batch stats use only the scheduler-level
    categories (``cats``) so nested IO-ticket spans are attributed,
    not double counted.
    """
    vspans = [s for s in tracer.spans if s.v0 is not None and s.v1 is not None]
    sched = [s for s in vspans if s.cat in cats] or vspans
    if makespan is None:
        makespan = max((s.v1 for s in vspans), default=0.0)

    coverage = (union_len(((s.v0, s.v1) for s in vspans), 0.0, makespan)
                / makespan if makespan > _EPS else 0.0)

    phases = {}
    busy = {}
    for s in sched:
        d = s.v1 - s.v0
        ph = phases.setdefault(s.name, {"virt_s": 0.0, "count": 0})
        ph["virt_s"] += d
        ph["count"] += 1
        res = _span_resource(s)
        busy[res] = busy.get(res, 0.0) + d
    total = sum(p["virt_s"] for p in phases.values())
    for p in phases.values():
        p["frac"] = p["virt_s"] / total if total > _EPS else 0.0

    crit_s, crit_names = critical_path(sched)

    batches = {}
    for s in sched:
        b = s.args.get("batch") if s.args else None
        if b is None:
            continue
        batches.setdefault(b, []).append(s)
    per_batch = {}
    for b, sps in sorted(batches.items()):
        c, names = critical_path(sps)
        per_batch[b] = {
            "sum_s": sum(s.v1 - s.v0 for s in sps),
            "critical_s": c,
            "path": names,
            "ops": len(sps),
        }

    rep = overlap_report(busy, makespan, device_keys=device_resources)
    rep.update({
        "coverage": coverage,
        "phases": dict(sorted(phases.items())),
        "critical_path_s": crit_s,
        "critical_path": crit_names,
        "batches": per_batch,
        "n_spans": len(tracer.spans),
        "n_virtual_spans": len(vspans),
    })
    return rep

"""Reduction of a ``torch.profiler`` window to what the metrics read.

It takes the profiler's raw events (``kineto_results.events()``), keeps
the device's work inside the window marked by ``WINDOW`` (a
``record_function`` span around the timed call), and gives:

- ``busy_s``: the union of the device's kernel, copy and set intervals
  (``device_busy`` gives it alone, for a window that traced the device
  and not the host);
- ``by_class``: device seconds and launches of the kernels the per-layer
  metrics read: K1's three kernels; K2's and K3's, and the zero fill of
  K3's output (the fill or set launched just before a K3 launch by the
  same host thread: the profiler records no CPU op of the trainer's worker
  threads, so the launches' order on each thread stands in for the
  wrappers' scopes);
- ``by_kernel``: device seconds and launches of every device operation,
  by ``short_name``, for a reader that finds its own kernel by name;
- ``top_ops``: the largest of ``by_kernel``'s seconds, largest first;
- ``gaps``: the longest idle intervals on the device, each labelled with
  the pipeline operators (``pipe.*`` spans) open on the host at its middle.
"""
from __future__ import annotations

import re

WINDOW = "portbench.window"

K1_KERNELS = ("dedup_kernel", "lookup_rows_kernel", "compact_kernel")
K2_KERNELS = ("gather_rows_kernel",)
K3_KERNELS = ("segment_rows_kernel", "segment_edges_kernel")
FILLS = ("FillFunctor", "Memset")
# device-side records that are waits, not work (and unnamed records)
_NOT_WORK = ("Sync", "Stream Wait", "Event Record")


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its return type, its anonymous
    namespace and its argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0][:width]


def kernel_class(name: str) -> str | None:
    if any(k in name for k in K1_KERNELS):
        return "k1"
    if any(k in name for k in K2_KERNELS + K3_KERNELS):
        return "agg"
    return None


def _k3_fills(dev: list, launches: dict) -> set:
    """Correlation ids of the fills that zero K3's outputs: on the host
    thread that launched them, the next launch is K3's."""
    by_tid: dict = {}
    for name, _a, _b, corr in dev:
        at = launches.get(corr)
        if at is not None:
            by_tid.setdefault(at[0], []).append((at[1], name, corr))
    out = set()
    for seq in by_tid.values():
        seq.sort()
        for (_, name, corr), (_, nxt, _) in zip(seq, seq[1:]):
            if any(f in name for f in FILLS) and \
                    any(k in nxt for k in K3_KERNELS):
                out.add(corr)
    return out


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy(events) -> tuple:
    """Seconds in which the device did work among ``events``, the raw
    events of a profiler that traced the device alone over the window, and
    the count of those records."""
    work = [(e.start_ns(), e.end_ns()) for e in events
            if e.device_type().name != "CPU" and e.name()
            and not any(w in e.name() for w in _NOT_WORK)]
    return sum(b - a for a, b in _union(work)) * 1e-9, len(work)


def reduce_events(events, host_spans: list, n_top: int = 10) -> dict:
    """``events``: the profiler's raw events; ``host_spans``: ``(name,
    start_ns, end_ns)`` of the pipeline operators on the profiler's clock.
    Returns ``{}`` where the window marker is missing."""
    window = None
    launches, dev = {}, []
    for e in events:
        name = e.name()
        if e.device_type().name == "CPU":
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name.startswith("cu"):          # the CUDA runtime's calls
                launches[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
        elif name and not any(w in name for w in _NOT_WORK):
            dev.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
    if window is None:
        return {}
    w0, w1 = window
    fills = _k3_fills(dev, launches)
    busy, by_class, by_kernel = [], {}, {}
    for name, a, b, corr in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        s = (b - a) * 1e-9
        cls = "k3_fill" if corr in fills else kernel_class(name)
        if cls is not None:
            c = by_class.setdefault(cls, {"s": 0.0, "launches": 0})
            c["s"] += s
            c["launches"] += 1
        k = by_kernel.setdefault(short_name(name), {"s": 0.0, "launches": 0})
        k["s"] += s
        k["launches"] += 1
    merged = _union(busy)
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:n_top]:
        mid = (a + b) / 2
        open_ops = sorted({n.removeprefix("pipe.") for n, s0, s1 in host_spans
                           if s0 <= mid <= s1})
        labelled.append(["+".join(open_ops) or "none", (b - a) * 1e-9])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1]["s"])[:n_top]
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in merged) * 1e-9,
            "by_class": by_class,
            "by_kernel": by_kernel,
            "top_ops": [[k, v["s"]] for k, v in top],
            "gaps": labelled,
            "n_device_events": len(busy)}

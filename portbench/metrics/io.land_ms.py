"""Mean wall milliseconds a batch that the IO operator spends landing the
read rows on the device: the staged rows' copy, the index scatter, the
duplicate fill and the stats (``pipe.io_complete.land`` spans, around
``HeteroCache.complete_planned``)."""


def read(rec):
    d = rec["spans"].get("pipe.io_complete.land")
    return 1e3 * sum(d) / len(d) if d else None

"""Mean wall milliseconds of the operator that waits out a batch's storage
reads and lands them (``pipe.io_complete`` spans; ``core/iostack.py``
behind ``HeteroCache.complete_planned``)."""


def read(rec):
    d = rec["spans"].get("pipe.io_complete")
    return 1e3 * sum(d) / len(d) if d else None

"""Mean wall milliseconds a batch that the IO operator waits out the
batch's storage and remote reads (``pipe.io_complete.wait`` spans, inside
``pipe.io_complete``; the reads are ``core/iostack.py``'s)."""


def read(rec):
    d = rec["spans"].get("pipe.io_complete.wait")
    return 1e3 * sum(d) / len(d) if d else None

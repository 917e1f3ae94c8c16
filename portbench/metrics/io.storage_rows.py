"""Rows the IO engine read from storage a batch (``IOStats.requests`` over
the timed call, a count)."""


def read(rec):
    if not rec["n_batches"]:
        return None
    return rec["io"]["requests"] / rec["n_batches"]

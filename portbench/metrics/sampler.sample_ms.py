"""Mean wall milliseconds of the sampler's operator a batch (``pipe.sample``
spans of the timed call, ``gnn/sampling.py``)."""


def read(rec):
    d = rec["spans"].get("pipe.sample")
    return 1e3 * sum(d) / len(d) if d else None

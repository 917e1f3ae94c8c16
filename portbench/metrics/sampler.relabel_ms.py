"""Mean wall milliseconds a batch of the sampler's relabelling: the unique
node array, seeds first, and each hop's positions into it
(``sample.relabel`` spans, ``gnn/sampling.py``)."""


def read(rec):
    d = rec["spans"].get("sample.relabel")
    return 1e3 * sum(d) / len(d) if d else None

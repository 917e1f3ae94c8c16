"""Mean wall milliseconds a batch of the sampler's per-hop neighbour draws
(``sample.draw`` spans, ``gnn/sampling.py``; the window's batches alone,
since the sampler draws nothing else there)."""


def read(rec):
    d = rec["spans"].get("sample.draw")
    return 1e3 * sum(d) / len(d) if d else None

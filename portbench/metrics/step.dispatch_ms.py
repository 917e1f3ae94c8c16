"""Mean wall milliseconds a batch of the host's dispatch of the train step,
forward, backward and AdamW (``pipe.train.dispatch`` spans, inside
``pipe.train``; ``gnn/models.py`` and ``train/optim.py``)."""


def read(rec):
    d = rec["spans"].get("pipe.train.dispatch")
    return 1e3 * sum(d) / len(d) if d else None

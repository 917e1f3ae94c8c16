"""Mean wall milliseconds of the train step's operator a batch
(``pipe.train`` spans; ``gnn/models.py`` and ``train/optim.py``)."""


def read(rec):
    d = rec["spans"].get("pipe.train")
    return 1e3 * sum(d) / len(d) if d else None

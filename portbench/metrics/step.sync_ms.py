"""Mean wall milliseconds a batch that the train operator waits for the
device, bringing the step's metrics to the host (``pipe.train.sync``
spans, inside ``pipe.train``)."""


def read(rec):
    d = rec["spans"].get("pipe.train.sync")
    return 1e3 * sum(d) / len(d) if d else None

"""The training vertices of every batch of the traced timed call over the
call's whole wall time (two batches in flight), in seeds a second.  The
traced window carries the profiler's host cost, so it reads below an
untraced window's rate."""


def read(rec):
    if not rec["n_batches"] or not rec["window_s"]:
        return None
    return rec["n_batches"] * rec["batch_size"] / rec["window_s"]

"""Share of the timed call's wall time in which no kernel, copy or set ran
on the card (the union of the profiler's device intervals), in percent."""


def read(rec):
    d = rec["device"]
    if not d or not d["window_s"] or not d["n_device_events"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])

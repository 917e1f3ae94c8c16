"""Share of the rows looked up that the device or host tier served
(``CacheStats`` over the timed call), in percent."""


def read(rec):
    c = rec["cache"]
    total = (c["device_hits"] + c["host_hits"] + c["storage_misses"]
             + c["remote_hits"])
    if not total:
        return None
    return 100.0 * (c["device_hits"] + c["host_hits"]) / total

"""K1's share of its roofline, in percent: the sum over the timed call's
lookups of each one's least time (``counts.k1_bound_s`` from its own id
count and tier hits) over K1's device time in the profiler's trace."""
from portbench import counts


def read(rec):
    k1 = rec["device"].get("by_class", {}).get("k1")
    if not k1 or not k1["s"] or not rec["lookups"]:
        return None
    bound = sum(counts.k1_bound_s(b, n_dev, n_host, rec["row_bytes"])
                for b, n_dev, n_host in rec["lookups"])
    return 100.0 * bound / k1["s"]

"""K2's and K3's share of their roofline, in percent: the bytes that
every launch of the timed call's steps needs (``counts.agg_calls``,
forward and backward: each batch's valid edges, and output rows only where
a valid edge lands) over HBM's rate, over their device time in the
profiler's trace (the kernels and the zero fill of K3's whole padded
output).  Nothing is read where the trace's K2 and K3 launches are not
the ones counted."""
from portbench import counts


def read(rec):
    by = rec["device"].get("by_class", {})
    main = by.get("agg")
    if not main or not rec["batches"]:
        return None
    args = rec.get("model_args", {})
    calls = [c for s in rec["batches"]
             for c in counts.agg_calls(rec["model"], s, rec["feature_dim"],
                                       rec["hidden"], **args)]
    if main["launches"] != len(calls):
        return None
    secs = main["s"] + by.get("k3_fill", {}).get("s", 0.0)
    return 100.0 * sum(b for _, _, b in calls) / counts.HBM_BYTES_S / secs

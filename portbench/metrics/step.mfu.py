"""The whole step's share of the card's float32 peak, in percent: the
model's operations over every batch of the timed call, counted from each
batch's real sampled sizes (``counts.model_flops``), over the call's wall
time and ``counts.F32_OPS_S`` (TF32 is off)."""
from portbench import counts


def read(rec):
    if not rec["batches"] or not rec["device"]:
        return None
    args = rec.get("model_args", {})
    ops = sum(counts.model_flops(rec["model"], s, rec["feature_dim"],
                                 rec["hidden"], rec["n_classes"], **args)
              for s in rec["batches"])
    return 100.0 * ops / (rec["window_s"] * counts.F32_OPS_S)

"""Plain PyTorch version of the segment-sum kernel (K3)."""
import torch


def segment_sum_ref(msgs: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    # ids outside [0, n_segments) are dropped (padding), as in the kernel
    seg = seg_ids.to(torch.int64)
    valid = (seg >= 0) & (seg < n_segments)
    out = torch.zeros((n_segments, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, seg[valid], msgs[valid].to(torch.float32))

"""Plain PyTorch version of the row-gather kernel (K2)."""
import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # an index outside [0, N) gives a zero row, as the kernel does
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < table.shape[0])
    out = table[torch.where(ok, idx, 0)] if table.shape[0] else \
        table.new_zeros((idx.shape[0], table.shape[1]))
    return out.masked_fill_(~ok[:, None], 0)

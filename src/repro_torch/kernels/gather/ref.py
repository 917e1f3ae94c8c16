"""Plain PyTorch version of the row-gather kernel (K2)."""
import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.to(torch.int64)]

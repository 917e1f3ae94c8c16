"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
It runs on the CPU only when the caller passes ``device="cpu"`` (as the
tests do); asking for the card where there is none raises instead of
carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r} (expected "
                         "'cuda', 'cuda:N', 'cpu', or 'meta' for shapes "
                         "alone)")
    return dev

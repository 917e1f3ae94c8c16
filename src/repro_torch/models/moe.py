"""Mixture-of-Experts configuration.

The port holds only the ``MoEConfig`` dataclass for now, because the config
registry (``configs/base.py``) names it.  The MoE layer itself (GShard
capacity dispatch and the dropless path) comes with its own slice of the
port (ROADMAP, "the rest of the LLM substrate"); ``models/lm.py`` raises for
a config with ``moe`` set.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024          # tokens per dispatch group
    n_experts_padded: int = 0       # pad experts to a TP-divisible count
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    impl: str = "gshard"            # "gshard" (one-hot dispatch) | "dropless"
                                    # (sort + ragged_dot EP, §Perf kimi fix)

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts

"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.

[arXiv:2501.kimi2 (paper-table)]

1.04T total params / ~32B active.  This is the flagship Helios arch: bf16
params alone are 2.08 TB, so a single v5e-256 pod cannot hold params+grads
(16.2 GB/chip vs 16 GB) — training uses the Helios-tiered step (cold experts
+ optimizer state on the host tier, per-layer streaming) or the 512-chip
multi-pod mesh + Adafactor.  See DESIGN.md §7 and EXPERIMENTS.md.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.models.moe import MoEConfig

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1,
                  capacity_factor=1.25, group_size=1024, n_experts_padded=384),
    act="swiglu", norm="rmsnorm", rope_theta=50000.0,
    source="arXiv:2501.kimi2",
    fsdp=True, tiered_experts=True, train_microbatches=16,
))

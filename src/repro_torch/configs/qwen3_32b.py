"""qwen3-32b [dense] — qk_norm, GQA kv=8, 25600 FFN. [hf:Qwen/Qwen3-8B]

Large enough that params + Adam moments need FSDP over the data axis
(DESIGN.md §7).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936,
    qk_norm=True,
    act="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B",
    fsdp=True, train_microbatches=16,
))

"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4, QKV bias.

[hf:Qwen/Qwen1.5-MoE-A2.7B]

60 experts don't divide the 16-way model axis: routed experts are padded to
64 (router masks the 4 pads) for clean EP sharding.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.models.moe import MoEConfig

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared=4,
                  capacity_factor=1.25, group_size=1024, n_experts_padded=64),
    act="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    train_microbatches=2,
))

"""rwkv6-7b [ssm] — "Finch", data-dependent decay linear attention.

[arXiv:2404.05892]

Attention-free: O(1) state per layer -> long_500k decode is supported
(the whole point of the SSM cell in the assignment).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    block="rwkv", rwkv_head_size=64,
    act="gelu", norm="layernorm", rope_theta=0.0,
    source="arXiv:2404.05892",
    train_microbatches=16,
))

"""qwen2.5-3b [dense] — GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936,
    qkv_bias=True,
    act="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
    train_microbatches=4,
))

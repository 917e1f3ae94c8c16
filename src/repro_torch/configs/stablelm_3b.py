"""stablelm-3b [dense] — LayerNorm + SwiGLU, MHA. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    act="swiglu", norm="layernorm", rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
    train_microbatches=8,
))

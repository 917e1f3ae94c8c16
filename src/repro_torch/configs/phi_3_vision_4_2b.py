"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    frontend="vision",
    act="swiglu", norm="rmsnorm", rope_theta=10000.0,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    train_microbatches=8,
))

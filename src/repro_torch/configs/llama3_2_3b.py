"""llama3.2-3b [dense] — small llama3 w/ GQA. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256,
    act="swiglu", norm="rmsnorm", rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-1B",
    train_microbatches=8,
))

"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427 (Griffin)]

Pattern (rec, rec, attn) x 8 + (rec, rec) tail = 26 layers; local window
2048 keeps decode KV bounded -> long_500k supported.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    pattern=("rec", "rec", "attn"), window=2048, d_rnn=2560,
    act="geglu", norm="rmsnorm", rope_theta=10000.0,
    source="arXiv:2402.19427",
    train_microbatches=4,
))

"""whisper-small [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356]

12 encoder + 12 decoder layers; sinusoidal positions (decoder's learned
positions replaced by sinusoids — noted in DESIGN.md); LayerNorm + biases.
vocab 51865 is odd -> embedding stays vocab-replicated (sharding guard).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    enc_dec=True, n_enc_layers=12,
    frontend="audio", bias=True,
    act="gelu", norm="layernorm", rope_theta=0.0,
    source="arXiv:2212.04356",
    train_microbatches=8,
))

"""Model / shape configuration schema and registry.

Every assigned architecture is a ``ModelConfig``; the four assigned input
shapes are ``ShapeSpec``s.  ``reduced()`` produces the CPU-smoke-test-sized
variant of any config (same family / same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.models.moe import MoEConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block: str = "attn"               # attn | rwkv
    pattern: tuple = ()               # hybrid layer pattern, e.g. ("rec","rec","attn")
    window: int = 0                   # local-attention window (0 = full)
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    bias: bool = False                # biases on all linears + LN (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None    # None | "vision" | "audio"
    act: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 500000.0
    rwkv_head_size: int = 64
    d_rnn: int = 0                    # RG-LRU width (0 -> d_model)
    dtype: str = "bfloat16"
    source: str = ""                  # provenance tag from the assignment
    # --- distribution / memory knobs -------------------------------------
    fsdp: bool = False                # shard params+opt over the data axis
    train_microbatches: int = 1       # grad-accum steps for train_4k
    tiered_experts: bool = False      # Helios: stream cold experts from host
    remat: bool = True
    # --- perf-iteration knobs (EXPERIMENTS.md §Perf) ----------------------
    grad_accum_dtype: str = "float32" # bf16 halves grad-buffer + sync bytes
    seq_parallel: bool = False        # sequence-parallel TP residual stream
    attn_probs_dtype: str = "float32" # score/prob materialisation dtype

    # -- capability queries -------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.block == "rwkv"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM / hybrid w/ window)"""
        return self.attention_free or (bool(self.pattern) and self.window > 0)

    def supports(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.subquadratic
        return True

    def shape_names(self) -> list[str]:
        return [n for n, s in SHAPES.items() if self.supports(s)]

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_expert=32, n_shared=min(1, self.moe.n_shared),
                group_size=16, n_experts_padded=4)
        pattern = self.pattern
        n_layers = 2 if not pattern else len(pattern)
        hd = 8
        return replace(
            self, n_layers=n_layers, d_model=32,
            n_heads=max(2, min(4, self.n_heads or 2)),
            n_kv_heads=max(1, min(2, self.n_kv_heads or 1)),
            head_dim=hd, d_ff=64, vocab=128, moe=moe,
            n_enc_layers=2 if self.enc_dec else 0,
            d_rnn=32 if self.d_rnn else 0, rwkv_head_size=8,
            train_microbatches=1, fsdp=False, tiered_experts=False)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib
    for mod in [
        "phi_3_vision_4_2b", "llama3_2_3b", "stablelm_3b", "qwen3_32b",
        "qwen2_5_3b", "whisper_small", "kimi_k2_1t_a32b", "qwen2_moe_a2_7b",
        "rwkv6_7b", "recurrentgemma_2b",
    ]:
        importlib.import_module(f"repro_torch.configs.{mod}")

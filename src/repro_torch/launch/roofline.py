"""Roofline terms of a dry-run cell on the H100 (PyTorch port of
``repro.launch.roofline``).

Three terms per (arch, shape, mesh), in seconds per step:

  compute    = flops_global            / (chips * PEAK_FLOPS)
  memory     = hbm_bytes_global        / (chips * HBM_BW)
  collective = collective_bytes_global / (chips * LINK_BW)

The inputs come from ``launch/op_cost.py``, which counts one step's
dispatched ops per rank (the reference reads XLA's compiled HLO through
``hlo_cost``); ``analyze`` scales them by the chip count to globals, as
the reference does.  There is no ``parse_collectives``: torch has no HLO
text, and ``op_cost`` counts each collective as it is dispatched.

The rates are the H100 SXM's data-sheet figures (the reference's are v5e
figures and do not apply).  ``LINK_BW`` is one NVLink 4 direction, the
rate of a mesh axis inside one 8-GPU node; an axis that spans nodes runs
at InfiniBand's rate (ConnectX-7, 400 Gb/s = 50e9 B/s a GPU), which one
link rate does not model, as the reference's single ICI rate does not
model DCI across pods.

``param_count``, ``model_flops_for`` and ``memory_floor_bytes`` are the
reference's arithmetic line for line, over the port's ``ModelConfig`` and
``ShapeSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# H100 SXM5 80GB, NVIDIA H100 Tensor Core GPU data sheet
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s on the tensor cores
F32_FLOPS = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s per direction (900 GB/s both)
HBM_BYTES = 80e9             # device memory


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclass
class Roofline:
    name: str
    chips: int
    flops_global: float
    bytes_global: float
    collective_bytes_global: float
    coll: CollectiveStats
    model_flops: float = 0.0        # 6*N*D (or 6*N_active*D) analytic
    peak_mem_per_chip: float = 0.0  # bytes: the most live at once on a rank
    bytes_floor_global: float = 0.0 # compulsory-traffic floor
    flops_by_op: dict | None = None

    @property
    def t_compute(self):
        return self.flops_global / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self):
        return self.bytes_global / (self.chips * HBM_BW)

    @property
    def t_memory_floor(self):
        return self.bytes_floor_global / (self.chips * HBM_BW)

    @property
    def t_collective(self):
        return self.collective_bytes_global / (self.chips * LINK_BW)

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self):
        """Perfect-overlap step time estimate = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self):
        return self.model_flops / self.flops_global if self.flops_global else 0.0

    @property
    def mfu(self):
        """Model-FLOPs utilisation at the roofline step-time estimate."""
        if not self.model_flops or not self.t_step:
            return 0.0
        return self.model_flops / (self.t_step * self.chips * PEAK_FLOPS)

    def row(self) -> dict:
        return {
            "cell": self.name, "chips": self.chips,
            "t_compute_ms": 1e3 * self.t_compute,
            "t_memory_ms": 1e3 * self.t_memory,
            "t_memory_floor_ms": 1e3 * self.t_memory_floor,
            "t_collective_ms": 1e3 * self.t_collective,
            "bottleneck": self.bottleneck,
            "gflops": self.flops_global / 1e9,
            "gbytes": self.bytes_global / 1e9,
            "floor_gbytes": self.bytes_floor_global / 1e9,
            "coll_gbytes": self.collective_bytes_global / 1e9,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu_bound": self.mfu,
            "peak_mem_gb_per_chip": self.peak_mem_per_chip / 1e9,
        }


def analyze(name: str, cost, chips: int, model_flops: float = 0.0,
            bytes_floor: float = 0.0) -> Roofline:
    """A ``Roofline`` from ``op_cost``'s per-rank ``Cost`` of one step."""
    coll = CollectiveStats(bytes_by_kind=dict(cost.coll_bytes),
                           count_by_kind=dict(cost.coll_count))
    return Roofline(
        name=name, chips=chips,
        flops_global=cost.flops * chips,
        bytes_global=cost.hbm_bytes * chips,
        collective_bytes_global=float(cost.coll_total) * chips,
        coll=coll, model_flops=model_flops, peak_mem_per_chip=cost.peak_bytes,
        bytes_floor_global=bytes_floor,
        flops_by_op=dict(cost.flops_by_op))


def param_count(cfg) -> tuple[float, float]:
    """(total_params, active_params) analytic for MODEL_FLOPS = 6*N*D."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    Hq = cfg.n_heads * cfg.head_dim
    Hkv = cfg.n_kv_heads * cfg.head_dim
    attn = D * Hq + 2 * D * Hkv + Hq * D
    n_mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    if cfg.moe is not None:
        m = cfg.moe
        expert = n_mats * D * m.d_expert
        moe_total = m.n_experts * expert + D * m.e_pad
        moe_active = m.top_k * expert
        shared = m.n_shared * n_mats * D * m.d_expert
        layer_total = attn + moe_total + shared
        layer_active = attn + moe_active + shared
    elif cfg.block == "rwkv":
        tm = 5 * D * D + D * (5 * 32) + 5 * 32 * D + D * 64 + 64 * D
        cm = 2 * D * cfg.d_ff + D * D
        layer_total = layer_active = tm + cm
    elif cfg.pattern:
        dr = cfg.d_rnn or D
        rec = 2 * D * dr + 2 * dr * dr + dr * D
        mlp_p = n_mats * D * cfg.d_ff
        k = len(cfg.pattern)
        n_rec = sum(1 for x in cfg.pattern if x == "rec")
        per_pat = n_rec * (rec + mlp_p) + (k - n_rec) * (attn + mlp_p)
        layer_total = layer_active = per_pat / k
    else:
        layer_total = layer_active = attn + n_mats * D * cfg.d_ff
    emb = 2 * V * D
    enc = cfg.n_enc_layers * (attn + n_mats * D * cfg.d_ff) if cfg.enc_dec else 0
    total = L * layer_total + emb + enc
    active = L * layer_active + emb + enc
    return float(total), float(active)


def model_flops_for(cfg, shape) -> float:
    """6*N_active*tokens for train; 2*N_active*tokens for inference."""
    _, active = param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def memory_floor_bytes(cfg, shape) -> float:
    """Compulsory global HBM traffic per step — the perfect-fusion floor.

    Every elementwise chain is fused to one read per input + one write per
    output; attention runs as a flash kernel (q,k,v read + o write, x2.5 for
    backward recompute); weights are read once per microbatch fwd + once bwd;
    grads + optimizer state r/w once.  The gap between this floor and the
    as-lowered byte count is the fusion/kernel opportunity (EXPERIMENTS.md
    §Perf).
    """
    total_p, active_p = param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    bpe = 2.0                                     # bf16
    if shape.kind == "train":
        n_mb = max(cfg.train_microbatches, 1)
        tokens = B * S
        # weights: fwd + bwd read per microbatch; grads: write+read; opt r/w
        w = active_p * bpe * 2 * n_mb + total_p * (4 + 4) * 2
        # activations: ~12 residual-stream passes per layer (norms, proj io,
        # mlp io, residual adds) + remat re-reads (~1.5x)
        acts = 12 * 1.5 * tokens * D * L * bpe
        # flash attention: q,k,v,o once fwd + 2.5x bwd
        attn = 4 * tokens * (cfg.n_heads or 1) * cfg.head_dim * L * bpe * 3.5
        logits = tokens * cfg.vocab * 4 * 2       # fp32 fwd + bwd
        return w + acts + attn + logits
    if shape.kind == "prefill":
        tokens = B * S
        w = active_p * bpe
        acts = 8 * tokens * D * L * bpe
        attn = 4 * tokens * (cfg.n_heads or 1) * cfg.head_dim * L * bpe
        cache = 2 * tokens * cfg.n_kv_heads * cfg.head_dim * L * bpe
        return w + acts + attn + cache + B * cfg.vocab * 4
    # decode: weights + full KV read + state r/w dominate
    w = active_p * bpe
    if cfg.block == "rwkv":
        H = D // cfg.rwkv_head_size
        kv = 2 * B * H * cfg.rwkv_head_size ** 2 * L * 4
    elif cfg.pattern:
        k = len(cfg.pattern)
        n_attn = sum(1 for x in cfg.pattern if x != "rec")
        win = min(cfg.window or S, S)
        kv = (2 * B * win * cfg.n_kv_heads * cfg.head_dim * (L * n_attn / k) * bpe
              + 2 * B * (cfg.d_rnn or D) * L * 4)
    else:
        kv = 2 * B * S * cfg.n_kv_heads * cfg.head_dim * L * bpe
    return w + kv + 6 * B * D * L * bpe + B * cfg.vocab * 4

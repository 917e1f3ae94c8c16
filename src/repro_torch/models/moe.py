"""Mixture-of-Experts block (PyTorch port of ``repro.models.moe``):
GShard-style capacity dispatch, and the sort-based dropless path at one
device.

Expert weights are stacked ``(E_pad, d, F)`` in one ``nn.Module`` whose
names are the reference pytree's (``router``, ``experts.w_gate``, ...,
``shared.*``).  Both paths are plain tensor code: no Pallas kernel of the
reference computes them (XLA does), so ``einsum`` and ``matmul`` are their
counterparts here.  The reference's ``annotate`` sharding hints and its
``shard_map`` over the ``model`` axis are dropped: on one card the
dropless path is the reference's at ``model_n = 1``, where it keeps every
assignment.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import annotate, local_einsum
from repro_torch.models.layers import MLP, dense_init_, gelu, mlp, param


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024          # tokens per dispatch group
    n_experts_padded: int = 0       # pad experts to a TP-divisible count
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    impl: str = "gshard"            # "gshard" (one-hot dispatch) | "dropless"
                                    # (sort + ragged_dot EP, §Perf kimi fix)

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Experts(nn.Module):
    """``w_gate``, ``w_up`` ``(E, d, F)`` and ``w_down`` ``(E, F, d)``."""

    def __init__(self, n: int, d_model: int, d_expert: int, dtype, device):
        super().__init__()
        self.d_model, self.d_expert = d_model, d_expert
        self.w_gate = param((n, d_model, d_expert), dtype, device)
        self.w_up = param((n, d_model, d_expert), dtype, device)
        self.w_down = param((n, d_expert, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator):
        for name, p in self.named_parameters():
            dense_init_(p, gen, self.d_expert if name == "w_down"
                        else self.d_model)


class MoE(nn.Module):
    """The reference's ``init_moe``: a float32 ``router`` ``(d, E_pad)``,
    stacked ``experts`` and, with ``n_shared``, a ``shared`` MLP of width
    ``n_shared * d_expert``."""

    def __init__(self, d_model: int, mcfg: MoEConfig, dtype, act: str,
                 device=None):
        super().__init__()
        self.d_model = d_model
        self.router = param((d_model, mcfg.e_pad), torch.float32, device)
        self.experts = Experts(mcfg.e_pad, d_model, mcfg.d_expert, dtype,
                               device)
        if mcfg.n_shared:
            self.shared = MLP(d_model, mcfg.n_shared * mcfg.d_expert, act,
                              dtype, device=device)

    def reset_parameters(self, gen: torch.Generator):
        dense_init_(self.router, gen, self.d_model)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _capacity(tokens_per_group: int, mcfg: MoEConfig) -> int:
    c = int(math.ceil(tokens_per_group * mcfg.top_k * mcfg.capacity_factor
                      / mcfg.e_pad))
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def router_weights(logits, mcfg: MoEConfig, valid_experts: int):
    """logits: (..., E) -> (topw, topi, aux_loss, z_loss), in float32.
    Padding experts (index >= ``valid_experts``) are masked to -1e30, and
    top-k is taken over the probabilities, ties to the lower index."""
    logits = logits.float()
    E = logits.shape[-1]
    if valid_experts < E:                         # mask padding experts
        pad = torch.arange(E, device=logits.device) < valid_experts
        logits = torch.where(pad, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # equal probabilities (experts whose exp underflowed to 0) go to the
    # lower index, as lax.top_k breaks ties: a stable descending sort
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = top.values[..., :mcfg.top_k], top.indices[..., :mcfg.top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss + router z-loss
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(topi[..., 0].reshape(-1), E).float().mean(0)
    aux = valid_experts * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return topw, topi, aux, z


def _expert_act(act: str):
    return F.silu if act == "swiglu" else gelu


def moe_block(x, p: MoE, mcfg: MoEConfig, act: str = "swiglu"):
    """x: (B, S, D) -> (y, {"moe_aux", "moe_z"})."""
    if mcfg.impl == "dropless":
        return _moe_block_dropless(x, p, mcfg, act)
    return _moe_block(x, p, mcfg, act)


def _moe_block_dropless(x, p: MoE, mcfg: MoEConfig, act: str = "swiglu"):
    """The reference's sort-based path at one device (``model_n = 1``):
    ``cap = T * K`` keeps every (token, k) assignment.  Assignments are
    sorted by expert (stable), each expert's run goes through its own
    products (the reference's ``ragged_dot``), and the weighted outputs are
    added back per token with ``index_add_``."""
    B, S, D = x.shape
    T, K, E = B * S, mcfg.top_k, mcfg.e_pad
    xf = x.reshape(T, D)
    logits = xf.float() @ p.router
    topw, topi, aux, z = router_weights(logits[None], mcfg, mcfg.n_experts)
    topw, topi = topw[0], topi[0]                           # (T, K)
    expert = topi.reshape(-1)
    order = torch.sort(expert, stable=True).indices
    tok = torch.arange(T, device=x.device).repeat_interleave(K)[order]
    xg = xf[tok]
    sizes = torch.bincount(expert, minlength=E).tolist()
    we = p.experts
    ys, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            xe = xg[start:start + n]
            if act in ("swiglu", "geglu"):
                h = _expert_act(act)(xe @ we.w_gate[e]) * (xe @ we.w_up[e])
            else:
                h = gelu(xe @ we.w_up[e])
            ys.append(h @ we.w_down[e])
        start += n
    y = torch.cat(ys) if ys else xg.new_zeros((0, D))
    y = y * topw.reshape(-1)[order][:, None].to(y.dtype)
    out = torch.zeros((T, D), dtype=y.dtype, device=x.device)
    out.index_add_(0, tok, y)
    out = out.reshape(B, S, D)
    if hasattr(p, "shared"):
        out = out + mlp(x, p.shared, act)
    return out, {"moe_aux": mcfg.aux_loss_weight * aux,
                 "moe_z": mcfg.z_loss_weight * z}


def _moe_block(x, p: MoE, mcfg: MoEConfig, act: str = "swiglu"):
    """GShard capacity dispatch.  Tokens are grouped batch-major (split
    within each sequence; one group per sequence when S is not a multiple
    of the group size, one per token at decode), each group routes into
    ``_capacity`` slots per expert, and assignments past an expert's
    capacity are dropped.  ``dispatch`` is cast to x's dtype; ``combine``
    stays float32 until the last einsum."""
    B, S, D = x.shape
    E, K = mcfg.e_pad, mcfg.top_k
    Sg = min(mcfg.group_size, S)
    if S % Sg:
        Sg = S
    G = B * (S // Sg)
    xg = annotate(x.reshape(G, Sg, D), "batch", None, None)

    logits = xg.float() @ p.router                          # (G, Sg, E)
    topw, topi, aux, z = router_weights(logits, mcfg, mcfg.n_experts)

    C = _capacity(Sg, mcfg)
    # position of each (token, k) assignment within its expert's capacity
    mask = F.one_hot(topi, E).float()                       # (G, Sg, K, E)
    mask_flat = mask.reshape(G, Sg * K, E)                  # token-major
    pos_flat = torch.cumsum(mask_flat, dim=1) - mask_flat
    pos = torch.einsum("gte,gte->gt", pos_flat, mask_flat).reshape(G, Sg, K)
    keep = (pos < C).float()
    w = topw * keep                                         # dropped -> 0

    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    dispatch = torch.einsum("gske,gskc->gsec", mask, pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", mask, pos_oh, w)
    dispatch = annotate(dispatch.to(x.dtype), "batch", None, "experts", None)
    combine = annotate(combine, "batch", None, "experts", None)

    # dispatch -> (E, G, C, D): all-to-all between data-sharded G and
    # model-sharded E on a mesh
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    expert_in = annotate(expert_in, "experts", "batch", None, None)
    we = p.experts
    if act in ("swiglu", "geglu"):
        h = _expert_act(act)(torch.einsum("egcd,edf->egcf", expert_in,
                                          we.w_gate)) * \
            torch.einsum("egcd,edf->egcf", expert_in, we.w_up)
    else:
        h = gelu(torch.einsum("egcd,edf->egcf", expert_in, we.w_up))
    expert_out = torch.einsum("egcf,efd->egcd", h, we.w_down)
    expert_out = annotate(expert_out, "experts", "batch", None, None)
    y = local_einsum("egcd,gsec->gsd", expert_out, combine.to(x.dtype))
    y = annotate(y, "batch", None, None).reshape(B, S, D)

    if hasattr(p, "shared"):
        y = y + mlp(x, p.shared, act)
    return y, {"moe_aux": mcfg.aux_loss_weight * aux,
               "moe_z": mcfg.z_loss_weight * z}

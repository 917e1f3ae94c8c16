"""The dry run's route through K4 and K5: shape-only ops for fake tensors.

``launch/dryrun.py`` runs a step on fake tensors (``FakeTensorMode``:
shapes and dtypes, no storage).  A fake tensor has no address, so it must
not reach the kernels' ctypes calls, and it must not run the plain
versions either (the dry run counts the card's program).  The kernel
entries (``flash_attention``, ``flash_attention_fwd``,
``flash_attention_bwd``; ``wkv``, ``wkv_fwd``, ``wkv_bwd``) send a fake
tensor here, and only a fake tensor (``is_fake``): a CUDA tensor launches
the kernel or raises and a CPU tensor runs the plain version, as before.

Each op is a ``torch.library.custom_op`` whose real implementation raises
and whose fake implementation gives the kernel's outputs: their shapes,
dtypes and devices, including what the forward saves for the backward (K4's
log-sum-exp; K5's state before every ``CKPT_TOKENS``-th token).  Under
autograd the forward ops save what ``FlashAttentionFn`` and ``WkvFn`` save
and differentiate through the backward ops.  Each op registers:

  * its FLOPs (``torch.utils.flop_counter``): K4 4 hd a visible (query,
    key) pair forward and 10 backward (S recomputed, dV, dP, dQ, dK),
    window and causality counted as ``chip_smoke.visible_pairs`` counts
    them; K5 4 FLOPs a state element (N x N a head) and token forward, 14
    backward, as ``chip_smoke.py`` bounds them;
  * a DTensor sharding strategy: both kernels are independent over the
    batch and over heads (K5's du sums over the batch: ``Partial``).
"""
from __future__ import annotations

import functools

import torch
from torch import Tensor
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

CKPT_TOKENS = 16    # K5's tokens between checkpoints (rwkv_scan/ops.py)


def _refuse(name: str):
    raise RuntimeError(f"helios::{name} is the dry run's shape-only op; a "
                       "real tensor launches the kernel (or runs its plain "
                       "version on the CPU)")


@functools.lru_cache(maxsize=None)
def visible_pairs(S: int, T: int, causal: bool, q_offset: int,
                  window: int) -> int:
    """(query, key) pairs K4 computes: query i at position q_offset + i
    sees key t < T with t <= its position (causal) and t > its position -
    window (window > 0)."""
    n = 0
    for i in range(S):
        p = q_offset + i
        hi = min(p, T - 1) if causal else T - 1
        lo = max(0, p - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

@torch.library.custom_op("helios::k4_fwd", mutates_args=())
def k4_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, q_offset: int,
           window: int) -> tuple[Tensor, Tensor]:
    _refuse("k4_fwd")


@k4_fwd.register_fake
def _(q, k, v, causal, q_offset, window):
    B, S, H, hd = q.shape
    return (q.new_empty((B, S, H, hd)),
            q.new_empty((B, H, S), dtype=torch.float32))


@torch.library.custom_op("helios::k4_bwd", mutates_args=())
def k4_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
           lse: Tensor, causal: bool, q_offset: int,
           window: int) -> tuple[Tensor, Tensor, Tensor]:
    _refuse("k4_bwd")


@k4_bwd.register_fake
def _(q, k, v, o, do, lse, causal, q_offset, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _k4_setup(ctx, inputs, output):
    q, k, v, causal, q_offset, window = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = (causal, q_offset, window)


def _k4_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    return (*k4_bwd(q, k, v, o, do.contiguous(), lse, *ctx.args),
            None, None, None)


k4_fwd.register_autograd(_k4_backward, setup_context=_k4_setup)


def _k4_pairs(q_shape, k_shape, causal, q_offset, window) -> int:
    B, S, H, hd = q_shape
    return B * H * hd * visible_pairs(S, k_shape[1], bool(causal),
                                      int(q_offset), int(window))


@register_flop_formula(torch.ops.helios.k4_fwd)
def _(q_shape, k_shape, v_shape, causal, q_offset, window, *args, **kw):
    return 4 * _k4_pairs(q_shape, k_shape, causal, q_offset, window)


@register_flop_formula(torch.ops.helios.k4_bwd)
def _(q_shape, k_shape, v_shape, o_shape, do_shape, lse_shape, causal,
      q_offset, window, *args, **kw):
    return 10 * _k4_pairs(q_shape, k_shape, causal, q_offset, window)


@register_sharding(torch.ops.helios.k4_fwd.default)
def _(q, k, v, causal, q_offset, window):
    R, args = Replicate(), [None] * 3
    return [([R, R], [R, R, R, *args]),
            ([Shard(0), Shard(0)], [Shard(0)] * 3 + args),
            ([Shard(2), Shard(1)], [Shard(2)] * 3 + args)]


@register_sharding(torch.ops.helios.k4_bwd.default)
def _(q, k, v, o, do, lse, causal, q_offset, window):
    R, args = Replicate(), [None] * 3
    return [([R] * 3, [R] * 6 + args),
            ([Shard(0)] * 3, [Shard(0)] * 6 + args),
            ([Shard(2)] * 3, [Shard(2)] * 5 + [Shard(1)] + args)]


def flash_attention(q, k, v, causal, q_offset, window):
    return k4_fwd(q, k, v, causal, q_offset, window)[0]


def flash_attention_fwd(q, k, v, causal, q_offset, window):
    with torch.no_grad():
        return k4_fwd(q, k, v, causal, q_offset, window)


def flash_attention_bwd(q, k, v, o, do, causal, q_offset, window, lse):
    return k4_bwd(q, k, v, o, do, lse, causal, q_offset, window)


# ---------------------------------------------------------------------------
# K5: the WKV6 scan
# ---------------------------------------------------------------------------

@torch.library.custom_op("helios::k5_fwd", mutates_args=())
def k5_fwd(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
           state: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    _refuse("k5_fwd")


@k5_fwd.register_fake
def _(r, k, v, logw, u, state):
    B, T, H, N = r.shape
    return (torch.empty_like(r), torch.empty_like(state),
            r.new_empty((B, H, -(-T // CKPT_TOKENS), N, N)))


@torch.library.custom_op("helios::k5_bwd", mutates_args=())
def k5_bwd(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
           ckpt: Tensor, dy: Tensor, dstate: Tensor
           ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    _refuse("k5_bwd")


@k5_bwd.register_fake
def _(r, k, v, logw, u, ckpt, dy, dstate):
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(logw), torch.empty_like(u),
            torch.empty_like(dstate))


def _k5_setup(ctx, inputs, output):
    r, k, v, logw, u, state = inputs
    ctx.save_for_backward(r, k, v, logw, u, output[2])


def _k5_backward(ctx, dy, dstate, dckpt):
    r, k, v, logw, u, ckpt = ctx.saved_tensors
    B, T, H, N = r.shape
    dy = torch.zeros_like(r) if dy is None else dy.contiguous()
    if dstate is None:
        dstate = r.new_zeros((B, H, N, N))
    # the backward's scratch, as rwkv_scan/ops.py's launch allocates it:
    # the state's cotangent after every chunk and exp(logw) over whole
    # chunks
    n_chunks = -(-T // CKPT_TOKENS)
    scratch = (r.new_empty((B, H, n_chunks, N, N)),
               r.new_empty((B, n_chunks * CKPT_TOKENS, H, N)))
    grads = k5_bwd(r, k, v, logw, u, ckpt, dy, dstate)
    del scratch
    return grads


k5_fwd.register_autograd(_k5_backward, setup_context=_k5_setup)


def _k5_elems(r_shape) -> int:
    B, T, H, N = r_shape
    return B * T * H * N * N


@register_flop_formula(torch.ops.helios.k5_fwd)
def _(r_shape, *args, **kw):
    return 4 * _k5_elems(r_shape)


@register_flop_formula(torch.ops.helios.k5_bwd)
def _(r_shape, *args, **kw):
    return 14 * _k5_elems(r_shape)


@register_sharding(torch.ops.helios.k5_fwd.default)
def _(r, k, v, logw, u, state):
    R = Replicate()
    return [([R] * 3, [R] * 6),
            ([Shard(0)] * 3, [Shard(0)] * 4 + [R, Shard(0)]),
            ([Shard(2), Shard(1), Shard(1)],
             [Shard(2)] * 4 + [Shard(0), Shard(1)])]


@register_sharding(torch.ops.helios.k5_bwd.default)
def _(r, k, v, logw, u, ckpt, dy, dstate):
    R = Replicate()
    return [([R] * 6, [R] * 8),
            ([Shard(0)] * 4 + [Partial(), Shard(0)],
             [Shard(0)] * 4 + [R] + [Shard(0)] * 3),
            ([Shard(2)] * 4 + [Shard(0), Shard(1)],
             [Shard(2)] * 4 + [Shard(0), Shard(1), Shard(2), Shard(1)])]


def _state(r, state):
    B, T, H, N = r.shape
    return r.new_zeros((B, H, N, N)) if state is None else state


def wkv(r, k, v, logw, u, state):
    y, s_out, _ = k5_fwd(r, k, v, logw, u, _state(r, state))
    return y, s_out


def wkv_fwd(r, k, v, logw, u, state):
    with torch.no_grad():
        return k5_fwd(r, k, v, logw, u, _state(r, state))


def wkv_bwd(r, k, v, logw, u, state, dy, dstate, ckpt):
    B, T, H, N = r.shape
    if dstate is None:
        dstate = r.new_zeros((B, H, N, N))
    return k5_bwd(r, k, v, logw, u, ckpt, dy, dstate)

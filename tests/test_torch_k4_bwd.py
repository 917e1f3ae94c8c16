"""K4's backward on the CPU, before any card run: the log-sum-exp the
forward saves (``ref.lse_ref``) against numpy's logsumexp of the reference's
scores; a tile-by-tile model of the tensor-core backward kernels
(``k4_bwd_model.bwd_model``, with each head width's schedule: at hd 256
64-key dK/dV CTAs in head groups, half the columns a consumer, 32-key dQ
tiles) against ``jax.grad`` of the reference model's ``attend``, and its
hd-256 schedule's off-by-one mutants failing it; the head-group rule;
the route each backward takes; and the CPU wrappers.

Tolerances.  ``lse_ref``: 1e-5 absolute (float32 scores and sums, in log2
units).  The model without rounding: 1e-5 of each gradient's largest
entry (float32 sums in another order), which holds its tiles, skips and
masks.  The model with the kernels' bf16 roundings (dS before its
products, P as a bf16 pair hi + lo, the forward's output, the outputs) and
with P rounded once (the design this replaced, which must fail on dV):
chip_smoke.py's per-entry
``K4_BWD_TOL["bfloat16"]`` and ``K4_BWD_LARGEST["bfloat16"]``, which the
kernels are held to on the card against the plain version.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from k4_bwd_model import (K4_BWD_LARGEST, MUTANTS, bwd_model,  # noqa: E402
                          largest_err, tol_ratio)
from repro.models.attention import attend as jax_attend  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import lse_ref  # noqa: E402


def _inputs(seed, B, S, T, H, K, hd, bf16=True):
    """q, k, v, do from a numpy seed, as float32 arrays holding bf16 values
    (what the kernels read) unless ``bf16`` is off."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd),
                          (B, S, H, hd))]
    if bf16:
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _jax_grads(q, k, v, do, causal, q_offset, window):
    """jax.grad of the reference's ``attend`` in float32: (dq, dk, dv)."""
    B, S, H, hd = q.shape

    def f(q_, k_, v_):
        o = jax_attend(q_, k_, v_, causal=causal, window=window, q_chunk=32,
                       q_offset=q_offset)
        return jnp.sum(o * jnp.asarray(do.reshape(B, S, H * hd)))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


# (S, T, H, K, hd, causal, q_offset, window); every query sees a key
LSE_CASES = [(24, 24, 4, 2, 64, True, 0, 0), (37, 53, 6, 3, 32, False, 0, 0),
             (5, 40, 6, 2, 64, True, 35, 0), (70, 70, 2, 1, 16, True, 0, 9),
             (33, 60, 4, 4, 8, False, 0, 12), (1, 1, 3, 1, 128, True, 0, 0),
             (20, 48, 4, 2, 32, True, 28, 5)]


@pytest.mark.parametrize("case", LSE_CASES, ids=str)
def test_lse_ref_matches_reference_scores(case):
    """``lse_ref`` against numpy's logsumexp (in log2) of the reference's
    scores, q k^T / sqrt(hd) over kv repeated to every query head as
    ``repro.kernels.flash_attention.ref.attention_ref`` forms them, with
    the mask built here from positions."""
    S, T, H, K, hd, causal, q_offset, window = case
    q, k, _, _ = _inputs(S + T, 2, S, T, H, K, hd, bf16=False)
    G = H // K
    kr = jnp.repeat(jnp.asarray(k), G, axis=2)
    s = np.asarray(jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kr)
                   * (1.0 / math.sqrt(hd)), np.float64)
    pos = q_offset + np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    seen = np.ones((S, T), bool)
    if causal:
        seen &= t <= pos
    if window:
        seen &= pos - t < window
    s = np.where(seen, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / np.log(2.0)
    got = lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal, q_offset,
                  window)
    assert got.shape == (2, H, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_lse_ref_marks_a_query_that_sees_no_key():
    """A query whose window lies past the last key gets +inf, so that the
    backward's exp2(s - lse) is 0 for it; the others stay finite."""
    q, k, _, _ = _inputs(0, 1, 4, 6, 2, 1, 16, bf16=False)
    lse = lse_ref(torch.from_numpy(q), torch.from_numpy(k), True, 6, 2)
    # positions 6..9 over keys 0..5 with window 2: position 6 sees key 5
    assert torch.isfinite(lse[..., 0]).all()
    assert (lse[..., 1:] == float("inf")).all()


# (S, T, H, K, hd, causal, q_offset, window): hd 64 and 128, S and T up to
# 192, G 1-3, causal or not, a window, an offset, ragged tiles; then hd 256
# (64-key dK/dV CTAs split into head groups, 32-key dQ tiles): MQA 10:1 at
# small S (10 head groups of one head), windows 2, 34 and 66, which put a
# dQ consumer's first visible key in the last slot of a 32-key tile, a
# query offset of 512, ragged S and T (non-causal 37 over 611, five groups;
# GQA 3:1 over two kv heads at an offset with window 65)
MODEL_CASES = [(192, 192, 6, 2, 128, True, 0, 0),
               (150, 150, 3, 3, 64, True, 0, 0),
               (64, 192, 4, 2, 64, False, 0, 0),
               (130, 70, 3, 1, 128, False, 0, 0),
               (100, 160, 2, 2, 64, True, 60, 0),
               (192, 192, 3, 1, 64, True, 0, 70),
               (97, 131, 6, 2, 128, False, 0, 64),
               (40, 190, 3, 3, 64, True, 150, 33),
               (200, 200, 10, 1, 256, True, 0, 0),
               (200, 200, 10, 1, 256, True, 0, 2),
               (160, 160, 10, 1, 256, False, 0, 34),
               (130, 130, 10, 1, 256, True, 0, 66),
               (100, 612, 10, 1, 256, True, 512, 64),
               (37, 611, 5, 1, 256, False, 0, 0),
               (150, 170, 6, 2, 256, True, 20, 65)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=str)
def test_bwd_tiles_give_the_exact_gradient_unrounded(case):
    """Without rounding, the model's tiles, skipped tiles and masks give
    ``jax.grad`` of ``attend``: every gradient within 1e-5 of its largest
    entry.  A tile skipped that some pair needs, or a mask that lets a
    padded row or a NaN past the end of the queries in, fails this."""
    S, T, H, K, hd, causal, q_offset, window = case
    q, k, v, do = _inputs(S * T + hd, 1, S, T, H, K, hd, bf16=False)
    want = _jax_grads(q, k, v, do, causal, q_offset, window)
    got = bwd_model(*(torch.from_numpy(a) for a in (q, k, v, do)), causal,
                    q_offset, window, rounding=False)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("case", MODEL_CASES, ids=str)
def test_bwd_bf16_rounding_fits_the_card_tolerance(case):
    """With the tensor-core kernels' roundings (dS to bf16 before its
    products, P as a bf16 pair hi + lo for dV, delta from the forward's
    bf16 output, bf16 outputs), every entry of dq, dk, dv stays within
    ``K4_BWD_TOL["bfloat16"]`` of ``jax.grad`` of ``attend`` in float32 on
    the same bf16 inputs, and the largest error within ``K4_BWD_LARGEST``:
    the limits the card is held to stand without loosening.  With P
    rounded once instead, dv fails them: the reason P is split."""
    S, T, H, K, hd, causal, q_offset, window = case
    q, k, v, do = _inputs(S + T + hd, 1, S, T, H, K, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    want = [torch.from_numpy(np.array(w))
            for w in _jax_grads(q, k, v, do, causal, q_offset, window)]
    got = bwd_model(tq, tk, tv, tdo, causal, q_offset, window)
    for i, (g, w) in enumerate(zip(got, want)):
        r = tol_ratio(g, w, "bfloat16", i)
        assert r <= 1, (("dq", "dk", "dv")[i], r)
        assert largest_err(g, w) <= K4_BWD_LARGEST["bfloat16"]
    once = bwd_model(tq, tk, tv, tdo, causal, q_offset, window,
                     split=(False, False))
    assert tol_ratio(once[2], want[2], "bfloat16", 2) > 1


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 10])
def test_bwd_hd256_head_groups_sum_to_the_gradient(groups):
    """At hd 256 the dK/dV kernel splits a kv head's 10 query heads into
    head groups whose float32 sums a last pass adds in group order; with
    1, 2, 3 (3 + 3 + 4 heads), 4 and 10 groups, where a CTA's query bands
    run from one head into the next inside a group, the model gives
    ``jax.grad`` of ``attend`` unrounded (1e-5 of each gradient's largest
    entry) and stays within the card's bf16 limits with the roundings."""
    S, H, hd, window = 150, 10, 256, 40
    q, k, v, do = _inputs(groups, 1, S, S, H, 1, hd, bf16=False)
    want = _jax_grads(q, k, v, do, True, 0, window)
    got = bwd_model(*(torch.from_numpy(a) for a in (q, k, v, do)), True, 0,
                    window, rounding=False, groups=groups)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    q, k, v, do = _inputs(groups + 1, 1, S, S, H, 1, hd)
    want = [torch.from_numpy(np.array(w))
            for w in _jax_grads(q, k, v, do, True, 0, window)]
    got = bwd_model(*(torch.from_numpy(a) for a in (q, k, v, do)), True, 0,
                    window, groups=groups)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tol_ratio(g, w, "bfloat16", i) <= 1
        assert largest_err(g, w) <= K4_BWD_LARGEST["bfloat16"]


@pytest.mark.parametrize("mutant", MUTANTS)
def test_bwd_hd256_schedule_mutants_fail_the_model(mutant):
    """Each off-by-one fault planted in the hd-256 schedule (a dK/dV CTA's
    first or last query tile skipped, a dQ CTA's first or last key tile
    skipped, a head group left out of the ordered sum, a group's last head
    dropped, the window's seam mask one key wide) moves some gradient of
    the unrounded model by more than 1e-3 of its largest entry from
    ``jax.grad`` of ``attend``, at recurrentgemma's form cut small (MQA
    10:1, causal, window 66, S 200: 10 head groups), where the unplanted
    model is exact within 1e-5: the exact-gradient cases would catch it."""
    S, H, hd, window = 200, 10, 256, 66
    q, k, v, do = _inputs(7, 1, S, S, H, 1, hd, bf16=False)
    want = _jax_grads(q, k, v, do, True, 0, window)
    tq = [torch.from_numpy(a) for a in (q, k, v, do)]

    def worst(m):
        got = bwd_model(*tq, True, 0, window, rounding=False, mutant=m)
        return max(float(np.abs(g.numpy() - w).max() / np.abs(w).max())
                   for g, w in zip(got, want))
    assert worst(None) <= 1e-5
    assert worst(mutant) > 1e-3, mutant


def test_bwd_head_groups_rule():
    """``bwd_head_groups``: 1 below hd 256; at 256 as many groups as one
    wave of SMs takes beside the B K ceil(T / 64) dK/dV CTAs, at most G:
    recurrentgemma-2b's layer (B 1, one kv head, T 4096, G 10) on the
    H100's 132 SMs gets 2 (128 CTAs), eight kv heads at 4096 keys 1, a
    short sequence all 10."""
    groups = fa_ops.bwd_head_groups
    assert groups(1, 4096, 1, 10, 256, 132) == 2
    assert groups(1, 4096, 8, 3, 128, 132) == 1
    assert groups(1, 4096, 8, 3, 256, 132) == 1
    assert groups(2, 4096, 1, 10, 256, 132) == 1
    assert groups(1, 200, 1, 10, 256, 132) == 10
    assert groups(1, 1000, 1, 10, 256, 132) == 8
    assert groups(3, 37, 2, 3, 256, 132) == 3


def _packed(dtype, hd, form):
    """q, k, v as CPU views of one packed (2, 24, 6 + 2 * 2, hd + pad)
    projection; ``form`` breaks TMA's 16-byte alignment (a base pointer 2
    bytes off, or a row stride of hd + 4 elements) or keeps it."""
    pad = 4 if form == "stride" else 0
    buf = torch.zeros(2 * 24 * 10 * (hd + pad) + 64, dtype=dtype)
    off = (-buf.data_ptr() // buf.element_size()) % 32
    off += 1 if form == "pointer" else 0
    qkv = buf[off:off + 2 * 24 * 10 * (hd + pad)].view(2, 24, 10,
                                                       hd + pad)[..., :hd]
    return qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]


@pytest.mark.parametrize("form", ["aligned", "pointer", "stride"])
@pytest.mark.parametrize("hd", fa_ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_choice(dtype, hd, form):
    """The backward takes its own route, ``bwd_route_of(q, k, v)``: bf16
    at its tensor-core widths (``TENSOR_CORE_BWD_HEAD_DIMS``, 64-256, the
    forward's) with 16-byte aligned pointers and strides on the tensor
    cores, bf16 at 256 included; everything else (float32, bf16 at 8-32)
    on the CUDA cores; misaligned bf16 at a tensor-core width, 256
    included, raises instead of switching route."""
    q, k, v = _packed(dtype, hd, form)
    assert fa_ops.TENSOR_CORE_BWD_HEAD_DIMS == fa_ops.TENSOR_CORE_HEAD_DIMS
    tc = dtype == torch.bfloat16 and hd in fa_ops.TENSOR_CORE_BWD_HEAD_DIMS
    if tc and form != "aligned":
        with pytest.raises(ValueError, match="tensor-core route"):
            fa_ops.bwd_route_of(q, k, v)
    else:
        assert fa_ops.bwd_route_of(q, k, v) == (
            "tensor_cores" if tc else "cuda_cores")


@pytest.mark.parametrize("case", LSE_CASES[:4], ids=str)
def test_cpu_wrappers_match_the_reference(case):
    """On CPU tensors ``flash_attention_fwd`` gives the plain output and
    ``lse_ref``, and ``flash_attention_bwd`` (lse unused) gives jax.grad of
    ``attend``, float32 within 1e-5 of each gradient's largest entry; no
    kernel launch is counted."""
    S, T, H, K, hd, causal, q_offset, window = case
    q, k, v, do = _inputs(7 + S, 2, S, T, H, K, hd, bf16=False)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    before = (fa_ops.launches, fa_ops.bwd_launches)
    o, lse = fa_ops.flash_attention_fwd(tq, tk, tv, causal, q_offset, window)
    assert torch.equal(lse, lse_ref(tq, tk, causal, q_offset, window))
    assert torch.equal(o, fa_ops.flash_attention(tq, tk, tv, causal, q_offset,
                                                 window))
    got = fa_ops.flash_attention_bwd(tq, tk, tv, o, tdo, causal, q_offset,
                                     window, lse=lse)
    want = _jax_grads(q, k, v, do, causal, q_offset, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert (fa_ops.launches, fa_ops.bwd_launches) == before

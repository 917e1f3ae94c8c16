"""The port's LM kernels — K4 flash attention and K5 WKV6 scan — against the
reference package's Pallas kernels in interpret mode and their jnp oracles,
on the same numpy inputs.

On the CPU the port's wrappers run their plain versions (``ref.py``); the
CUDA kernels are held against those plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances.  K4, float32: 2e-5 (rtol and atol), as the reference's own
sweep holds its kernel; bfloat16: outputs within 2e-2 (about two bf16
steps at the outputs' magnitude), since both sides compute in float32 and
round once at the output.  K5: within 1e-5 of the largest magnitude
(float32 sums in another order, and the reference's chunked form
rearranges the products).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import mha  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.rwkv_scan.ops import wkv as jax_wkv  # noqa: E402
from repro.kernels.rwkv_scan.ref import wkv_ref as jax_wkv_ref  # noqa: E402
from repro.models.attention import attend as jax_attend  # noqa: E402
from repro.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _qkv(rng, B, S, T, H, K, hd):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, T, K, hd)).astype(np.float32),
            rng.normal(size=(B, T, K, hd)).astype(np.float32))


def _assert_attn(got, want, bf16):
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,k,hd", [(128, 4, 4, 32), (256, 4, 2, 64),
                                      (256, 8, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_matches_pallas(s, h, k, hd, causal, bf16):
    """The sweep of the reference's flash-attention test, against its
    Pallas kernel (interpret mode) behind the GQA-repeating ``mha``."""
    q, kk, v = _qkv(np.random.default_rng(s + h), 2, s, s, h, k, hd)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = mha(*(jnp.asarray(a, jdt) for a in (q, kk, v)), causal=causal,
               use_pallas=True, interpret=True)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = fa_ops.flash_attention(*(_t(a).to(tdt) for a in (q, kk, v)),
                                 causal=causal)
    assert got.dtype == tdt and got.shape == q.shape
    _assert_attn(got, want, bf16)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_ragged_matches_oracle(G, causal, bf16):
    """S = 24 (a prompt of serve_decode.py, no whole 128-block) and hd = 80
    (stablelm-3b), against the reference's jnp oracle on kv repeated to
    every query head."""
    B, S, K, hd = 2, 24, 2, 80
    H = K * G
    q, kk, v = _qkv(np.random.default_rng(G), B, S, S, H, K, hd)
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def heads(a):   # (B, S, n, hd) -> (B * H, S, hd), kv repeated G times
        a = np.repeat(a, H // a.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, hd), jdt)
    want = jax_attention_ref(heads(q), heads(kk), heads(v), causal)
    want = np.asarray(want, np.float32).reshape(B, H, S, hd).transpose(
        0, 2, 1, 3)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = fa_ops.flash_attention(*(_t(a).to(tdt) for a in (q, kk, v)),
                                 causal=causal)
    _assert_attn(got, want, bf16)


@pytest.mark.parametrize("S,T,q_offset", [(1, 40, 39), (5, 40, 35),
                                          (24, 24, 0)])
def test_flash_attention_offset_matches_model_attend(S, T, q_offset):
    """Causal attention of S queries at absolute positions q_offset.. over
    T keys, against the reference model's chunked ``attend``."""
    q, kk, v = _qkv(np.random.default_rng(S), 2, S, T, 6, 2, 64)
    want = jax_attend(q, kk, v, causal=True, q_chunk=16, q_offset=q_offset)
    got = fa_ops.flash_attention(_t(q), _t(kk), _t(v), causal=True,
                                 q_offset=q_offset)
    np.testing.assert_allclose(got.reshape(2, S, -1).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


def _layouts(hd, form):
    """(data_ptr, shape, stride) of q, k, v as views of one packed
    (2, 24, 6 + 2 * 2, hd + pad) bf16 projection at base 0x10000; ``form``
    breaks the alignment TMA needs or gives an axis of size 1 a stride
    that is never used."""
    pad = 4 if form == "stride" else 0       # 4 bf16: 8 bytes off
    base = 0x10000 + (2 if form == "pointer" else 0)
    B, S, H, K, W = 2, 24, 6, 2, hd + pad
    st = (S * (H + 2 * K) * W, (H + 2 * K) * W, W, 1)
    q = (base, (B, S, H, hd), st)
    k = (base + 2 * H * W, (B, S, K, hd), st)
    v = (base + 2 * (H + K) * W, (B, S, K, hd), st)
    if form == "size-1 axis":    # B = S = 1, their strides odd
        q, k, v = ((p, (1, 1) + shape[2:], (3, 5) + s[2:])
                   for p, shape, s in (q, k, v))
    return [q, k, v]


@pytest.mark.parametrize("form", ["aligned", "pointer", "stride",
                                  "size-1 axis"])
@pytest.mark.parametrize("hd", fa_ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_route_choice(dtype, hd, form):
    """bf16 at the forward's tensor-core widths
    (``TENSOR_CORE_HEAD_DIMS``: 64, 80, 96, 112, 128 and 256) takes the
    tensor-core route (TMA + wgmma); float32, and bf16 at 8-32, the
    CUDA-core route whatever the alignment.  A bf16 tensor at a
    tensor-core width whose base pointer or strides are not 16-byte
    multiples raises instead of switching route."""
    layouts = _layouts(hd, form)
    tc = dtype == torch.bfloat16 and hd in fa_ops.TENSOR_CORE_HEAD_DIMS
    if tc and form in ("pointer", "stride"):
        with pytest.raises(ValueError, match="tensor-core route"):
            fa_ops.pick_route(dtype, hd, layouts)
    else:
        assert fa_ops.pick_route(dtype, hd, layouts) == (
            "tensor_cores" if tc else "cuda_cores")


def test_flash_attention_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises; the
    plain version is not run for it."""
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="one CUDA device"):
        fa_ops.flash_attention(torch.zeros(1, 4, 2, 64), q, q)


# ---------------------------------------------------------------------------
# K5: WKV6 scan
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, T, H, N, logw):
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32)
               for _ in range(3))
    if logw is None:   # per-channel decays spread log-uniformly over
        # [-4, -1e-4], where the reference's chunked form is finite
        lw = -np.exp(rng.uniform(np.log(1e-4), np.log(4.0), (B, T, H, N)))
    else:
        lw = np.full((B, T, H, N), logw)
    u = (rng.normal(size=(H, N)) * 0.3).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u


def _heads(a):   # (B, T, H, N) -> (B * H, T, N)
    B, T, H, N = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, T, N)


def _assert_wkv(got, want, what=""):
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1.0), (what, err)


@pytest.mark.parametrize("logw", [-1e-4, -0.5, -5.0, -20.0, None])
@pytest.mark.parametrize("T", [1, 17, 64])
def test_wkv_matches_oracle_over_the_clip_range(T, logw):
    """Against the reference's exact recurrence (zero initial state) over
    the model's whole clip range of logw, [-20, -1e-4]."""
    B, H, N = 2, 3, 16
    r, k, v, lw, u = _wkv_inputs(np.random.default_rng(T), B, T, H, N, logw)
    want = jax_wkv_ref(*(_heads(a) for a in (r, k, v, lw)), np.tile(u, (B, 1)))
    y, _ = wkv_ops.wkv(_t(r), _t(k), _t(v), _t(lw), _t(u))
    _assert_wkv(_t(_heads(y.numpy())), want)


@pytest.mark.parametrize("T,chunk", [(32, 16), (48, 16), (64, 32), (40, 16)])
def test_wkv_matches_pallas(T, chunk):
    """Against the reference's Pallas kernel (interpret mode) where its
    chunked factorisation is finite (logw > -5)."""
    B, H, N = 1, 3, 32
    r, k, v, lw, u = _wkv_inputs(np.random.default_rng(T), B, T, H, N, None)
    want = jax_wkv(*(jnp.asarray(_heads(a)) for a in (r, k, v, lw)),
                   jnp.asarray(np.tile(u, (B, 1))), use_pallas=True,
                   interpret=True, chunk=chunk)
    y, _ = wkv_ops.wkv(_t(r), _t(k), _t(v), _t(lw), _t(u))
    _assert_wkv(_t(_heads(y.numpy())), want)


@pytest.mark.parametrize("T", [1, 17, 32, 40])
@pytest.mark.parametrize("logw", [-1e-4, -0.5, None])
def test_wkv_matches_model_chunked_with_state(T, logw):
    """Against the reference model's ``wkv_chunked`` from a nonzero initial
    state: y and the final state, T a whole number of 16-token chunks or
    not (the tail is not padded, so the final state is not decayed)."""
    B, H, N = 2, 2, 16
    rng = np.random.default_rng(T)
    r, k, v, lw, u = _wkv_inputs(rng, B, T, H, N, logw)
    s0 = rng.normal(size=(B, H, N, N)).astype(np.float32)
    y_want, s_want = wkv_chunked(r, k, v, lw, u, s0, chunk=16)
    y, s = wkv_ops.wkv(_t(r), _t(k), _t(v), _t(lw), _t(u), _t(s0))
    _assert_wkv(y, y_want, "y")
    _assert_wkv(s, s_want, "state")


def test_reference_chunked_wkv_overflows_where_k5_does_not():
    """The reference's ``wkv_chunked`` forms exp(-cumsum(logw)) over a
    16-token chunk, which overflows at a constant logw of -6 (within the
    model's clip range); K5's plain version stays finite and equals the
    exact recurrence."""
    B, T, H, N = 1, 32, 1, 8
    r, k, v, lw, u = _wkv_inputs(np.random.default_rng(0), B, T, H, N, -6.0)
    y_chunked, _ = wkv_chunked(r, k, v, lw, u, np.zeros((B, H, N, N),
                                                        np.float32))
    assert not np.isfinite(np.asarray(y_chunked)).all()
    y, _ = wkv_ops.wkv(_t(r), _t(k), _t(v), _t(lw), _t(u))
    _assert_wkv(_t(_heads(y.numpy())),
                jax_wkv_ref(*(_heads(a) for a in (r, k, v, lw)), u))


def test_wkv_with_no_tokens_returns_the_state():
    s0 = torch.randn(2, 3, 8, 8)
    z = torch.zeros(2, 0, 3, 8)
    y, s = wkv_ops.wkv(z, z, z, z, torch.zeros(3, 8), s0)
    assert tuple(y.shape) == (2, 0, 3, 8)
    assert torch.equal(s, s0)


def test_wkv_refuses_other_devices():
    m = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        wkv_ops.wkv(m, m, m, m, torch.zeros(2, 8, device="meta"))
    c = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_ops.wkv(c, c, c, m, torch.zeros(2, 8))



def test_wkv_refuses_forms_the_kernel_does_not_take():
    """Head sizes, dtypes, layouts and alignments the CUDA kernel does not
    take raise before any launch (the checks it runs on CUDA tensors)."""
    r = torch.zeros(1, 4, 2, 8)
    u = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="head size"):
        z = torch.zeros(1, 4, 1, 128)
        wkv_ops._check_forms(z, z, z, z, torch.zeros(1, 128), None)
    with pytest.raises(TypeError, match="float32"):
        d = r.double()
        wkv_ops._check_forms(d, d, d, d, u.double(), None)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 4, 8).transpose(1, 2)
        wkv_ops._check_forms(t, t, t, t, u, None)
    with pytest.raises(ValueError, match="state"):
        wkv_ops._check_forms(r, r, r, r, u, torch.zeros(1, 2, 8, 4))
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(r.numel() + 1)[1:].view(1, 4, 2, 8)
        wkv_ops._check_forms(shifted, r, r, r, u, None)
    wkv_ops._check_forms(r, r, r, r, u, torch.zeros(1, 2, 8, 8))

"""K4's forward at head width 256 on the tensor cores, before any card run:
a tile-by-tile model of ``flash_fwd_tc_kernel<256>`` (``k4_fwd_model``:
128 queries a CTA, 64 per consumer, 64-key tiles) against the exact
attention, against the plain version and against the reference model's
``attend``; and the routes the forward and the backward take at hd 256.

Tolerances.  The model without rounding runs in float64: 1e-12 of the
outputs (about 1 in size) and of 1 + |lse|, so a key missed or added by
a tile skipped, a first tile too late or a mask at a tile's seam shows
(one key moves an output by about 1/T, far over 1e-12).  With the card's
roundings (P to bf16 before P.V, float32 sums, a bf16 output) on inputs
that hold bf16 values: 2^-6, the limit ``chip_smoke.py`` holds K4's bf16
rows to against the plain version.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from k4_fwd_model import fwd_model  # noqa: E402
from repro.models.attention import attend as jax_attend  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

HD = 256
BF16_TOL = 2.0 ** -6


def _inputs(seed, B, S, T, H, K, bf16=False):
    """q, k, v from a numpy seed, float64, or float32 holding bf16 values
    (what the kernel reads) with ``bf16``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape) for shape in
            ((B, S, H, HD), (B, T, K, HD), (B, T, K, HD))]
    if bf16:
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _exact(q, k, v, causal, q_offset, window):
    """Attention in float64, the mask built here from positions: (o (B,
    S, H, hd), lse (B, H, S) in log2 units, +inf and a zero output for a
    query that sees no key), as numpy arrays."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    kr, vr = (a.repeat_interleave(H // K, dim=2) for a in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(hd)
    pos = q_offset + torch.arange(S)[:, None]
    t = torch.arange(T)[None, :]
    seen = torch.ones((S, T), dtype=torch.bool)
    if causal:
        seen &= t <= pos
    if window:
        seen &= pos - t < window
    s = s.masked_fill(~seen, -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m)
    den = e.sum(-1)                                        # (B, H, S)
    some = den > 0
    d = torch.where(some, den, 1.0)
    o = torch.einsum("bhqk,bkhd->bqhd", e / d[..., None], vr)
    lse = torch.where(some, (m[..., 0] + torch.log(d)) / math.log(2.0),
                      math.inf)
    return o.numpy(), lse.numpy()


def _check_exact(S, T, G, causal, q_offset, window, seed):
    q, k, v = _inputs(seed, 1, S, T, G, 1)
    o, lse = fwd_model(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                       q_offset, window, rounding=False)
    want_o, want_lse = _exact(q, k, v, causal, q_offset, window)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=1e-12)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 2, 63, 64, 65, 66, 127, 128, 129])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 129, 300])
def test_fwd_tiles_give_the_exact_attention_unrounded(L, window, causal, G):
    """Without rounding, the model's first tile, last tile, skipped tiles
    and seam masks give the exact attention (float64) at S = T = L, every
    window about a 64-key tile's seams, causal or not, MQA 1:1 and 10:1:
    outputs and log-sum-exps within 1e-12.  Windows 2 and 66 put a
    consumer's first visible key in the last slot of a tile, so a tile
    skipped or a first tile chosen one key too eagerly shows."""
    _check_exact(L, L, G, causal, 0, window, seed=L * 1000 + window)


@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("S,T,causal,q_offset,window", [
    (100, 612, True, 512, 0), (100, 612, True, 512, 64),
    (100, 612, True, 512, 129), (100, 612, True, 510, 0),
    (100, 612, True, 511, 0), (100, 612, True, 510, 66),
    (200, 700, True, 449, 0),
    (37, 611, False, 0, 0), (37, 611, False, 0, 65),
    (65, 129, True, 150, 65)])
def test_fwd_tiles_exact_at_an_offset_and_ragged(S, T, causal, q_offset,
                                                 window, G):
    """The same at S != T: queries at q_offset 512 over 612 keys (a
    prompt's last 100 after a cache), and at 510 and 511, where a
    consumer's first query sits 62 and 63 keys into a tile (the causal
    seam mask's edge cases), 200 at 449 over 700, where a consumer's and
    a CTA's last query sees the first key of a tile (the last tile each
    visits); non-causal 37 over 611; and queries at
    150-214 over 129 keys with window 65, where the later ones see no key
    (+inf and a zero output)."""
    _check_exact(S, T, G, causal, q_offset, window, seed=S + T + window)


@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,window", [(65, 0), (65, 64), (300, 0),
                                      (300, 63), (300, 129)])
def test_fwd_bf16_rounding_fits_the_card_tolerance(S, window, causal, G):
    """With the kernel's roundings, on inputs that hold bf16 values, the
    model stays within 2^-6 of the plain version (``attention_ref``, P in
    float32) on the same inputs: the limit the card's hd-256 rows are held
    to stands without loosening."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(S + window, 2, S, S, G, 1, bf16=True))
    o, _ = fwd_model(q, k, v, causal, 0, window)
    want = attention_ref(q, k, v, causal, 0, window)
    assert float((o - want).abs().max()) <= BF16_TOL


def test_fwd_model_matches_jax_attend_windowed_mqa():
    """At recurrentgemma's form, hd 256, MQA 10:1, causal with window 128,
    S 300, the model with the kernel's roundings against the reference
    model's ``attend`` (float32 on the CPU) on the same numpy-seeded bf16
    inputs: within 2^-6."""
    B, S, H = 2, 300, 10
    q, k, v = _inputs(22, B, S, S, H, 1, bf16=True)
    want = np.asarray(jax_attend(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=128,
                                 q_chunk=64)).reshape(B, S, H, HD)
    o, _ = fwd_model(*(torch.from_numpy(a) for a in (q, k, v)), True, 0,
                     128)
    assert float(np.abs(o.numpy() - want).max()) <= BF16_TOL


def _aligned_layouts():
    """(data_ptr, shape, stride) of aligned bf16 q, k, v at hd 256."""
    st = (24 * 10 * HD, 10 * HD, HD, 1)
    return [(0x10000, (2, 24, 6, HD), st),
            (0x10000 + 2 * 6 * HD, (2, 24, 2, HD), st),
            (0x10000 + 2 * 8 * HD, (2, 24, 2, HD), st)]


def test_hd256_bf16_forward_tensor_cores_backward_cuda_cores():
    """bf16 at hd 256 takes the tensor cores forward and the CUDA cores
    backward (whose tensor-core kernels take 64-128 only); float32 at hd
    256 takes the CUDA cores both ways."""
    layouts = _aligned_layouts()
    assert fa_ops.pick_route(torch.bfloat16, HD, layouts) == "tensor_cores"
    assert HD not in fa_ops.TENSOR_CORE_BWD_HEAD_DIMS
    q = torch.zeros(2, 24, 6, HD, dtype=torch.bfloat16)
    k = torch.zeros(2, 24, 2, HD, dtype=torch.bfloat16)
    assert fa_ops.route_of(q, k, k) == "tensor_cores"
    assert fa_ops.bwd_route_of(q, k, k) == "cuda_cores"
    assert fa_ops.route_of(q.float(), k.float(), k.float()) == "cuda_cores"
    assert fa_ops.bwd_route_of(q.float(), k.float(),
                               k.float()) == "cuda_cores"


def test_hd256_misaligned_bf16_raises():
    """A bf16 q at hd 256 whose base pointer is 2 bytes off a 16-byte
    boundary raises ValueError in ``pick_route`` rather than take the CUDA
    cores, as at 64-128."""
    layouts = _aligned_layouts()
    ptr, shape, stride = layouts[0]
    layouts[0] = (ptr + 2, shape, stride)
    with pytest.raises(ValueError, match="tensor-core route"):
        fa_ops.pick_route(torch.bfloat16, HD, layouts)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tc19flash_fwd_tc_kernelILi256EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc19flash_fwd_tc_kernelILi256EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z13flash_fwd_cc' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Function properties for _Z13flash_fwd_cc
    8 bytes stack frame, 8 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def test_parse_ptxas_reads_registers_spills_and_notes():
    """``build.parse_ptxas`` (which ``chip_smoke.py`` and the GPU test read
    to fail a spilling ``flash_fwd_tc_kernel<256>``) gives each kernel of
    an ``nvcc -Xptxas -v`` log its registers, spill bytes and notes."""
    got = build.parse_ptxas(PTXAS_LOG)
    assert got == {
        "_ZN2tc19flash_fwd_tc_kernelILi256EEEvNS_6ParamsE": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0,
            "notes": []},
        "_Z13flash_fwd_cc": {
            "registers": 128, "spill_stores": 8, "spill_loads": 56,
            "notes": ["ptxas info    : (C7515) Potential Performance Loss: "
                      "wgmma.mma_async instructions are serialized"]}}

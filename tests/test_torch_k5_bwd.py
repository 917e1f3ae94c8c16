"""K5's backward on the CPU, before any card run: the plain version
(``ref.wkv_bwd_ref``) against ``jax.grad`` of the reference's exact
recurrence (``repro.kernels.rwkv_scan.ref.wkv_ref``) over the model's whole
clip range of logw, against ``jax.vjp`` of the reference model's
``wkv_chunked`` with an initial state and a final-state cotangent, and
against autograd through the port's own ``wkv_ref``; ``WkvFn``'s glue with
its two launches swapped for the plain versions by this file's
monkeypatch; the checkpoints ``wkv_fwd`` gives; and a float64 model of the
backward kernels' schedule (``k5_bwd_model.py``: the chunk-boundary carry,
then every chunk from its checkpoint and stored G_end, the column groups
of a cluster summed in rank order), which must give the exact gradient for
every chunk length, chunks per cluster, ragged T and number of column
groups, and agree with ``jax.vjp`` of the reference, while its off-by-one
mutants fail.

Tolerances, each of a gradient's largest |want| (float32 sums in another
order; the recurrences agree term by term): 1e-5 for dr, dk, dv, du and
the initial state's gradient; 1e-4 for dlogw, whose w_t * sum_j G S
multiplies two sums over up to T decayed terms; the same against
``wkv_chunked`` at logw >= -4.  The float64 model: 1e-10
of the largest |want| unrounded (only the summation order differs), and a
mutant must miss by more than 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from k5_bwd_model import (MUTANTS, Schedule, bwd_model,  # noqa: E402
                          carry, exact_grads)
from repro.kernels.rwkv_scan.ref import wkv_ref as jax_wkv_ref  # noqa: E402
from repro.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import (  # noqa: E402
    checkpoints_ref, wkv_bwd_ref, wkv_ref)

NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")
TOL = {"dr": 1e-5, "dk": 1e-5, "dv": 1e-5, "dlogw": 1e-4, "du": 1e-5,
       "dstate0": 1e-5}
B, H, N = 2, 3, 16


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _logw(rng, shape, logw, lo=20.0):
    """A constant logw, or (None) per-channel decays spread log-uniformly
    over [-lo, -1e-4]."""
    if logw is None:
        return -np.exp(rng.uniform(np.log(1e-4), np.log(lo), shape))
    return np.full(shape, logw)


def _inputs(seed, B, T, H, N, logw, lo=20.0):
    """r, k, v, logw, u, s0, dy, ds as float32 numpy arrays from a seed."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, N)) for _ in range(3))
    lw = _logw(rng, (B, T, H, N), logw, lo)
    u = rng.normal(size=(H, N)) * 0.3
    s0 = rng.normal(size=(B, H, N, N))
    dy = rng.normal(size=(B, T, H, N))
    ds = rng.normal(size=(B, H, N, N))
    return [a.astype(np.float32) for a in (r, k, v, lw, u, s0, dy, ds)]


def _heads(a):   # (B, T, H, N) -> (B * H, T, N)
    b, t, h, n = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, t, n)


def _unheads(a, b):   # (B * H, T, N) -> (B, T, H, N)
    bh, t, n = a.shape
    return a.reshape(b, bh // b, t, n).transpose(0, 2, 1, 3)


def _assert_grads(got, want, tol, names=NAMES):
    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        if b.size == 0:
            continue
        err = np.abs(a - b).max()
        assert err <= tol[name] * max(np.abs(b).max(), 1e-30), \
            (name, err, np.abs(b).max())


@pytest.mark.parametrize("logw", [-1e-4, -0.5, -5.0, -20.0, None])
@pytest.mark.parametrize("T", [1, 17, 64, 65])
def test_bwd_ref_matches_jax_grad_of_oracle(T, logw):
    """Against ``jax.vjp`` of the reference's exact ``lax.scan`` (zero
    initial state) with a seeded cotangent, over the clip range of logw
    [-20, -1e-4] (None: spread over it); the reference's u is per (batch x
    head), so its du is summed over the batch."""
    r, k, v, lw, u, _, dy, _ = _inputs(T, B, T, H, N, logw)
    _, vjp = jax.vjp(jax_wkv_ref, *(jnp.asarray(_heads(a))
                                    for a in (r, k, v, lw)),
                     jnp.asarray(np.tile(u, (B, 1))))
    grads = vjp(jnp.asarray(_heads(dy)))
    want = [_unheads(np.asarray(g), B) for g in grads[:4]]
    want.append(np.asarray(grads[4]).reshape(B, H, N).sum(0))
    got = wkv_bwd_ref(*(_t(a) for a in (r, k, v, lw, u)), None, _t(dy),
                      None)
    _assert_grads(got[:5], want, TOL)


@pytest.mark.parametrize("logw", [-1e-4, -0.5, None])
@pytest.mark.parametrize("T", [16, 17, 32, 40])
def test_bwd_ref_matches_jax_vjp_of_chunked_with_state(T, logw):
    """Against ``jax.vjp`` of the reference model's ``wkv_chunked`` (the
    function the reference trains through) from a nonzero initial state,
    with cotangents of y and of the final state, T a whole number of its
    16-token chunks or not, at logw in [-4, -1e-4] only: below that its
    factorisation overflows (``test_torch_llm_kernels.py::
    test_reference_chunked_wkv_overflows_where_k5_does_not``)."""
    r, k, v, lw, u, s0, dy, ds = _inputs(T + 100, B, T, H, N, logw, lo=4.0)
    _, vjp = jax.vjp(lambda *a: wkv_chunked(*a, chunk=16),
                     *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = wkv_bwd_ref(*(_t(a) for a in (r, k, v, lw, u, s0, dy, ds)))
    _assert_grads(got, want, TOL)


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("T", [0, 1, 17, 70])
def test_bwd_ref_matches_autograd_through_wkv_ref(T, chunk):
    """Against autograd through the port's ``wkv_ref`` (the CPU path of
    ``wkv``) with an initial state and both cotangents, for any chunk of
    the plain version's own checkpoints."""
    r, k, v, lw, u, s0, dy, ds = _inputs(T + 7, B, T, H, N, None)
    ins = [_t(a).requires_grad_() for a in (r, k, v, lw, u, s0)]
    y, s = wkv_ref(*ins)
    want = torch.autograd.grad((y * _t(dy)).sum() + (s * _t(ds)).sum(),
                               ins, allow_unused=True)
    want = [torch.zeros_like(a) if g is None else g
            for a, g in zip(ins, want)]
    got = wkv_bwd_ref(*(_t(a) for a in (r, k, v, lw, u, s0, dy, ds)),
                      chunk=chunk)
    _assert_grads(got, want, TOL)


def test_wkv_bwd_on_cpu_tensors_is_the_plain_version():
    r, k, v, lw, u, s0, dy, ds = (_t(a) for a in _inputs(3, B, 20, H, N,
                                                         None))
    got = wkv_ops.wkv_bwd(r, k, v, lw, u, s0, dy, ds)
    for a, b in zip(got, wkv_bwd_ref(r, k, v, lw, u, s0, dy, ds)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", [0, 1, 16, 17, 40])
def test_wkv_fwd_checkpoints_are_the_states_every_16_tokens(T):
    """``wkv_fwd``'s third output: the state before tokens 0, 16, 32, ...
    (what the forward kernel saves), each the final state of ``wkv_ref``
    over the tokens before it."""
    r, k, v, lw, u, s0, _, _ = (_t(a) for a in _inputs(T, B, T, H, N, None))
    y, s, ck = wkv_ops.wkv_fwd(r, k, v, lw, u, s0)
    assert ck.shape == (B, H, -(-T // wkv_ops.CKPT_TOKENS), N, N)
    for c in range(ck.shape[2]):
        t = c * wkv_ops.CKPT_TOKENS
        _, want = wkv_ref(r[:, :t], k[:, :t], v[:, :t], lw[:, :t], u, s0)
        assert torch.allclose(ck[:, :, c], want, rtol=1e-6, atol=1e-6)
    yw, sw = wkv_ref(r, k, v, lw, u, s0)
    assert torch.equal(y, yw) and torch.equal(s, sw)
    assert torch.equal(checkpoints_ref(k, v, lw, s0, 16), ck)


def _plain_launches(monkeypatch):
    """Swap ``WkvFn``'s two launches for the plain versions; returns the
    record of what the backward was handed."""
    seen = {}

    def forward(r, k, v, logw, u, state, checkpoints):
        y, s = wkv_ref(r, k, v, logw, u, state)
        return y, s, checkpoints_ref(k, v, logw, state,
                                     wkv_ops.CKPT_TOKENS)

    def backward(r, k, v, logw, u, ckpt, dy, dstate, needs):
        seen.update(needs=tuple(needs), dy_contiguous=dy.is_contiguous(),
                    dstate=dstate)
        state = ckpt[:, :, 0] if ckpt.shape[2] else None
        grads = wkv_bwd_ref(r, k, v, logw, u, state, dy, dstate)
        return [g if n else None for g, n in zip(grads, needs)]
    monkeypatch.setattr(wkv_ops, "_forward", forward)
    monkeypatch.setattr(wkv_ops, "_backward", backward)
    return seen


@pytest.mark.parametrize("case", ["all", "no_state", "y_only", "state_only",
                                  "u_only", "noncontiguous_dy"])
def test_wkv_fn_glue(case, monkeypatch):
    """``WkvFn`` on CPU tensors with its launches swapped for the plain
    versions: None initial state, no cotangent of the final state (None, the
    kernel's zeros), none of y (zeros), only u requiring grad (every other
    grad not computed), and a non-contiguous dy (handed on contiguous).
    Gradients against autograd through ``wkv_ref``."""
    seen = _plain_launches(monkeypatch)
    T = 21
    r, k, v, lw, u, s0, dy, ds = (_t(a) for a in _inputs(5, B, T, H, N,
                                                         None))
    state = None if case == "no_state" else s0
    grad = [case != "u_only"] * 4 + [True, case not in ("no_state",
                                                        "u_only")]
    ins = [a.clone().requires_grad_(g) for a, g in
           zip((r, k, v, lw, u, s0), grad)]
    if state is None:
        ins[5] = None
    c = torch.randn(B, H, T, N, generator=torch.Generator().manual_seed(1))

    def loss(y, s):
        if case == "y_only":
            return (y * dy).sum()
        if case == "state_only":
            return (s * ds).sum()
        if case == "noncontiguous_dy":     # d/dy: c transposed, a view
            return (y.transpose(1, 2) * c).sum()
        return (y * dy).sum() + (s * ds).sum()
    leaves = [a for a in ins if a is not None and a.requires_grad]
    got = torch.autograd.grad(loss(*wkv_ops.WkvFn.apply(*ins)), leaves)
    want = torch.autograd.grad(loss(*wkv_ref(*ins)), leaves,
                               allow_unused=True)     # r: not in the state
    for a, b in zip(got, want):
        b = torch.zeros_like(a) if b is None else b
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * float(
            b.abs().max()))
    assert seen["needs"] == tuple(grad[:5]) + (state is not None
                                               and grad[5],)
    assert seen["dy_contiguous"]
    assert (seen["dstate"] is None) == (case == "y_only" or
                                        case == "noncontiguous_dy")


# ---------------------------------------------------------------------------
# The float64 model of the backward kernel's schedule
# ---------------------------------------------------------------------------

def _model_inputs(seed, B, T, H, N):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.normal(size=(B, T, H, N)) for _ in range(4))
    lw = _logw(rng, (B, T, H, N), None)
    u = rng.normal(size=(H, N)) * 0.3
    s0, ds = (rng.normal(size=(B, H, N, N)) for _ in range(2))
    return r, k, v, lw, u, s0, dy, ds


def _model_err(args, sched, mutant=None):
    """The model's largest error over the exact gradient, each over its
    gradient's largest |want|."""
    got = bwd_model(*args, sched=sched, mutant=mutant)
    want = exact_grads(*args)
    return max(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
               for a, b in zip(got, want) if b.size)


@pytest.mark.parametrize("regroup", [1, 2])
@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("T", [0, 1, 3, 16, 17, 37])
def test_schedule_model_gives_the_exact_gradient(T, chunk, regroup):
    """Ragged T (T % chunk != 0, T < chunk, T = 1, T = 0), the forward's
    regrouped updates at the checkpoints, three uneven column groups."""
    args = _model_inputs(T, 2, T, 2, 8)
    assert _model_err(args, Schedule(chunk, 3, regroup)) <= 1e-10


@pytest.mark.parametrize("n_groups", range(1, 9))
def test_schedule_model_any_number_of_groups(n_groups):
    """Every number of column groups from 1 to N (8), summed in reverse
    order as well as in order."""
    args = _model_inputs(n_groups, 2, 37, 2, 8)
    for order in ((), tuple(reversed(range(n_groups)))):
        assert _model_err(args, Schedule(16, n_groups, 2, order)) <= 1e-10


@pytest.mark.parametrize("per_cta", [1, 2, 3, 5])
@pytest.mark.parametrize("T", [0, 1, 16, 17, 37, 80])
def test_schedule_model_any_chunks_per_cluster(T, per_cta):
    """A cluster walking ``per_cta`` chunks, each from its own stored G_end,
    du added over them: ragged T and a last group of fewer chunks."""
    args = _model_inputs(T + 50 * per_cta, 2, T, 2, 8)
    assert _model_err(args, Schedule(16, 4, 2, (), per_cta)) <= 1e-10


@pytest.mark.parametrize("T", [1, 16, 37])
def test_schedule_model_carry_is_the_token_walk(T):
    """The carry's matrix form, G before a chunk = diag(A) G_end +
    (P r)^T Dy, against G walked token by token: G_end of every chunk and
    the initial state's gradient."""
    r, k, v, lw, u, s0, dy, ds = _model_inputs(T, 2, T, 2, 8)
    sched = Schedule(4, 2, 2)
    gend, ds0 = carry(r, lw, dy, ds, sched)
    g, want = ds.copy(), {}
    for t in reversed(range(T)):
        if (t + 1) % sched.chunk == 0 or t == T - 1:
            want[t // sched.chunk] = g.copy()
        g = np.exp(lw[:, t])[..., None] * g + \
            r[:, t, :, :, None] * dy[:, t, :, None, :]
    assert sorted(want) == list(range(gend.shape[2]))
    for p, a in want.items():
        assert np.abs(gend[:, :, p] - a).max() <= 1e-12 * np.abs(a).max()
    assert np.abs(ds0 - g).max() <= 1e-12 * np.abs(g).max()


@pytest.mark.parametrize("logw", [-1e-4, -20.0, None])
@pytest.mark.parametrize("T", [1, 17, 48])
def test_schedule_model_matches_jax_vjp_of_oracle(T, logw):
    """The kernels' schedule at rwkv6-7b's head size (``BWD_CLUSTER[64]``
    ranks, ``BWD_CHUNKS_PER_CTA`` chunks a cluster) against ``jax.vjp`` of
    the reference's exact ``lax.scan`` (zero initial state and final-state
    cotangent), logw at both ends of the clip range and spread over it."""
    N = 64
    r, k, v, lw, u, _, dy, _ = _inputs(T + 3, 1, T, 1, N, logw)
    _, vjp = jax.vjp(jax_wkv_ref, *(jnp.asarray(_heads(a))
                                    for a in (r, k, v, lw)),
                     jnp.asarray(u))
    grads = vjp(jnp.asarray(_heads(dy)))
    want = [_unheads(np.asarray(g), 1) for g in grads[:4]]
    want.append(np.asarray(grads[4]))
    zero = np.zeros((1, 1, N, N))
    sched = Schedule(wkv_ops.CKPT_TOKENS, wkv_ops.BWD_CLUSTER[N], 2, (),
                     wkv_ops.BWD_CHUNKS_PER_CTA)
    got = bwd_model(*(a.astype(np.float64) for a in (r, k, v, lw, u)), zero,
                    dy.astype(np.float64), zero, sched=sched)
    _assert_grads(got[:5], want, TOL)


@pytest.mark.parametrize("N", sorted(wkv_ops.BWD_CLUSTER))
def test_schedule_model_at_the_kernels_schedules(N):
    """The kernels' own schedule at each head size: ``CKPT_TOKENS`` between
    checkpoints, ``BWD_CLUSTER[N]`` column groups (a cluster's ranks),
    ``BWD_CHUNKS_PER_CTA`` chunks a cluster, the forward's tokens per update
    (1, 2, 4, 2 at N 8, 16, 32, 64), at B 2 and ragged T."""
    regroup = {8: 1, 16: 2, 32: 4, 64: 2}[N]
    sched = Schedule(wkv_ops.CKPT_TOKENS, wkv_ops.BWD_CLUSTER[N], regroup,
                     (), wkv_ops.BWD_CHUNKS_PER_CTA)
    for T in (37, 64):
        args = _model_inputs(N + T, 2, T, 1, N)
        assert _model_err(args, sched) <= 1e-10


@pytest.mark.parametrize("mutant", MUTANTS)
def test_schedule_model_mutants_fail(mutant):
    """Each planted off-by-one (a checkpoint one token late, G decayed
    before the chunk's last token instead of after it, a rank's partial
    left out of the cluster sum, du of one batch only, G_end stored one
    chunk late, D_chunk applied on the wrong side of the chunk's update, a
    rank's slice of rows never written, the ragged last chunk's du added
    twice) misses the exact gradient at ragged T (37 tokens, 3 chunks)."""
    args = _model_inputs(11, 2, 37, 2, 8)
    sched = Schedule(16, 4, 2)
    assert _model_err(args, sched) <= 1e-10
    assert _model_err(args, sched, mutant) > 1e-6

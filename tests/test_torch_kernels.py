"""The port's kernels (K1 fused cache lookup, K2 row gather, K3 segment sum)
against the reference package's Pallas kernels in interpret mode and their
jnp oracles, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions (``ref.py``); the
CUDA kernels are held against those plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  K1 and K2 are bit-identical; K3 sums in
another order (and with atomics on the card), so it is held to rtol/atol
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cache_lookup.ops import \
    fused_cache_lookup as jax_lookup  # noqa: E402
from repro.kernels.gather.ops import cache_gather  # noqa: E402
from repro.kernels.segment_agg.ops import \
    segment_mean as jax_mean  # noqa: E402
from repro.kernels.segment_agg.ops import \
    segment_sum as jax_sum  # noqa: E402
from repro_torch.kernels.cache_lookup import ops as lookup_ops  # noqa: E402
from repro_torch.kernels.gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.segment_agg import ops as seg_ops  # noqa: E402

ROW_DIM = 16
NAMES = ("out", "first_idx", "miss_ids", "miss_dest", "rem_ids", "rem_dest",
         "counts")


def _tables(rng, n, frac_dev=0.2, frac_host=0.3, remote=False):
    """Random loc/slot tables; the tier probabilities are normalised so any
    pair of cached fractions is a valid distribution."""
    p = np.array([frac_dev, frac_host, 0.3, 0.2] if remote
                 else [frac_dev, frac_host, 1 - frac_dev - frac_host])
    loc = rng.choice(len(p), n, p=p / p.sum()).astype(np.int32)
    slot = np.zeros(n, np.int64)
    for tier in (0, 1):
        m = loc == tier
        slot[m] = np.arange(m.sum())
    return loc, slot


def _port_lookup(ids, loc, slot, dev, host):
    return lookup_ops.fused_cache_lookup(
        torch.from_numpy(np.asarray(ids)), torch.from_numpy(loc),
        torch.from_numpy(slot), torch.from_numpy(dev),
        torch.from_numpy(host))


def _assert_lookup_equal(port, ref, tag=""):
    for name, a, b in zip(NAMES, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{tag}{name}")


# ---------------------------------------------------------------------------
# K1: fused cache lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,remote,dup", [
    (1, 64, False, False), (57, 200, True, False), (256, 128, False, False),
    (97, 500, True, False), (120, 300, True, True)])
def test_lookup_bit_identical_to_pallas(B, n, remote, dup):
    rng = np.random.default_rng(B + n)
    loc, slot = _tables(rng, n, remote=remote)
    dev = rng.normal(size=((loc == 0).sum(), ROW_DIM)).astype(np.float32)
    host = rng.normal(size=((loc == 1).sum(), ROW_DIM)).astype(np.float32)
    ids = rng.integers(0, n, B)
    if dup:     # duplicate-heavy: 8 unique ids x 15 occurrences
        ids = np.repeat(ids[:8], 15)
    port = _port_lookup(ids, loc, slot, dev, host)
    _assert_lookup_equal(port, jax_lookup(ids, loc, slot, dev, host,
                                          use_pallas=True, interpret=True),
                         "pallas ")
    _assert_lookup_equal(port, jax_lookup(ids, loc, slot, dev, host,
                                          use_pallas=False), "oracle ")
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    np.testing.assert_array_equal(port[1].numpy(), first[inv])


def test_lookup_empty_tiers():
    """Every id on storage: both tiers empty (padded inside the wrapper)
    and the miss list is the whole deduplicated batch, in batch order."""
    ids = np.array([5, 3, 5, 5, 9])
    loc = np.full(16, 2, np.int32)
    slot = np.zeros(16, np.int64)
    empty = np.zeros((0, ROW_DIM), np.float32)
    port = _port_lookup(ids, loc, slot, empty, empty)
    _assert_lookup_equal(port, jax_lookup(ids, loc, slot, empty, empty,
                                          use_pallas=True, interpret=True))
    assert port[0].abs().sum() == 0
    assert port[6].tolist() == [3, 0]
    assert port[2][:3].tolist() == [5, 3, 9]
    assert port[3][:3].tolist() == [0, 1, 4]


@pytest.mark.parametrize("fracs", [(0.0, 0.0), (0.45, 0.0), (0.0, 0.45),
                                   (0.2, 0.3), (0.45, 0.45)])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_miss_list_partitions_batch(fracs, seed):
    """miss-list ids ∪ hit ids == input ids, with no overlap, and every
    dest points at the first occurrence of its id; the port equals the
    jnp oracle on the same tables."""
    rng = np.random.default_rng(seed)
    n = 256
    ids = rng.integers(0, n, 1 + int(rng.integers(0, 300)))
    loc, slot = _tables(rng, n, fracs[0], fracs[1], remote=True)
    dev = rng.normal(size=((loc == 0).sum(), 4)).astype(np.float32)
    host = rng.normal(size=((loc == 1).sum(), 4)).astype(np.float32)
    port = _port_lookup(ids, loc, slot, dev, host)
    _assert_lookup_equal(port, jax_lookup(ids, loc, slot, dev, host,
                                          use_pallas=False))
    out, fi, mid, mdst, rid, rdst, cnt = (x.numpy() for x in port)
    nm, nr = int(cnt[0]), int(cnt[1])
    miss = set(mid[:nm]) | set(rid[:nr])
    hits = {int(i) for i in ids if loc[i] <= 1}
    assert not miss & hits
    assert miss | hits == {int(i) for i in ids}
    assert not set(mid[:nm]) & set(rid[:nr])
    for v, d in list(zip(mid[:nm], mdst[:nm])) + list(zip(rid[:nr],
                                                          rdst[:nr])):
        assert ids[d] == v and fi[d] == d


def test_lookup_out_buffer_is_filled_in_place():
    rng = np.random.default_rng(7)
    loc, slot = _tables(rng, 64)
    dev = rng.normal(size=((loc == 0).sum(), ROW_DIM)).astype(np.float32)
    host = rng.normal(size=((loc == 1).sum(), ROW_DIM)).astype(np.float32)
    ids = rng.integers(0, 64, 40)
    buf = torch.full((40, ROW_DIM), 7.0)
    res = lookup_ops.fused_cache_lookup(
        torch.from_numpy(ids), torch.from_numpy(loc), torch.from_numpy(slot),
        torch.from_numpy(dev), torch.from_numpy(host), out=buf)
    assert res[0] is buf
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(jax_lookup(ids, loc, slot, dev, host)[0]))


def test_lookup_out_of_range_ids_give_zero_rows_and_no_miss():
    """An id outside [0, N) (the kernel's contract, which the reference
    does not define): a zero row, its own position as first occurrence,
    no miss and no remote entry; every other output as for the in-range
    ids alone."""
    rng = np.random.default_rng(11)
    n = 300
    loc, slot = _tables(rng, n, remote=True)
    dev = rng.normal(size=((loc == 0).sum(), 8)).astype(np.float32)
    host = rng.normal(size=((loc == 1).sum(), 8)).astype(np.float32)
    ids = rng.integers(0, 40, 200)
    bad = np.array([3, 50, 51, 120, 199])
    ids[bad] = [-1, n, n + 7, -5, 1 << 30]
    out, fi, mid, mdst, rid, rdst, cnt = (
        x.numpy() for x in _port_lookup(ids, loc, slot, dev, host))
    assert not out[bad].any()
    np.testing.assert_array_equal(fi[bad], bad)
    assert not set(mdst[:cnt[0]]) & set(bad)
    assert not set(rdst[:cnt[1]]) & set(bad)
    good = np.setdiff1d(np.arange(200), bad)
    ref = _port_lookup(ids[good], loc, slot, dev, host)
    np.testing.assert_array_equal(out[good], ref[0].numpy())
    np.testing.assert_array_equal(fi[good], good[ref[1].numpy()])
    np.testing.assert_array_equal(cnt, ref[6].numpy())
    np.testing.assert_array_equal(mid[:cnt[0]], ref[2].numpy()[:cnt[0]])
    np.testing.assert_array_equal(mdst[:cnt[0]],
                                  good[ref[3].numpy()[:cnt[0]]])
    assert (mid[cnt[0]:] == -1).all() and (rdst[cnt[1]:] == -1).all()


@pytest.mark.parametrize("B,cap,ctas", [(0, 1024, 1), (1, 1024, 1),
                                        (512, 1024, 8), (513, 2048, 9),
                                        (11106, 32768, 132),
                                        (150000, 524288, 132)])
def test_lookup_table_and_grid_sizes(B, cap, ctas):
    """The card's dedup table has a power of two of at least 2B slots (and
    1024); the host-tier rows get one CTA per 64 positions, 1 to 132."""
    assert lookup_ops.table_capacity(B) == cap
    assert cap >= 2 * B and cap & (cap - 1) == 0
    assert lookup_ops.host_ctas(B) == ctas


def test_lookup_table_epochs_only_decrease_and_restart():
    """Every call tags the table with a smaller epoch, never the all-ones
    word of an unused slot; at 0 the table is cleared and the epochs
    start over."""
    t = lookup_ops._Table(torch.device("cpu"), 1024)
    assert (t.keys == -1).all() and (t.vals == -1).all()
    assert t.host_count.tolist() == [0]
    e = [t.next_epoch() for _ in range(3)]
    assert e == [0xFFFFFFFE, 0xFFFFFFFD, 0xFFFFFFFC]
    t.keys[:5] = 123
    t.epoch = 1
    assert t.next_epoch() == 0xFFFFFFFE and (t.keys == -1).all()


# ---------------------------------------------------------------------------
# K2: row gather
# ---------------------------------------------------------------------------

def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """float32 values exactly representable in bfloat16."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("n,d,b", [(32, 64, 8), (128, 128, 64), (64, 256, 1),
                                   (257, 128, 33), (300, 24, 7), (50, 5, 13),
                                   (10, 16, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_bit_identical_to_pallas(n, d, b, dtype):
    rng = np.random.default_rng(n + d + b)
    table = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, b).astype(np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    if dtype == "bfloat16":
        table = _bf16_exact(table)
    want = (np.asarray(table)[idx] if b == 0 else np.asarray(
        cache_gather(jnp.asarray(table, jdt), idx, use_pallas=True,
                     interpret=True).astype(jnp.float32)))
    t = torch.from_numpy(table).to(tdt)
    for ix in (torch.from_numpy(idx), torch.from_numpy(idx.astype(np.int64))):
        got = gather_ops.gather_rows(t, ix)
        assert got.dtype == tdt and got.shape == (b, d)
        np.testing.assert_array_equal(got.float().numpy(), want)


def _gather_indices(pattern: str, n: int, rng) -> np.ndarray:
    """Index vectors of the forms the kernel treats apart: the pairs of
    equal neighbours it loads once (sorted runs, as the served expansion
    has, an odd count so the last pair has one row, all one row) and
    random order."""
    if pattern == "random":
        return rng.integers(0, n, 40)
    if pattern == "one_row":
        return np.full(40, n // 2)
    runs = np.repeat(np.sort(rng.choice(n, 9, replace=False)),
                     rng.integers(1, 5, 9))
    return runs if pattern == "sorted_runs" else runs[:len(runs) // 2 * 2 + 1]


@pytest.mark.parametrize("pattern", ["random", "sorted_runs", "odd_runs",
                                     "one_row"])
@pytest.mark.parametrize("row_bytes", [4, 12, 1020, 1024, 4112, 65536])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_row_widths_and_runs_match_pallas(dtype, row_bytes, pattern):
    """The plain version the wrapper runs on the CPU against the Pallas
    kernel (interpret mode) at the row widths, in bytes, that pick the
    kernel's copy unit (4 to 16 bytes) and at repeated-index patterns;
    int32 and int64 indices."""
    rng = np.random.default_rng(row_bytes)
    jdt, tdt, size = ((jnp.float32, torch.float32, 4) if dtype == "float32"
                      else (jnp.bfloat16, torch.bfloat16, 2))
    table = rng.normal(size=(24, row_bytes // size)).astype(np.float32)
    if dtype == "bfloat16":
        table = _bf16_exact(table)
    idx = _gather_indices(pattern, 24, rng).astype(np.int32)
    want = np.asarray(cache_gather(jnp.asarray(table, jdt), idx,
                                   use_pallas=True, interpret=True)
                      .astype(jnp.float32))
    t = torch.from_numpy(table).to(tdt)
    for ix in (torch.from_numpy(idx), torch.from_numpy(idx.astype(np.int64))):
        got = gather_ops.gather_rows(t, ix)
        assert got.dtype == tdt and got.shape == (len(idx), table.shape[1])
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_plain_version_zero_row_out_of_range():
    """The plain K2 gives a zero row for an index outside [0, N) (-1, N,
    2^30), as the card's kernel does, and ``table[idx]`` inside."""
    rng = np.random.default_rng(12)
    table = rng.normal(size=(50, 7)).astype(np.float32)
    idx = np.array([0, -1, 49, 50, 1 << 30, 3, -1, 17])
    inside = (idx >= 0) & (idx < 50)
    for dt in (np.int32, np.int64):
        got = gather_ops.gather_rows(torch.from_numpy(table),
                                     torch.from_numpy(idx.astype(dt)))
        assert got.shape == (8, 7)
        assert not got.numpy()[~inside].any()
        np.testing.assert_array_equal(got.numpy()[inside],
                                      table[idx[inside]])
    empty = gather_ops.gather_rows(torch.zeros(0, 3), torch.tensor([0, -1]))
    assert empty.shape == (2, 3) and not empty.any()


def test_gather_refuses_forms_the_kernel_does_not_take():
    """What the CUDA kernel does not take raises before any launch: checked
    on meta tensors, as the wrapper checks a CUDA tensor."""
    def m(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device="meta")
    idx = m(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="2-D"):
        gather_ops._check_forms(m(2, 3, 4), idx)
    with pytest.raises(ValueError, match="2-D"):
        gather_ops._check_forms(m(4, 4), m(5, 1, dtype=torch.int64))
    with pytest.raises(TypeError, match="int32 or int64"):
        gather_ops._check_forms(m(4, 4), m(5))
    with pytest.raises(ValueError, match="contiguous"):
        gather_ops._check_forms(m(4, 8)[:, ::2], idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather_ops._check_forms(m(4, 4), m(10, dtype=torch.int64)[::2])
    gather_ops._check_forms(m(4, 3), idx)                 # 12-byte rows
    gather_ops._check_forms(m(4, 3, dtype=torch.bfloat16),
                            idx.to(torch.int32))


# ---------------------------------------------------------------------------
# K3: segment sum / mean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,d,s", [(100, 32, 8), (256, 64, 16), (513, 128, 32),
                                   (64, 16, 64), (37, 1, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_matches_pallas(e, d, s, dtype):
    """Unsorted ids, with some >= n_segments (dropped as padding)."""
    rng = np.random.default_rng(e + d)
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    if dtype == "bfloat16":
        msgs = _bf16_exact(msgs)
    segs = rng.integers(0, s + 3, e).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = jnp.asarray(msgs, jdt)
    got = seg_ops.segment_sum(torch.from_numpy(msgs).to(tdt),
                              torch.from_numpy(segs), s)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    for use_pallas in (True, False):
        want = jax_sum(jm, jnp.asarray(segs), s, use_pallas=use_pallas,
                       interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _sampler_ids(rng, n_dst, fanout, n_pad, n_seg):
    """dst_pos as the sampler emits them for one hop: runs of ``fanout``
    equal ids in shuffled order, then ``n_pad`` padded edges at id 0; a
    few ids >= n_seg (dropped)."""
    ids = np.repeat(rng.permutation(n_seg)[:n_dst], fanout)
    ids = np.concatenate([ids, np.zeros(n_pad, ids.dtype)])
    ids[rng.integers(0, len(ids), 3)] = n_seg + rng.integers(0, 4, 3)
    return ids.astype(np.int32)


@pytest.mark.parametrize("fanout", [10, 25])
@pytest.mark.parametrize("d", [1, 3, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_sampler_ids_match_pallas(dtype, d, fanout):
    """K3's plain version against the Pallas kernel (interpret mode) and
    the reference's oracle on ids shaped like the sampler's: runs of the
    fanout in shuffled order, padded edges at id 0 whose messages are
    zero (the model masks them), out-of-range ids; int32 and int64."""
    rng = np.random.default_rng(fanout * 100 + d)
    n_seg, n_dst, n_pad = 40, 12, 30
    segs = _sampler_ids(rng, n_dst, fanout, n_pad, n_seg)
    msgs = rng.normal(size=(len(segs), d)).astype(np.float32)
    msgs[len(segs) - n_pad:] = 0.0
    if dtype == "bfloat16":
        msgs = _bf16_exact(msgs)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = jnp.asarray(msgs, jdt)
    for ix in (segs, segs.astype(np.int64)):
        got = seg_ops.segment_sum(torch.from_numpy(msgs).to(tdt),
                                  torch.from_numpy(ix), n_seg)
        assert got.dtype == torch.float32 and got.shape == (n_seg, d)
        for use_pallas in (True, False):
            want = jax_sum(jm, jnp.asarray(segs), n_seg,
                           use_pallas=use_pallas, interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,D,ptr,route", [
    (torch.float32, 1, 0, "edges"), (torch.bfloat16, 4, 0, "edges"),
    (torch.float32, 3, 16, "edges"), (torch.float32, 1024, 0, "vec"),
    (torch.float32, 1020, 512, "vec"), (torch.float32, 255, 0, "scalar"),
    (torch.float32, 1024, 4, "scalar"), (torch.bfloat16, 1024, 0, "vec"),
    (torch.bfloat16, 1020, 0, "scalar"), (torch.bfloat16, 256, 8, "scalar"),
    (torch.float32, 5, 0, "scalar"), (torch.float32, 8, 0, "vec")])
def test_segment_sum_route_choice(dtype, D, ptr, route):
    """D <= 4 takes the edges route; rows of whole 16-byte units at a
    16-byte aligned address the vec route; anything else the scalar one."""
    assert seg_ops.pick_route(dtype, D, ptr) == route


@pytest.mark.parametrize("route,dtype,E,D,q,chunk", [
    ("vec", torch.float32, 3200, 1024, 4, 2),
    ("vec", torch.float32, 256000, 1024, 4, 64),
    ("vec", torch.float32, 640, 256, 2, 2),
    ("vec", torch.float32, 25600, 256, 2, 7),
    ("vec", torch.bfloat16, 3200, 1024, 4, 2),
    ("vec", torch.float32, 40000, 32, 1, 10),
    ("scalar", torch.float32, 3200, 255, 8, 2),
    ("scalar", torch.bfloat16, 65537, 1020, 8, 63),
    ("scalar", torch.float32, 100, 5, 1, 2)])
def test_segment_sum_rows_tiling(route, dtype, E, D, q, chunk):
    """Column units per lane: a power of two up to 4 vectors (8 scalars),
    no more than the row needs; edges per warp item 2-64, about 132 * 32
    items in all."""
    assert seg_ops.rows_tiling(route, dtype, E, D) == (q, chunk)


def test_segment_mean_matches_pallas():
    rng = np.random.default_rng(3)
    msgs = rng.normal(size=(200, 8)).astype(np.float32)
    segs = rng.integers(0, 20, 200).astype(np.int32)   # some >= 16: dropped
    got = seg_ops.segment_mean(torch.from_numpy(msgs),
                               torch.from_numpy(segs), 16)
    want = jax_mean(jnp.asarray(msgs), jnp.asarray(segs), 16,
                    use_pallas=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# wrappers: what they take and where they run
# ---------------------------------------------------------------------------

def test_wrappers_reject_mixed_devices():
    """A tensor off the CPU and off a card is refused, never moved."""
    t = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        gather_ops.gather_rows(t, torch.zeros(2, dtype=torch.int64,
                                              device="meta"))
    with pytest.raises(ValueError):
        seg_ops.segment_sum(t, torch.zeros(4, dtype=torch.int64,
                                           device="meta"), 2)


def test_cpu_path_counts_no_launch():
    before = (gather_ops.launches, seg_ops.launches, lookup_ops.launches)
    gather_ops.gather_rows(torch.ones(3, 2), torch.tensor([2, 0]))
    seg_ops.segment_sum(torch.ones(3, 2), torch.tensor([1, 1, 0]), 2)
    _port_lookup(np.array([1, 2]), np.array([0, 2, 2], np.int32),
                 np.zeros(3, np.int64), np.ones((1, 2), np.float32),
                 np.zeros((0, 2), np.float32))
    assert (gather_ops.launches, seg_ops.launches,
            lookup_ops.launches) == before

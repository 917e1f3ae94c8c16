"""The yardstick's operation and byte counts, against batches counted by
hand and against the K2 and K3 calls the program's step makes."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import counts
from portbench.conftest import CELLS

# a batch of 2 seeds, fanouts (2, 1): 5 real nodes of 8 padded positions
BLOCKS = [(np.array([2, 3, 3, 4]), np.array([0, 0, 1, 1]),
           np.array([True, True, True, True])),
          (np.array([0, 4, 1, 0]), np.array([2, 3, 4, 0]),
           np.array([True, True, True, False]))]
MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], bool)


def test_batch_sizes_by_hand():
    s = counts.batch_sizes(BLOCKS, MASK, 2)
    assert (s["n_pad"], s["n_real"], s["batch"], s["layer1_nodes"]) == \
        (8, 5, 2, 5)
    assert s["hops"][0] == {"e_pad": 4, "e_valid": 4,
                            "src_valid_distinct": 3, "dst_valid_distinct": 2}
    assert s["hops"][1] == {"e_pad": 4, "e_valid": 3,
                            "src_valid_distinct": 3, "dst_valid_distinct": 3}


@pytest.mark.parametrize("model,want", [
    # sage: products 2*(2*5*4*3) + 2*(2*2*3*3) = 312; means 3*4 + 3*4 +
    # 4*3 + 2*3 = 42; head 2*2*3*2 = 24; backward twice the forward
    ("sage", 3 * (312 + 42 + 24)),
    # gcn: products 2*5*4*3 + 2*2*3*3 = 156; sums 2*3*4 + 2*4*3 = 48
    ("gcn", 3 * (156 + 48 + 24))])
def test_model_flops_by_hand(model, want):
    s = counts.batch_sizes(BLOCKS, MASK, 2)
    assert counts.model_flops(model, s, 4, 3, 2) == want


def test_kernel_bytes_by_hand():
    # 4 int32 indices, 4 rows of 4 float32 written, 3 distinct rows read
    assert counts.k2_bytes(4, 4, 3) == 4 * (4 + 16) + 3 * 16
    # 4 x 4 float32 messages and their 4 ids read, 8 x 4 float32 written
    assert counts.k3_bytes(4, 4, 8) == 64 + 16 + 128
    # 2 host rows of 4 KB over PCIe outlast the HBM bytes
    assert counts.k1_bound_s(10, 3, 2, 4096) == pytest.approx(
        2 * 4096 / counts.PCIE_BYTES_S)
    hbm = 10 * (4 + 8 + 4096 + 20) + 9 * 4096
    assert counts.k1_bound_s(10, 9, 0, 4096) == pytest.approx(
        hbm / counts.HBM_BYTES_S)


def test_agg_calls_count_needed_bytes_by_hand():
    # sage, d_in 4, hidden 3.  Layer 1 over hop 2 (3 valid edges, 3
    # distinct sources, 3 distinct destinations): the gather 3 * (4 + 16)
    # + 3 * 16, the sum 48 + 12 + 48, the count 12 + 12 + 12.  Layer 2
    # over hop 1 (4 edges, 3 sources, 2 destinations): the gather 4 * (4 +
    # 12) + 3 * 12, the sum 48 + 16 + 2 * 12, the count 16 + 16 + 8; its
    # backward gathers at the 2 destinations, 64 + 24, and sums into the
    # 3 sources, 48 + 16 + 36.  The padded edge and the padded rows count
    # nothing.
    s = counts.batch_sizes(BLOCKS, MASK, 2)
    calls = counts.agg_calls("sage", s, 4, 3)
    assert [b for _, _, b in calls] == [108, 108, 36, 100, 88, 40, 88, 100]
    assert [k for k, _, _ in calls] == ["k2", "k3", "k3", "k2", "k3", "k3",
                                        "k2", "k3"]
    assert calls[1][1] == (4, 4, 8)


@pytest.mark.parametrize("name", CELLS)
def test_agg_calls_are_the_steps_calls(name, tiny_cell, monkeypatch):
    """Every K2 and K3 call of one training step on the CPU, with the
    shape it is launched at, is one of ``counts.agg_calls``."""
    from repro_torch.kernels.gather import ops as g_ops
    from repro_torch.kernels.segment_agg import ops as s_ops

    from portbench import harness
    cell = tiny_cell(name)
    seen = []
    gather, ssum = g_ops._gather, s_ops._segment_sum

    def rec_gather(table, idx, backward=False):
        seen.append(("k2", (len(idx), table.shape[1])))
        return gather(table, idx, backward)

    def rec_sum(msgs, ids, n_seg, backward=False):
        seen.append(("k3", (msgs.shape[0], msgs.shape[1], n_seg)))
        return ssum(msgs, ids, n_seg, backward)

    su = harness.Setup(cell, 5, "cpu")
    try:
        monkeypatch.setattr(g_ops, "_gather", rec_gather)
        monkeypatch.setattr(s_ops, "_segment_sum", rec_sum)
        batches = su.warm_up(1)
    finally:
        su.close()
    cfg = cell["config"]
    mb = batches[0]
    sizes = counts.batch_sizes(
        [(b.src_pos, b.dst_pos, b.edge_mask) for b in mb.blocks],
        mb.node_mask, cfg["batch_size"])
    want = counts.agg_calls(cfg["model"], sizes, cfg["feature_dim"],
                            cfg["hidden"], **cfg.get("model_args", {}))
    assert sorted(seen) == sorted((k, shape) for k, shape, _ in want)


def test_gcn_agg_calls_count_needed_bytes_by_hand():
    # gcn, d_in 4, hidden 3.  Layer 1 over hop 2 (3 valid edges, 3
    # distinct sources, 3 distinct destinations): the degrees at dst and
    # at src, 12 + 12 + 12 each; each edge's two degrees gathered, 3 * (4
    # + 4) + 3 * 4 each; the gather 3 * (4 + 16) + 3 * 16 and the sum 48 +
    # 12 + 48.  Layer 2 over hop 1 (4 edges, 3 sources, 2 destinations):
    # the degrees 16 + 16 + 8 (dst) and 16 + 16 + 12 (src); their gathers
    # 4 * 8 + 3 * 4 (src) and 4 * 8 + 2 * 4 (dst); the gather 4 * (4 +
    # 12) + 3 * 12, the sum 48 + 16 + 2 * 12; its backward gathers at the
    # 2 destinations, 64 + 24, and sums into the 3 sources, 48 + 16 + 36.
    s = counts.batch_sizes(BLOCKS, MASK, 2)
    calls = counts.agg_calls("gcn", s, 4, 3)
    assert [b for _, _, b in calls] == [36, 36, 36, 36, 108, 108,
                                        40, 44, 44, 40, 100, 88, 88, 100]
    assert [k for k, _, _ in calls] == ["k3", "k3", "k2", "k2", "k2", "k3",
                                        "k3", "k3", "k2", "k2", "k2", "k3",
                                        "k2", "k3"]
    assert [shape for _, shape, _ in calls][:2] == [(4, 1, 8), (4, 1, 8)]

"""Each metric reader on a recorded record, and the trace's reduction on
recorded profiler events."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import counts, devtrace, harness
from portbench.test_portbench_counts import BLOCKS, MASK


class Ev:
    """A profiler event as ``kineto_results.events()`` gives it."""

    class _Dev:
        def __init__(self, name):
            self.name = name

    def __init__(self, name, dev, t0, t1, corr=0, tid=1):
        self._n, self._d, self._t0, self._t1 = name, self._Dev(dev), t0, t1
        self._c, self._tid = corr, tid

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._t0

    def end_ns(self):
        return self._t1

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._tid


EVENTS = [
    Ev(devtrace.WINDOW, "CPU", 1000, 11000),
    # thread 7 launches a fill, then K3; thread 8 a fill, then a GEMM
    Ev("cudaLaunchKernel", "CPU", 1100, 1110, corr=1, tid=7),
    Ev("cudaLaunchKernel", "CPU", 1200, 1210, corr=2, tid=7),
    Ev("cudaLaunchKernel", "CPU", 1150, 1160, corr=3, tid=8),
    Ev("cudaLaunchKernel", "CPU", 1300, 1310, corr=4, tid=8),
    Ev("cudaLaunchKernel", "CPU", 1400, 1410, corr=5, tid=8),
    Ev("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::FillFunctor<float>>(int)", "CUDA", 2000, 3000, corr=1),
    Ev("void (anonymous namespace)::segment_rows_kernel<float, 4, 2, int>"
       "(float const*)", "CUDA", 3000, 4000, corr=2),
    Ev("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::FillFunctor<float>>(int)", "CUDA", 5000, 5500, corr=3),
    Ev("sgemm_kernel(float const*)", "CUDA", 5500, 6000, corr=4),
    Ev("void (anonymous namespace)::dedup_kernel<int>(int const*)", "CUDA",
       9000, 9500, corr=5),
    Ev("Event Sync", "CUDA", 6000, 9000),
    Ev("kernel before the window", "CUDA", 100, 900),
]
SPANS = [("pipe.io_complete", 3500, 9500), ("pipe.sample", 6500, 7000)]


def test_reduce_events():
    d = devtrace.reduce_events(EVENTS, SPANS)
    assert d["window_s"] == pytest.approx(10000e-9)
    # busy: 2000-4000, 5000-6000, 9000-9500
    assert d["busy_s"] == pytest.approx(3500e-9)
    assert d["by_class"]["k3_fill"] == {"s": pytest.approx(1e-6),
                                        "launches": 1}
    assert d["by_class"]["agg"] == {"s": pytest.approx(1e-6), "launches": 1}
    assert d["by_class"]["k1"] == {"s": pytest.approx(0.5e-6),
                                   "launches": 1}
    # idle: 6000-9000 (io_complete and sample open at 7500), 9500-11000,
    # 1000-2000 (nothing open), 4000-5000 (io_complete)
    assert d["gaps"] == [["io_complete", pytest.approx(3000e-9)],
                         ["none", pytest.approx(1500e-9)],
                         ["none", pytest.approx(1000e-9)],
                         ["io_complete", pytest.approx(1000e-9)]]
    names = [n for n, _ in d["top_ops"]]
    assert names[0].startswith("at::native::vectorized_elementwise_kernel")
    assert "segment_rows_kernel<float, 4, 2, int>" in names
    assert "Event Sync" not in names
    assert devtrace.reduce_events(EVENTS[1:], SPANS) == {}


def test_device_busy_of_a_device_only_window():
    # a profiler that traced the device alone: every work record counts,
    # waits and host records do not (busy: 100-900, 2000-4000, 5000-6000,
    # 9000-9500)
    busy, n = devtrace.device_busy(EVENTS)
    assert busy == pytest.approx(4300e-9)
    assert n == 6
    assert devtrace.device_busy(EVENTS[:6]) == (0.0, 0)


def _record():
    sizes = counts.batch_sizes(BLOCKS, MASK, 2)
    calls = counts.agg_calls("sage", sizes, 4, 3)
    return {
        "model": "sage", "feature_dim": 4, "hidden": 3, "n_classes": 2,
        "row_bytes": 16, "n_batches": 4, "batch_size": 2, "window_s": 2.0,
        "spans": {"pipe.sample": [0.01, 0.03], "pipe.io_complete": [0.2],
                  "pipe.train": [0.1, 0.3]},
        "cache": {"device_hits": 30, "host_hits": 10, "storage_misses": 60,
                  "remote_hits": 0},
        "io": {"requests": 240},
        "lookups": [(10, 3, 2), (10, 9, 0)],
        "batches": [sizes, sizes],
        "device": {"window_s": 2.0, "busy_s": 0.5, "n_device_events": 9,
                   "by_class": {"k1": {"s": 1e-6, "launches": 6},
                                "agg": {"s": 2e-6,
                                        "launches": 2 * len(calls)},
                                "k3_fill": {"s": 1e-6, "launches": 4}}},
    }


def test_readers_on_a_record():
    rec = _record()
    read = {m: harness.load_reader(m) for m in (
        "sampler.sample_ms", "io.complete_ms", "io.storage_rows",
        "cache.hit_rate", "cache.k1_roofline", "step.train_ms", "step.mfu",
        "kernels.agg_roofline", "device.idle_share",
        "trainer.seeds_per_s")}
    assert read["trainer.seeds_per_s"](rec) == pytest.approx(4.0)
    assert read["sampler.sample_ms"](rec) == pytest.approx(20.0)
    assert read["io.complete_ms"](rec) == pytest.approx(200.0)
    assert read["step.train_ms"](rec) == pytest.approx(200.0)
    assert read["io.storage_rows"](rec) == pytest.approx(60.0)
    assert read["cache.hit_rate"](rec) == pytest.approx(40.0)
    k1 = (counts.k1_bound_s(10, 3, 2, 16) + counts.k1_bound_s(10, 9, 0, 16))
    assert read["cache.k1_roofline"](rec) == pytest.approx(100 * k1 / 1e-6)
    ops = 2 * counts.model_flops("sage", rec["batches"][0], 4, 3, 2)
    assert read["step.mfu"](rec) == pytest.approx(
        100 * ops / (2.0 * counts.F32_OPS_S))
    agg = 2 * sum(b for _, _, b in counts.agg_calls("sage",
                                                    rec["batches"][0], 4, 3))
    assert read["kernels.agg_roofline"](rec) == pytest.approx(
        100 * agg / counts.HBM_BYTES_S / 3e-6)
    assert read["device.idle_share"](rec) == pytest.approx(75.0)


def test_readers_find_nothing_to_read():
    rec = _record()
    rec.update(spans={}, lookups=[], batches=[], device={},
               cache=dict.fromkeys(rec["cache"], 0), n_batches=0)
    for m in ("sampler.sample_ms", "io.complete_ms", "io.storage_rows",
              "cache.hit_rate", "cache.k1_roofline", "step.train_ms",
              "step.mfu", "kernels.agg_roofline", "device.idle_share",
              "trainer.seeds_per_s"):
        assert harness.load_reader(m)(rec) is None, m


def test_agg_roofline_is_silent_when_launches_differ():
    rec = _record()
    rec["device"]["by_class"]["agg"]["launches"] += 1
    assert harness.load_reader("kernels.agg_roofline")(rec) is None


def test_batch_sizes_of_a_padded_batch_count_padding_once():
    # hop 2's padded edge runs from 0 to 0: it counts no destination
    s = counts.batch_sizes(BLOCKS, MASK, 2)
    src, dst, em = BLOCKS[1]
    assert s["hops"][1]["src_valid_distinct"] == len(np.unique(src[em]))
    assert s["hops"][1]["dst_valid_distinct"] == len(np.unique(dst[em])) \
        == len(np.unique(dst)) - 1

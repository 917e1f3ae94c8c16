"""The plain reference against the port on the CPU at a tiny size: a sound
run comes out correct; the control (the reference in TF32, in the
program's place) fails the cell's limits; and a run with the timed path
broken underneath comes out not correct, once for each fault the cells
can have (one chip: no exchange between chips)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import calibrate, harness
from portbench.conftest import CELLS


def _gaps(limits) -> list:
    """The gaps against the reference that a cell's limits name."""
    return [k for k in limits if k.endswith("_gap")]


def _run(cell, seed=2**31 + 3):
    res = harness.run_cell(cell, seed, 0.2, False, "cpu", time.perf_counter())
    return harness.result_line(cell, res, False, {}), res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny_cell):
    line, checks = _run(tiny_cell(name))
    assert line["correct"], checks
    assert list(line)[-1] == "checks"
    for k in _gaps(checks):
        assert checks[k]["value"] < checks[k]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, tiny_cell):
    """The reference in TF32 put in the program's place reads above a
    limit on every seed, and the program below all of them."""
    cell = tiny_cell(name)
    lim = cell["limits"]
    assert _gaps(lim)
    for seed in (1, 2, 3):
        r = calibrate.readings(cell, seed, "cpu")
        assert all(r["program"][k] <= lim[k] for k in _gaps(lim)), r
        assert any(r["control"][k] > lim[k] for k in _gaps(lim)), r


def _unchanged_state(monkeypatch):
    from repro_torch.gnn import train
    real = train.adamw

    def adamw(lr):
        opt = real(lr)
        return opt._replace(update_=lambda g, state, params: (params, state))
    monkeypatch.setattr(train, "adamw", adamw)


def _half_batch(monkeypatch):
    from repro_torch.gnn import models
    real = models.gnn_loss

    def gnn_loss(params, feats, blocks, labels, batch_size, model):
        half = batch_size // 2
        return real(params, feats, blocks, labels[:half], half, model)
    monkeypatch.setattr(models, "gnn_loss", gnn_loss)


def _row_altered(monkeypatch):
    from repro_torch.core.hetero_cache import HeteroCache
    real = HeteroCache.complete_planned

    def complete_planned(self, pg):
        out = real(self, pg)
        out[len(pg.ids) // 2] += 1.0
        return out
    monkeypatch.setattr(HeteroCache, "complete_planned", complete_planned)


def _edge_altered(monkeypatch):
    from repro_torch.gnn.sampling import NeighborSampler
    real = NeighborSampler._sample_neighbors

    def sample_neighbors(self, vertices, fanout):
        nbr = real(self, vertices, fanout)
        nbr[0, 0] = (nbr[0, 0] + 1) % self.g.n_vertices
        return nbr
    monkeypatch.setattr(NeighborSampler, "_sample_neighbors",
                        sample_neighbors)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "row_altered": _row_altered, "edge_altered": _edge_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, tiny_cell,
                                          monkeypatch):
    FAULTS[fault](monkeypatch)
    line, checks = _run(tiny_cell(name))
    assert not line["correct"], checks


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference import _round_tf32
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0000001],
                     requires_grad=True)
    r = _round_tf32(x)
    assert r[1].item() == 1.0 + 2.0 ** -10
    assert np.isclose(r[2].item(), -3.0)
    r.sum().backward()
    assert torch.equal(x.grad, torch.ones(3))

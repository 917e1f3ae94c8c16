"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's: ``param_count``, ``model_flops_for`` and
``memory_floor_bytes`` bit for bit for every config x shape, and the
``Roofline`` terms over the H100's rates from an ``op_cost`` count."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_cost import Cost  # noqa: E402


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list_configs())
def test_analytic_terms_match_reference(name, shape):
    cfg, rcfg = get_config(name), ref_config(name)
    sp, rsp = SHAPES[shape], REF_SHAPES[shape]
    assert roofline.param_count(cfg) == ref_roofline.param_count(rcfg)
    assert roofline.model_flops_for(cfg, sp) == \
        ref_roofline.model_flops_for(rcfg, rsp)
    assert roofline.memory_floor_bytes(cfg, sp) == \
        ref_roofline.memory_floor_bytes(rcfg, rsp)
    red, rred = cfg.reduced(), rcfg.reduced()
    assert roofline.param_count(red) == ref_roofline.param_count(rred)
    assert roofline.memory_floor_bytes(red, sp) == \
        ref_roofline.memory_floor_bytes(rred, rsp)


def test_h100_rates():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert roofline.HBM_BYTES == 80e9


def test_roofline_terms_from_a_count():
    cost = Cost(flops=989e12, hbm_bytes=3.35e12 / 2, peak_bytes=40e9,
                coll_bytes={"all-reduce": 450e9 / 4},
                coll_count={"all-reduce": 3})
    rf = roofline.analyze("x/train_4k/2x2", cost, 4, model_flops=2 * 989e12)
    # per-rank counts times the ranks over the ranks' rates
    assert rf.t_compute == pytest.approx(1.0)
    assert rf.t_memory == pytest.approx(0.5)
    assert rf.t_collective == pytest.approx(0.25)
    assert rf.bottleneck == "compute"
    assert rf.t_step == pytest.approx(1.0)
    assert rf.useful_flops_frac == pytest.approx(0.5)
    row = rf.row()
    assert row["bottleneck"] == "compute"
    assert row["peak_mem_gb_per_chip"] == pytest.approx(40.0)
    assert row["coll_gbytes"] == pytest.approx(4 * 450 / 4)
    assert rf.coll.count_by_kind == {"all-reduce": 3}

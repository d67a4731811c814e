"""The roofline terms (`repro_torch.launch.roofline`) at an H100 SXM's
rates: `model_flops` equal to the JAX package's for every arch x shape (at
the full-width parameter count, equal in both packages), and the two
roofline cases of tests/test_launch.py redone at the H100's constants."""
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import roofline as jroofline
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import roofline as rl
from repro_torch.launch.step_analysis import StepSummary
from repro_torch.models import model


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_jax(arch):
    n = rl.count_params(model.init_params(get_config(arch), 0, "meta"))
    for name, shape in SHAPES.items():
        want = jroofline.model_flops(jget_config(arch), JSHAPES[name], n)
        assert rl.model_flops(get_config(arch), shape, n) == want, name


def test_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW, rl.NET_BW, rl.NODE_SIZE) == (
        989e12, 3.35e12, 450e9, 50e9, 8)


def _summary(**kw):
    base = dict(flops=0.0, hbm_bytes=0.0, hbm_bytes_upper=0.0, ici_bytes=0.0, dcn_bytes=0.0,
                coll_by_kind={}, n_while=0)
    return StepSummary(**{**base, **kw})


def test_roofline_terms_bottleneck():
    t = rl.compute_terms_from_summary(_summary(flops=989e12), model_flops_per_chip=100e12)
    assert t.bottleneck == "compute"
    assert t.t_compute == pytest.approx(1.0)
    assert t.useful_ratio == pytest.approx(100 / 989, rel=1e-3)

    t2 = rl.compute_terms_from_summary(_summary(hbm_bytes=3.35e12, ici_bytes=450e9), 0)
    assert t2.t_memory == pytest.approx(1.0)
    assert t2.t_collective == pytest.approx(1.0)
    t3 = rl.compute_terms_from_summary(_summary(hbm_bytes=1e9, dcn_bytes=50e9), 0)
    assert t3.t_collective == pytest.approx(1.0) and t3.bottleneck == "collective"
    t4 = rl.compute_terms({"flops": 989e12, "bytes accessed": 6.7e12},
                          rl.CollectiveStats(ops=[], ici_bytes=0.0, dcn_bytes=0.0), 1.0)
    assert t4.t_memory == pytest.approx(2.0) and t4.bottleneck == "memory"


def test_model_flops_moe_uses_active_params():
    cfg = get_config("olmoe-1b-7b")
    shape = SHAPES["train_4k"]
    n_total = 7_000_000_000
    mf = rl.model_flops(cfg, shape, n_total)
    assert mf < 6.0 * n_total * shape.global_batch * shape.seq_len


def test_count_params_of_a_module_and_a_dict():
    m = model.init_params(get_config("xlstm-125m"), 0, "meta")
    named = dict(m.named_parameters())
    assert rl.count_params(m) == rl.count_params(named) == sum(p.numel() for p in named.values())

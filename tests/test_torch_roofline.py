"""The port's roofline model against the JAX package's, on the CPU.

``count_params``, ``active_params`` and ``model_flops`` are the
reference's arithmetic: equal, as integers and floats, for all ten
registry archs (published and smoke configs) and every ``SHAPES`` entry.
``Roofline``'s terms follow from the H100 constants; it shares no
constant with the reference's TPU v5e model.
"""

import pytest

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import ARCH_IDS, get_config as ref_config
from repro.roofline import model as ref_model
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer
from repro_torch.roofline import model


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_reference(arch, smoke):
    rcfg, cfg = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert model.count_params(cfg) == ref_model.count_params(rcfg)
    assert model.active_params(cfg) == ref_model.active_params(rcfg)
    assert model.active_params(cfg) <= model.count_params(cfg)
    for name, shape in SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            assert model.model_flops(cfg, shape, kind) == \
                ref_model.model_flops(rcfg, REF_SHAPES[name], kind)


def test_yi6b_count_is_the_lm_without_its_norms():
    """yi-6b's published geometry: the reference's count is the port's LM
    parameter count less the norm scales (two a layer and the final one),
    which it leaves out (the vocabulary needs no padding here)."""
    cfg = get_config("yi_6b")
    n = model.count_params(cfg)
    lm = transformer.LM(cfg, device="meta")
    norms = sum(p.numel() for name, p in lm.named_parameters()
                if "norm" in name)
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == model.active_params(cfg) == \
        sum(p.numel() for p in lm.parameters()) - norms == 5_798_625_280
    assert model.model_flops(cfg, SHAPES["train_4k"], "train") == \
        6.0 * n * 256 * 4096


def test_roofline_terms_follow_the_h100_constants():
    r = model.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                       coll_bytes_nvlink=450e9 / 4, coll_bytes_net=50e9 / 8,
                       model_flops_global=2 * 989e12 * 0.5, n_chips=2)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.25 + 0.125)
    assert r.bottleneck == "compute" and r.t_bound == pytest.approx(1.0)
    assert r.useful_flop_ratio == pytest.approx(0.5)
    assert r.mfu_bound == pytest.approx(0.5)
    d = r.to_dict()
    assert d["bottleneck"] == "compute" and d["n_chips"] == 2
    assert d["t_bound_s"] == pytest.approx(1.0)
    mem = model.Roofline(1.0, 3.35e12, 0.0, 0.0, 1.0, 1)
    assert mem.bottleneck == "memory" and mem.t_bound == pytest.approx(1.0)
    assert model.Roofline(0.0, 0.0, 0.0, 0.0, 0.0, 1).mfu_bound == 0.0
    assert model.bound_ms(3.35e9, 1.979e12, model.PEAK_OPS_INT8) == \
        pytest.approx((1.0, 1.0))
    assert model.bound_ms(0.0, 67e9, model.PEAK_FLOPS_FP32) == \
        pytest.approx((0.0, 1.0))
    assert model.PEAK_FLOPS_BF16 != ref_model.PEAK_FLOPS_BF16
    assert model.HBM_BW != ref_model.HBM_BW

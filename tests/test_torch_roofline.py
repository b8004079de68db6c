"""The port's roofline and parameter accounting against the reference's.

``param_counts`` equals the reference's for every arch in ``ARCH_IDS``, full
and reduced; ``model_flops`` equals the reference's for every arch and kind;
the roofline's terms and bottleneck follow the reference's test on the same
numbers, and ``HW.h100_sxm()`` holds NVIDIA's published H100 SXM5 figures.
"""

import numpy as np
import pytest

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch.accounting import param_counts
from repro_torch.launch.roofline import HW, Roofline, model_flops


@pytest.fixture(scope="module")
def ref():
    """The reference's config registry (imports JAX) and accounting."""
    pytest.importorskip("jax")
    from repro.configs import base, registry
    from repro.launch import accounting, roofline

    return registry, accounting, roofline, base


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_param_counts_equal_the_reference(ref, arch, reduced):
    registry, accounting, _, _ = ref
    cfg, ref_cfg = get_arch(arch), registry.get_arch(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    got = param_counts(cfg)
    assert got == accounting.param_counts(ref_cfg)
    assert got["active"] <= got["total"] and got["embedding"] > 0


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_model_flops_equal_the_reference(ref, arch):
    registry, accounting, roofline, base = ref
    n = param_counts(get_arch(arch))["active"]
    assert set(SHAPES) == set(base.SHAPES)
    for name, shape in SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            assert model_flops(get_arch(arch), shape, n, kind) == roofline.model_flops(
                registry.get_arch(arch), base.SHAPES[name], n, kind)


def test_roofline_terms_and_bottleneck():
    hw = HW(peak_flops=100.0, hbm_bw=10.0, link_bw=1.0)
    rl = Roofline(arch="x", shape="y", mesh="m", chips=4, hlo_flops=200.0, hlo_bytes=50.0,
                  coll_bytes=2.0, model_flops=400.0, hw=hw)
    assert rl.t_compute == 2.0
    assert rl.t_memory == 5.0
    assert rl.t_collective == 2.0
    assert rl.bottleneck == "memory" and rl.t_bound == 5.0
    np.testing.assert_allclose(rl.useful_fraction, 400.0 / 800.0)
    np.testing.assert_allclose(rl.mfu_bound, 400.0 / (4 * 100.0 * 5.0))
    # the compute term reads the peak of the operands' type
    rl32 = Roofline(arch="x", shape="y", mesh="m", chips=1, hlo_flops=66.9e12, hlo_bytes=0.0,
                    coll_bytes=0.0, dtype="f32")
    assert rl32.t_compute == pytest.approx(1.0) and rl32.bottleneck == "compute"


def test_h100_sxm_published_figures():
    hw = HW.h100_sxm()
    assert (hw.peak("bf16"), hw.peak("tf32"), hw.peak("f32")) == (989.4e12, 494.7e12, 66.9e12)
    assert hw.hbm_bw == 3.35e12 and hw.link_bw == 450e9
    # granite-3-2b's training step at batch 8 x 128 on one card: 6 N D FLOPs
    n = param_counts(get_arch("granite-3-2b"))["active"]
    rl = Roofline(arch="granite-3-2b", shape="8x128", mesh="1", chips=1,
                  hlo_flops=model_flops(None, ShapeConfig("t", 128, 8, "train"), n, "train"),
                  hlo_bytes=0.0, coll_bytes=0.0, model_flops=6.0 * n * 1024)
    assert rl.bottleneck == "compute" and rl.mfu_bound == pytest.approx(1.0)

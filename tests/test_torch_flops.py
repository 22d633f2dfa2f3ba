"""FLOP accounting (popcorn_tpu_torch/utils/flops.py) against the JAX
package's (popcorn_tpu/utils/flops.py, tests/test_flops.py): the analytic
counts equal the JAX module's, scale and follow the 3x train convention;
the peak table reads NVIDIA cards by name; and the analytic member count
agrees with the FLOPs PyTorch's counter sees on the plain path within
tests/test_flops.py's abs=0.2, for every layout value."""

import numpy as np
import pytest
import torch

from popcorn_tpu.utils import flops as JF
from popcorn_tpu_torch.config import ModelConfig
from popcorn_tpu_torch.data.normalize import NormStats
from popcorn_tpu_torch.nn.init import init_popcorn
from popcorn_tpu_torch.nn.popcorn import LAYOUTS
from popcorn_tpu_torch.utils import flops as F

torch.set_num_threads(1)


@pytest.mark.parametrize("s1,s2", [(True, True), (True, False), (False, True)])
def test_analytic_counts_equal_the_jax_module(s1, s2):
    kw = dict(s1=s1, s2=s2)
    assert F.features_flops_per_px(**kw) == JF.features_flops_per_px(**kw)
    assert F.builder_flops_per_px(**kw) == JF.builder_flops_per_px(**kw)
    assert F.member_flops_per_px(**kw) == JF.member_flops_per_px(**kw)
    assert F.head_flops_per_px() == JF.head_flops_per_px()
    for senb in (True, False):
        assert F.eval_patch_flops(2048, 1024, 5, sentinel_buildings=senb, **kw) == \
            JF.eval_patch_flops(2048, 1024, 5, sentinel_buildings=senb, **kw)
        assert F.train_step_flops(4096, 2048, 1, sentinel_buildings=senb, **kw) == \
            JF.train_step_flops(4096, 2048, 1, sentinel_buildings=senb, **kw)


def test_eval_patch_flops_scaling():
    one = F.eval_patch_flops(2048, 2048, 1)
    five = F.eval_patch_flops(2048, 2048, 5)
    # builder runs once; members add linearly
    member = F.member_flops_per_px() * 2048 * 2048
    assert five - one == pytest.approx(4 * member, rel=1e-12)
    # headline magnitude: ~0.85 TFLOP per 5-member 2048^2 patch
    assert 0.5e12 < five < 1.5e12


def test_train_step_flops_convention():
    # 3x fwd for the trainable path + 1x builder
    px = 2.0 * 1024 * 1024 * 2
    expected = (3 * F.member_flops_per_px() + F.builder_flops_per_px()) * px / 2
    assert F.train_step_flops(1024, 1024, 2) == pytest.approx(expected)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}),
    ("NVIDIA H100 PCIe", {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "int8": 1513e12}),
    ("NVIDIA A100-SXM4-80GB", {"bf16": None, "tf32": None, "fp32": None, "int8": None}),
])
def test_device_peak_table(monkeypatch, name, peaks):
    """Published dense peaks by the card's name: H100 SXM, H100 PCIe; an
    unknown card and the CPU give None."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    for dtype, want in peaks.items():
        got = F.device_peak_flops(torch.device("cuda", 0), dtype)
        assert got == (None if want is None else pytest.approx(want)), dtype
    assert F.device_peak_flops("cuda:0", "fp16") == (None if peaks["bf16"] is None
                                                     else pytest.approx(peaks["bf16"]))
    assert F.device_peak_flops("cpu") is None


def test_mfu_line():
    line = F.mfu_line(10.0, 1e12, 200e12)
    assert line["tflops"] == pytest.approx(10.0)
    assert line["mfu"] == pytest.approx(0.05)
    assert "mfu" not in F.mfu_line(10.0, 1e12, None)


@pytest.fixture(scope="module")
def probe_inputs():
    params, consts = init_popcorn(0, ModelConfig(pretrained=False))
    rng = np.random.default_rng(0)
    batch = {"S2": torch.from_numpy(rng.uniform(0, 4000, (1, 64, 64, 4)).astype(np.float32)),
             "S1": torch.from_numpy(rng.uniform(-25, 0, (1, 64, 64, 2)).astype(np.float32))}
    return params, consts, batch


@pytest.mark.parametrize("layout", LAYOUTS)
def test_analytic_matches_executed_plain(probe_inputs, layout):
    """tests/test_flops.py::test_analytic_matches_xla_plain: the member
    pass's counted FLOPs on the plain path (FlopCounterMode) against the
    analytic count, abs=0.2; every layout runs the one engine. The
    builder's prep runs on the input reflect-padded by 14 px, above the
    analytic count by (64 + 28)^2 / 64^2."""
    params, consts, batch = probe_inputs
    probe = F.eval_executed_probe(ModelConfig(pretrained=False, layout=layout), consts, NormStats(),
                                  params, batch)
    assert probe["engine"] == "plain"
    useful = F.member_flops_per_px() * 64 * 64
    assert probe["member"] / useful == pytest.approx(1.0, abs=0.2)
    assert probe["prep"] / (F.builder_flops_per_px() * 92 * 92) == pytest.approx(1.0, abs=0.2)


def test_executed_flops_of_no_torch_operator_is_none():
    assert F.executed_flops(lambda a: sum(range(a)), 100) is None
    a = torch.ones(8, 16)
    assert F.executed_flops(torch.matmul, a, torch.ones(16, 4)) == 2 * 8 * 16 * 4

"""The port's rotation-vs-host cost gate (popcorn_tpu_torch/data/
feed_select.py) and the trainer's feed chain on the CPU: the JAX
package's tests/test_feed_select.py cases. The pure decision function on
both sides of the crossover gives the same answers as the JAX package's
on the same inputs; the trainer lands on the full-resident feed when it
fits, and otherwise on the side the gate picks."""

import pytest
import torch

from popcorn_tpu.data.feed_select import FeedGateInputs as JFeedGateInputs
from popcorn_tpu.data.feed_select import gate_report as j_gate_report
from popcorn_tpu.data.feed_select import prefer_rotation as j_prefer_rotation
from popcorn_tpu_torch.data.feed_select import (
    FeedGateInputs,
    gate_report,
    measure_link_bytes_per_s,
    prefer_rotation,
)

torch.set_num_threads(1)


def _g(n_samples, cls=FeedGateInputs, **kw):
    # a 4608^2 region's four seasonal S2(u16)+S1(f32) slices at about
    # 420 MB each, a 27 MB/s link and a host feed of 4.76 samples/s
    kw.setdefault("swap_bytes", 1_680_000_000)
    kw.setdefault("link_bytes_per_s", 27e6)
    kw.setdefault("host_items_per_s", 4.76)
    return cls(n_samples=n_samples, **kw)


def test_host_wins_small_epochs():
    g = _g(124)
    assert g.host_epoch_s() == pytest.approx(124 / 4.76)
    assert g.rotation_epoch_s() > g.host_epoch_s()
    assert not prefer_rotation(g)


def test_rotation_wins_at_country_scale():
    assert prefer_rotation(_g(4000))


def test_crossover_is_where_the_math_says():
    """The flip happens where rotation_epoch_s == host_epoch_s:
    swap/link = n * (1/host - 1/dev)."""
    g0 = _g(1)
    per_sample_gain = 1 / g0.host_items_per_s - 1 / g0.dev_items_per_s
    n_star = g0.swap_bytes / g0.link_bytes_per_s / per_sample_gain
    assert not prefer_rotation(_g(int(n_star) - 2))
    assert prefer_rotation(_g(int(n_star) + 2))


def test_fast_link_prefers_rotation_even_small_epochs():
    assert prefer_rotation(_g(32, link_bytes_per_s=1e10))


@pytest.mark.parametrize("n", [1, 32, 124, 336, 337, 4000])
@pytest.mark.parametrize("link", [0.5e6, 27e6, 1e10])
def test_decision_and_report_match_jax(n, link):
    got, ref = _g(n, link_bytes_per_s=link), _g(n, JFeedGateInputs, link_bytes_per_s=link)
    assert prefer_rotation(got) == j_prefer_rotation(ref)
    assert gate_report(got) == j_gate_report(ref)
    assert "rotation" in gate_report(got) and "MB/s" in gate_report(got)


def test_link_probe_on_the_cpu_and_override(monkeypatch):
    assert measure_link_bytes_per_s("cpu", nbytes=1 << 16) > 0
    monkeypatch.setenv("POPCORN_FEED_GATE_LINK_MBPS", "12.5")
    assert measure_link_bytes_per_s("cpu") == 12.5e6


@pytest.fixture()
def gate_synth(tmp_path):
    from popcorn_tpu_torch.data.synthetic import make_synthetic_region

    return make_synthetic_region(str(tmp_path / "d"), "rwa", height=320, width=448, seed=7)


def _trainer(synth, tmp_path, **tkw):
    from popcorn_tpu_torch.config import ModelConfig, TrainConfig
    from popcorn_tpu_torch.train.trainer import Trainer

    tcfg = TrainConfig(target_regions=(), target_regions_train=("rwa",),
                       train_level=("coarse",), save_dir=str(tmp_path / "out"), **tkw)
    return Trainer(synth, ModelConfig(pretrained=False), tcfg, inference_patch=128,
                   inference_overlap=16, device="cpu")


def _starve_full_residency(monkeypatch):
    """A budget that admits one rotating slice (+ the swap transient) but
    not the full four-season stack, so the chain reaches the gate."""
    import popcorn_tpu_torch.data.device_weaksup as dw

    monkeypatch.setattr(dw, "_effective_budget", lambda b, device: 20e6)


def test_trainer_takes_the_resident_feed_when_it_fits(gate_synth, tmp_path):
    from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed

    tr = _trainer(gate_synth, tmp_path)
    assert isinstance(tr.feed, DeviceWeaksupFeed) and not tr.feed._rotating
    assert tr.feed_choice == "resident" and tr.gate_report is None


def test_trainer_gate_picks_host_on_slow_link(monkeypatch, gate_synth, tmp_path):
    from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed

    _starve_full_residency(monkeypatch)
    monkeypatch.setenv("POPCORN_FEED_GATE_LINK_MBPS", "0.5")
    monkeypatch.setenv("POPCORN_FEED_GATE_HOST_SPS", "4.76")
    tr = _trainer(gate_synth, tmp_path)
    assert not isinstance(tr.feed, DeviceWeaksupFeed)
    assert tr.feed_choice == "host" and "host" in tr.gate_report


def test_trainer_gate_lets_fast_link_rotate(monkeypatch, gate_synth, tmp_path):
    from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed

    _starve_full_residency(monkeypatch)
    monkeypatch.setenv("POPCORN_FEED_GATE_LINK_MBPS", "10000")
    monkeypatch.setenv("POPCORN_FEED_GATE_HOST_SPS", "4.76")
    tr = _trainer(gate_synth, tmp_path)
    assert isinstance(tr.feed, DeviceWeaksupFeed) and tr.feed._rotating
    assert tr.feed_choice == "rotating"


def test_trainer_gate_off_keeps_rotation(monkeypatch, gate_synth, tmp_path):
    """feed_gate='off': rotation whenever it fits, whatever the rates."""
    from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed

    _starve_full_residency(monkeypatch)
    monkeypatch.setenv("POPCORN_FEED_GATE_LINK_MBPS", "0.5")
    monkeypatch.setenv("POPCORN_FEED_GATE_HOST_SPS", "4.76")
    tr = _trainer(gate_synth, tmp_path, feed_gate="off")
    assert isinstance(tr.feed, DeviceWeaksupFeed) and tr.feed._rotating
    assert tr.gate_report is None


def test_trainer_feed_gate_host_and_device_feed_on(monkeypatch, gate_synth, tmp_path):
    """feed_gate='host' lands on the host feed once full residency fails;
    device_feed='on' raises instead of falling back."""
    from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed, Ineligible

    _starve_full_residency(monkeypatch)
    tr = _trainer(gate_synth, tmp_path, feed_gate="host")
    assert not isinstance(tr.feed, DeviceWeaksupFeed)
    with pytest.raises(Ineligible, match="budget"):
        _trainer(gate_synth, tmp_path, device_feed="on")

"""The port's stitch on the host and on the device, its host census route,
and the sliding window's wall-clock split, on the CPU at a small size.

Above a budget of device memory (popcorn_tpu/infer/sliding.py:537-538,
934-940) the JAX package stitches a region's patch maps on the host and
its Evaluator runs the census on host arrays (popcorn_tpu/infer/
evaluator.py:174-230); the port does the same. Host and device stitches
add the same patch maps in the same order: counts equal, maps within
rtol 1e-5 (tests/test_multichip.py::test_device_stitch_matches_host), and
census metrics within 1e-6."""

import numpy as np
import pytest
import torch

from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda, save_popcorn_checkpoint
from popcorn_tpu_torch.config import EvalConfig, ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.feed import InferenceFeed
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.infer import sliding
from popcorn_tpu_torch.infer.evaluator import Evaluator
from popcorn_tpu_torch.infer.sliding import run_sliding_inference, stitch_on_host

torch.set_num_threads(1)
PATCH, OVERLAP = 96, 16
MCFG = ModelConfig(biasinit=0.9407)


def _dataset(paths):
    return PopulationDataset(paths, "rwa", mode="test", patchsize=PATCH, overlap=OVERLAP,
                             fourseasons=False, train_level="coarse")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    paths = make_synthetic_region(str(tmp_path_factory.mktemp("stitch_data")), "rwa",
                                  height=160, width=224, seed=9)
    # two members: visit counts of 2, so finalize divides and takes a std
    members, cks = [], []
    mdir = tmp_path_factory.mktemp("stitch_members")
    for i in range(2):
        params, consts = load_popcorn_from_dda(MCFG, head_seed=4 + i)
        members.append(params)
        cks.append(str(mdir / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    return paths, members, consts, tuple(cks)


def _run(setup, **kw):
    paths, members, consts, _ = setup
    return run_sliding_inference(members, consts, MCFG, _dataset(paths), batch_size=3,
                                 device="cpu", **kw)


@pytest.fixture(scope="module")
def stitched(setup):
    return {mode: _run(setup, device_stitch=mode, return_device=True) for mode in ("host", "device")}


def test_device_stitch_matches_host(stitched):
    host, dev = stitched["host"], stitched["device"]
    # a host stitch returns numpy maps and an int32 count, as the JAX package's
    assert all(isinstance(v, np.ndarray) for v in host.values())
    assert host["count"].dtype == np.int32
    assert all(isinstance(v, torch.Tensor) for v in dev.values())
    dev = {k: v.numpy() for k, v in dev.items()}
    np.testing.assert_array_equal(dev["count"], host["count"])
    for k in ("map", "scale"):
        np.testing.assert_allclose(dev[k], host[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("map_std", "scale_std"):
        np.testing.assert_allclose(dev[k], host[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert host["map"].max() > 0 and host["count"].max() == 2 and host["map_std"].max() > 0


@pytest.mark.parametrize("over", [True, False], ids=["above_budget", "under_budget"])
def test_auto_stitches_on_the_host_above_the_budget(monkeypatch, over):
    h, w = 160, 224
    need = h * w * 4 * 5  # five float32 maps
    monkeypatch.setattr(sliding, "_DEVICE_STITCH_BUDGET_BYTES", need if over else need + 1)
    assert stitch_on_host("auto", (h, w)) is over
    assert stitch_on_host("host", (h, w)) and not stitch_on_host("device", (h, w))
    with pytest.raises(ValueError, match="device_stitch"):
        stitch_on_host("cpu", (h, w))


def test_auto_run_above_the_budget_equals_the_host_stitch(setup, stitched, monkeypatch):
    monkeypatch.setattr(sliding, "_DEVICE_STITCH_BUDGET_BYTES", 0)
    got = _run(setup, return_device=True)
    assert isinstance(got["map"], np.ndarray)
    for k, v in stitched["host"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["host", "device"])
def test_timings_split_the_wall(setup, mode):
    """A host stitch takes the host feed (no upload time); a device stitch
    takes the device-resident feed by default, with its stage spans and
    its first patch booked apart as warmup_s."""
    paths = setup[0]
    timings = {}
    _run(setup, device_stitch=mode, timings=timings)
    keys = {"feed_wait_s", "upload_s", "dispatch_s", "finalize_s", "total_s", "n_patches"}
    dev_keys = {"read_span_s", "upload_span_s", "warmup_s", "n_device_patches"}
    assert set(timings) == (keys | dev_keys if mode == "device" else keys)
    assert all(v >= 0 for v in timings.values()), timings
    parts = timings["feed_wait_s"] + timings["dispatch_s"] + timings["finalize_s"]
    if mode == "host":
        assert timings["upload_s"] == 0.0  # no device-resident feed
    else:
        assert timings["upload_s"] > 0.0 and timings["n_device_patches"] == timings["n_patches"]
        parts += timings["upload_s"] + timings["warmup_s"]
    assert parts <= timings["total_s"] + 1e-6, timings
    n_valid = sum(int(np.sum(b["valid"])) for b in InferenceFeed(_dataset(paths), batch_size=3))
    assert timings["n_patches"] == n_valid > 1


def _evaluate(setup, tmp_path, full=False):
    paths, _, _, cks = setup
    ev = Evaluator(paths, MCFG, EvalConfig(checkpoints=cks), device="cpu")
    ev.experiment_folder = str(tmp_path)
    ev.datasets = [_dataset(paths)]
    return ev.test_target(save=True, full=full)


def test_evaluator_host_census_route_matches_device_route(setup, tmp_path, monkeypatch):
    dev = _evaluate(setup, tmp_path / "device")
    monkeypatch.setattr(sliding, "_DEVICE_STITCH_BUDGET_BYTES", 0)
    host = _evaluate(setup, tmp_path / "host", full=True)
    assert host.keys() == dev.keys()
    assert any("MainCensus" in k for k in host) and any("AdjCensus" in k for k in host)
    for k in dev:
        assert abs(host[k] - dev[k]) <= 1e-6, (k, host[k], dev[k])
    for tag in ("", "STD", "SCALE_rwa", "SCALE_STD", "ADJ_rwa"):
        assert (tmp_path / "host" / f"rwa_predictions{tag}.tif").exists(), tag


def test_debug_nans_names_the_first_patch(setup):
    paths, (params, _), consts, _ = setup
    bad = {**params, "head": {**params["head"], "l4": {**params["head"]["l4"]}}}
    bad["head"]["l4"]["b"] = torch.full_like(params["head"]["l4"]["b"], float("nan"))
    with pytest.raises(FloatingPointError, match=r"patch 0 \(img_coords"):
        run_sliding_inference([bad], consts, MCFG, _dataset(paths), device="cpu", debug_nans=True)
    # without the flag the NaNs reach the maps
    out = run_sliding_inference([bad], consts, MCFG, _dataset(paths), device="cpu")
    assert np.isnan(out["map"]).any()

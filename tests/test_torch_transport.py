"""--transport bf16 in the port on the CPU: the float image modalities ride
bfloat16 on the data plane (popcorn_tpu_torch/data/feed.py::
transport_cast), cast without ml_dtypes. The cast is held bit-equal to the
JAX package's (NaN, +-inf, ties and subnormals included, compared as
uint16 patterns); the host feeds' bf16 batches equal the JAX package's;
the port's host and device feeds agree under bf16 as under exact; the
resident S1 takes half the bytes; and the bf16 eval's maps agree between
the port's two feeds, lie within tests/test_torch_eval.py's MAP_TOL of the
JAX package's bf16-transport eval, and keep census r2 within
TRANSPORT_R2_BOUND of the exact run (tests/test_transport.py:147)."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda as j_load_dda
from popcorn_tpu.compat.torch_convert import save_popcorn_checkpoint
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.feed import InferenceFeed as JInferenceFeed
from popcorn_tpu.data.feed import WeaksupFeed as JWeaksupFeed
from popcorn_tpu.data.feed import transport_cast as j_transport_cast
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.infer.evaluator import load_member as j_load_member
from popcorn_tpu.infer.sliding import run_sliding_inference as j_run
from popcorn_tpu_torch.config import EvalConfig, ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed
from popcorn_tpu_torch.data.feed import (
    TRANSPORT_KEYS,
    InferenceFeed,
    WeaksupFeed,
    bf16_bits,
    transport_cast,
)
from popcorn_tpu_torch.infer.evaluator import Evaluator, load_member
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from torch_feed_helpers import assert_batches_equal, assert_extent_holds_the_samples

torch.set_num_threads(1)
TRANSPORT_R2_BOUND = 0.02
MAP_TOL = dict(rtol=2e-4, atol=2e-5)


def bits(a):
    """uint16 patterns of a bf16 value: the port's CPU torch.bfloat16
    tensor or the JAX package's ml_dtypes array."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.view(torch.int16).numpy().view(np.uint16)
    assert a.dtype == ml_dtypes.bfloat16
    return a.view(np.uint16)


def same(got, ref, key=""):
    """A port batch value against the JAX package's, bit for bit."""
    if isinstance(got, torch.Tensor) or np.asarray(ref).dtype == ml_dtypes.bfloat16:
        np.testing.assert_array_equal(bits(got), bits(ref), err_msg=key)
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype, (key, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=key)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return j_make(str(tmp_path_factory.mktemp("transport_data")), "rwa", height=320,
                  width=448, seed=7, with_viirs=True, with_buildings=True)


def _weak(cls, synth):
    return cls(synth, "rwa", mode="weaksup", train_level="coarse", patchsize=None,
               overlap=None, fourseasons=True)


def test_cast_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    special = np.array(
        [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 3.4e38, -3.4e38, 1e-40, -1e-42],
        np.float32)
    patterns = np.array(
        [0x7F800001, 0xFF800001, 0x7FC00001, 0x7FBFFFFF, 0xFFFFFFFF,  # NaN payloads
         0x3F808000, 0x3F818000, 0xBF808000, 0x7F7F8000, 0x00008000,  # ties to even
         0x3F807FFF, 0x3F808001, 0x7F7FFFFF], np.uint32).view(np.float32)
    randoms = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    a = np.concatenate([special, patterns, randoms, rng.normal(0, 30, 1000).astype(np.float32)])
    np.testing.assert_array_equal(bf16_bits(a), a.astype(ml_dtypes.bfloat16).view(np.uint16))
    batch = {"S1": a.reshape(1, -1, 1), "VIIRS": a[:10].reshape(1, 10, 1)}
    got = transport_cast(dict(batch), "bf16")
    ref = j_transport_cast(dict(batch), "bf16")
    for k in batch:
        same(got[k], ref[k], k)


def test_transport_cast_rule():
    batch = {
        "S2": np.arange(6, dtype=np.uint16).reshape(1, 2, 3),
        "S1": np.linspace(-30.0, 5.0, 6, dtype=np.float32).reshape(1, 2, 3),
        "VIIRS": np.ones((1, 2, 3), np.float32),
        "building_counts": np.ones((1, 2, 3), np.float32),
        "admin_mask": np.zeros((1, 2, 3), np.float32),
    }
    out = transport_cast(dict(batch), "bf16")
    assert out["S2"].dtype == np.uint16  # lossless u16 beats bf16: kept
    assert out["S1"].dtype == torch.bfloat16 and out["VIIRS"].dtype == torch.bfloat16
    # masks/counts/targets always ride exact
    assert out["building_counts"].dtype == np.float32 and out["admin_mask"].dtype == np.float32
    assert transport_cast(dict(batch), "exact")["S1"].dtype == np.float32
    with pytest.raises(ValueError):
        transport_cast(dict(batch), "fp8")
    with pytest.raises(ValueError):
        WeaksupFeed([], transport="fp8")


@pytest.mark.parametrize("augment", [False, True])
def test_host_feed_bf16_batches_match_jax(synth, augment):
    kw = dict(batch_size=2, seed=1600, prefetch=0, augment=augment, transport="bf16")
    ref = list(JWeaksupFeed([_weak(JDataset, synth)], **kw).epoch(0))
    got = list(WeaksupFeed([_weak(PopulationDataset, synth)], **kw).epoch(0))
    assert len(got) == len(ref) > 0
    assert any(isinstance(b["S1"], torch.Tensor) for b in got)
    for bg, br in zip(got, ref):
        # the port's batch also carries each sample's extent in the bucket
        assert set(bg) == set(br) | {"extent"}
        assert_extent_holds_the_samples(bg)
        for k in br:
            same(bg[k], br[k], k)


def test_inference_feed_bf16_matches_jax(synth):
    kw = dict(mode="test", patchsize=96, overlap=16, fourseasons=False)
    ref = next(iter(JInferenceFeed(JDataset(synth, "rwa", **kw), batch_size=2, prefetch=0,
                                   transport="bf16")))
    got = next(iter(InferenceFeed(PopulationDataset(synth, "rwa", **kw), batch_size=2,
                                  prefetch=0, transport="bf16")))
    assert got["S1"].dtype == torch.bfloat16
    assert set(got) == set(ref)
    for k in ref:
        same(got[k], ref[k], k)


def test_device_feed_bf16_parity(synth):
    ds = _weak(PopulationDataset, synth)
    kw = dict(batch_size=2, seed=1600, prefetch=0, augment=True, transport="bf16")
    host = list(WeaksupFeed([ds], **kw).epoch(1))
    dev = list(DeviceWeaksupFeed([ds], device="cpu", **kw).epoch(1))
    assert dev[0]["S1"].dtype == torch.bfloat16
    assert_batches_equal(host, dev)
    for b in host:
        for k in TRANSPORT_KEYS:
            if k in b and not isinstance(b[k], np.ndarray):
                assert b[k].dtype == torch.bfloat16, k


def test_device_feed_bf16_residency_halved(synth):
    ds = _weak(PopulationDataset, synth)
    kw = dict(batch_size=2, seed=1600, prefetch=0, device="cpu")
    f32 = DeviceWeaksupFeed([ds], **kw)
    b16 = DeviceWeaksupFeed([ds], transport="bf16", **kw)
    assert f32._mos["S1"].dtype == torch.float32 and b16._mos["S1"].dtype == torch.bfloat16
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert 2 * nbytes(b16._mos["S1"]) == nbytes(f32._mos["S1"])
    # S2 rides lossless uint16 (its int16 view) under both transports
    assert b16._mos["S2"].dtype == f32._mos["S2"].dtype == torch.int16


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    mdir = tmp_path_factory.mktemp("transport_members")
    cks = []
    for i in range(2):
        params, consts = j_load_dda(JModelConfig(biasinit=0.9407),
                                    head_key=jax.random.PRNGKey(70 + i))
        cks.append(str(mdir / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    return cks


def _test_ds(cls, paths):
    return cls(paths, "rwa", mode="test", patchsize=96, overlap=16, fourseasons=False,
               train_level="coarse")


def test_bf16_eval_feeds_agree_and_match_jax(synth, members):
    jm = [j_load_member(p) for p in members]
    ref = j_run([m[0] for m in jm], jm[0][1], JModelConfig(), _test_ds(JDataset, synth),
                transport="bf16")
    pm = [load_member(p) for p in members]
    run = lambda feed: run_sliding_inference(  # noqa: E731
        [m[0] for m in pm], pm[0][1], ModelConfig(), _test_ds(PopulationDataset, synth),
        device="cpu", transport="bf16", device_feed=feed)
    dev, host = run("on"), run("off")
    for k in dev:
        np.testing.assert_array_equal(dev[k], host[k], err_msg=k)
    for k in ("map", "scale"):
        np.testing.assert_allclose(dev[k], np.asarray(ref[k]), err_msg=k, **MAP_TOL)
    np.testing.assert_array_equal(dev["count"], np.asarray(ref["count"]))


def test_bf16_transport_census_r2_within_bound(synth, members, tmp_path):
    out = {}
    for transport in ("exact", "bf16"):
        ev = Evaluator(synth, ModelConfig(),
                       EvalConfig(checkpoints=tuple(members), transport=transport), device="cpu")
        ev.experiment_folder = str(tmp_path / transport)
        ev.datasets = [_test_ds(PopulationDataset, synth)]
        out[transport] = ev.test_target(save=False)
    r2_keys = [k for k in out["exact"] if k.endswith("/r2")]
    assert any("AdjCensus" in k for k in r2_keys)
    for k in r2_keys:
        assert np.isfinite(out["bf16"][k]), k
        assert abs(out["bf16"][k] - out["exact"][k]) <= TRANSPORT_R2_BOUND, k

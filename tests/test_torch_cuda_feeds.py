"""The device-resident feeds on the card: what the CPU tests cannot see,
the side-stream uploads and the caching allocator's reuse of their memory.
A missed stream wait or a freed upload buffer shows as maps or batches that
differ from run to run on the card and never on the CPU, so each case runs
more than once.

- the eval's device feed (four seasons, so four uploads through the side
  stream and the season pipeline) against the host feed on the card: the
  stitched maps bit-equal, on every run;
- DeviceWeaksupFeed's batches against the host WeaksupFeed's after its
  upload, bit for bit: resident, bf16 transport, the NaN hybrid's spliced
  host items, and the rotating feed's samples (its prefetched slices
  uploaded on a worker's side stream);
- the cost gate's link probe on the card.

Needs a CUDA card and skips without one. The repo's conftest imports jax,
which the GPU machine lacks, so run it there as
    python -m pytest --noconftest tests/test_torch_cuda_feeds.py -q"""

import numpy as np
import pytest
import torch

from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda
from popcorn_tpu_torch.config import ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed
from popcorn_tpu_torch.data.feed import WeaksupFeed
from popcorn_tpu_torch.data.feed_select import measure_link_bytes_per_s
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff
from torch_feed_helpers import assert_batches_equal, uploaded


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    return make_synthetic_region(str(tmp_path_factory.mktemp("cuda_feeds")), "rwa",
                                 height=320, width=448, seed=7, with_ascending=True)


def test_eval_device_feed_is_bit_equal_to_host_feed_on_every_run(dev, region):
    mcfg = ModelConfig(biasinit=0.9407, compute_dtype="bfloat16")
    members = []
    for i in range(2):
        params, consts = load_popcorn_from_dda(mcfg, head_seed=40 + i)
        members.append(params)

    def run(feed):
        ds = PopulationDataset(region, "rwa", mode="test", patchsize=256, overlap=32,
                               fourseasons=True)
        t = {}
        out = run_sliding_inference(members, consts, mcfg, ds, device=dev, device_feed=feed,
                                    timings=t)
        return out, t

    host, _ = run("off")
    for _ in range(3):
        got, t = run("on")
        assert t["n_device_patches"] == t["n_patches"] > 4
        for k in host:
            np.testing.assert_array_equal(got[k], host[k], err_msg=k)


def _weak(paths, **kw):
    return PopulationDataset(paths, "rwa", mode="weaksup", train_level="coarse",
                             patchsize=None, overlap=None, fourseasons=True, **kw)


@pytest.mark.parametrize("transport", ["exact", "bf16"])
def test_training_feed_batches_on_the_card(dev, region, transport):
    ds = _weak(region)
    kw = dict(batch_size=2, seed=1600, prefetch=2, augment=True, transport=transport)
    host = WeaksupFeed([ds], **kw)
    feed = DeviceWeaksupFeed([ds], device=dev, **kw)
    assert feed._mos["S1"].is_cuda
    for epoch in (0, 1):
        got = list(feed.epoch(epoch))
        assert all(b["S1"].is_cuda for b in got)
        assert_batches_equal(list(host.epoch(epoch)), [uploaded_cpu(b) for b in got])


def uploaded_cpu(batch):
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in uploaded(batch).items()}


def test_nan_hybrid_splices_host_items_on_the_card(dev, region, tmp_path):
    import shutil

    root = str(tmp_path / "nan")
    shutil.copytree(region.root, root)
    from popcorn_tpu_torch.config import DataPaths

    paths = DataPaths(root)
    p = paths.modality_path("rwa", "S1", "winter", asc=False)
    with GeoTIFF(p) as g:
        arr, tr = g.read((1, 2)), g.transform
    arr[:, :24, :24] = np.nan
    write_geotiff(p, arr, transform=(tr[0], tr[1], tr[3], tr[5]), nodata=float("nan"))
    ds = _weak(paths)
    kw = dict(batch_size=2, seed=1606, prefetch=0)
    host = WeaksupFeed([ds], **kw)
    feed = DeviceWeaksupFeed([ds], device=dev, **kw)
    assert feed._nan_q
    for epoch in (0, 1, 2):
        assert_batches_equal(list(host.epoch(epoch)), [uploaded_cpu(b) for b in feed.epoch(epoch)])


def test_rotating_feed_samples_on_the_card(dev, region):
    ds = _weak(region)
    kw = dict(batch_size=2, seed=1600, prefetch=0, augment=False, drop_last=False)

    def samples(batches):
        out = {}
        for b in batches:
            b = uploaded_cpu(b)
            for i in range(len(b["census_idx"])):
                out[(float(b["census_idx"][i]), int(b["season"][i]))] = [
                    b[k][i] for k in ("S2", "S1", "admin_mask")]
        return out

    rot = DeviceWeaksupFeed([ds], rotate=True, device=dev, **kw)
    want = samples(WeaksupFeed([ds], **kw).epoch(0))
    for epoch in range(3):  # epochs 1 and 2 start on the prefetched slice
        got = samples(rot.epoch(0))
        assert got.keys() == want.keys()
        for k in want:
            for a, b in zip(want[k], got[k]):
                assert a.dtype == b.dtype and torch.equal(a, b), k
    assert rot._mos["S2"].is_cuda and rot._mos["S2"].shape[0] == 1


def test_link_probe_on_the_card(dev):
    assert measure_link_bytes_per_s(dev) > 1e8

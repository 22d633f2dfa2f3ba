"""The port's device-resident training feed (popcorn_tpu_torch/data/
device_weaksup.py) on the CPU: every batch of an epoch equals the port's
host WeaksupFeed batch after its upload, bit for bit and dtype for dtype
(the JAX package's tests/test_device_weaksup.py cases; its mesh cases
run on two ranks in tests/test_torch_dist.py, and the mesh form's rows
here); and the port's host
WeaksupFeed equals the JAX package's on the same region and seed, which
the device feed's parity rests on."""

import numpy as np
import pytest
import torch

from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.feed import WeaksupFeed as JWeaksupFeed
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu_torch.config import SEASONS
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed, Ineligible
from popcorn_tpu_torch.data.feed import WeaksupFeed
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff
from torch_feed_helpers import assert_batches_equal, assert_extent_holds_the_samples, uploaded

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_region(
        str(tmp_path_factory.mktemp("devweak_data")), "rwa", height=320, width=448,
        seed=7, with_viirs=True, with_buildings=True,
    )


def _ds(paths, region="rwa", **kw):
    kw.setdefault("fourseasons", True)
    return PopulationDataset(paths, region, mode="weaksup", train_level="coarse",
                             patchsize=None, overlap=None, **kw)


def _epochs(host, dev, epochs=(0,)):
    for e in epochs:
        assert_batches_equal(list(host.epoch(e)), list(dev.epoch(e)))


@pytest.mark.parametrize("augment", [False, True])
def test_device_feed_batch_parity(synth, augment):
    ds = _ds(synth)
    kw = dict(batch_size=2, seed=1600, prefetch=0, augment=augment)
    dev = DeviceWeaksupFeed([ds], device="cpu", **kw)
    _epochs(WeaksupFeed([ds], **kw), dev, (0, 1))
    b = next(iter(dev.epoch(0)))
    # image keys arrive as tensors on the feed's device, S2 widened to
    # int32 values as the upload widens the host feed's uint16
    for k in ("S2", "S1", "admin_mask"):
        assert isinstance(b[k], torch.Tensor), k
    assert b["S2"].dtype == torch.int32
    ds.close()


def _nan_region(root):
    """Localized NaNs in the winter S1 mosaic: only windows overlapping its
    top-left corner need healing, so batches mix device and host items."""
    paths = make_synthetic_region(root, "rwa", height=256, width=320, seed=9,
                                  with_ascending=True)
    p = paths.modality_path("rwa", "S1", "winter", asc=False)
    with GeoTIFF(p) as g:
        arr, tr = g.read((1, 2)), g.transform
    arr[:, :24, :24] = np.nan
    write_geotiff(p, arr, transform=(tr[0], tr[1], tr[3], tr[5]), nodata=float("nan"))
    return paths


def _asc_region(root):
    """Both S1 orbits, the ascending mosaics offset so that a wrong orbit
    selection cannot pass unnoticed."""
    paths = make_synthetic_region(root, "rwa", height=256, width=320, seed=17,
                                  with_ascending=True)
    for season in SEASONS:
        p = paths.modality_path("rwa", "S1", season, asc=True)
        with GeoTIFF(p) as g:
            arr, tr = g.read((1, 2)), g.transform
        write_geotiff(p, arr + 3.5, transform=(tr[0], tr[1], tr[3], tr[5]),
                      nodata=float("nan"))
    return paths


def _case(name, synth, root):
    """(datasets, feed kwargs, epochs) of one parity case."""
    if name == "viirs_buildings":
        # every modality resident, with the -binp/-sinp derived segmentation
        return ([_ds(synth, viirs=True, sentinelbuildings=False)],
                dict(seed=1601, building_input=True, segmentation_input=True), (0,))
    if name == "no_nir_one_season":
        return [_ds(synth, nir=False, fourseasons=False)], dict(seed=1602), (0,)
    if name == "max_samples":
        return [_ds(synth)], dict(seed=1600, max_samples=4), (0,)
    if name == "nan_hybrid":
        return [_ds(_nan_region(root))], dict(seed=1606), (0, 1, 2)
    if name == "asc_aug":
        return [_ds(_asc_region(root), asc_aug=True)], dict(seed=1605), (0, 1, 2)
    if name == "in_memory":
        # in_memory sources serve no raw uint16: the resident S2 takes the
        # float route, which must still land on the lossless-uint16 rule
        return [_ds(synth, in_memory=True)], dict(seed=1603), (0,)
    if name == "multi_region":
        # two regions of different shapes, concatenated row-wise
        uga = make_synthetic_region(root, "uga", height=256, width=320, seed=13)
        return [_ds(synth), _ds(uga, "uga")], dict(seed=1604), (0, 1)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["viirs_buildings", "no_nir_one_season", "max_samples",
                                  "nan_hybrid", "asc_aug", "in_memory", "multi_region"])
def test_device_feed_parity_cases(synth, tmp_path, name):
    dss, kw, epochs = _case(name, synth, str(tmp_path))
    kw = dict(batch_size=2, prefetch=0, **kw)
    host = WeaksupFeed(dss, **kw)
    dev = DeviceWeaksupFeed(dss, device="cpu", **kw)
    if name == "nan_hybrid":
        assert dev._nan_q  # the NaN query tables engaged
        kinds = {True: 0, False: 0}
        for e in epochs:
            for j in range(len(dev.index)):
                it = dev._fetch_item(j, e)
                if it is not None:
                    kinds["dx" in it] += 1
        assert kinds[True] > 0 and kinds[False] > 0  # both paths exercised
    if name == "viirs_buildings":
        hb = next(iter(host.epoch(0)))
        assert {"VIIRS", "building_counts", "building_segmentation"} <= set(hb)
    if name == "in_memory":
        assert next(iter(host.epoch(0)))["S2"].dtype == np.uint16
    _epochs(host, dev, epochs)
    for d in dss:
        d.close()


def test_mesh_form_waits_for_item_16(synth):
    """The mesh form (ROADMAP.md Queue 1 item 16, now ported): under a
    grid of two data ranks each rank's feed assembles its two rows of each
    4-sample global batch, equal to those rows of the host feed's batch
    (the feed runs no collective, so each rank's layout stands alone); a
    one-rank grid yields the whole batches."""
    from popcorn_tpu_torch.dist.mesh import Mesh

    ds = _ds(synth)
    kw = dict(batch_size=4, seed=1600, prefetch=0, augment=True)
    host = [uploaded(b) for b in WeaksupFeed([ds], **kw).epoch(0)]
    assert host
    for r in range(2):
        dev = list(DeviceWeaksupFeed([ds], mesh=Mesh(2, 1, r, "cpu"), device="cpu", **kw).epoch(0))
        assert len(dev) == len(host)
        rows = slice(2 * r, 2 * r + 2)
        for hb, db in zip(host, dev):
            assert list(db["rows"]) == [2 * r, 2 * r + 1] and set(db) - {"rows"} == set(hb)
            for k, v in db.items():
                if k in ("rows", "photometric"):
                    continue
                w = hb[k][rows]
                if isinstance(v, torch.Tensor):
                    assert v.dtype == w.dtype and torch.equal(v, w), k
                else:
                    np.testing.assert_array_equal(v, w, err_msg=k)
            np.testing.assert_array_equal(db["photometric"], hb["photometric"])
    _epochs(WeaksupFeed([ds], **kw), DeviceWeaksupFeed([ds], mesh=Mesh(1, 1, 0, "cpu"),
                                                       device="cpu", **kw))
    ds.close()


def test_ineligible_budget(synth):
    with pytest.raises(Ineligible, match="budget"):
        DeviceWeaksupFeed([_ds(synth)], batch_size=2, seed=1600, hbm_budget_bytes=1e3,
                          device="cpu")


def test_val_feed_shares_resident_stacks(synth):
    tr, va = _ds(synth, split="train"), _ds(synth, split="val")
    train_feed = DeviceWeaksupFeed([tr], batch_size=2, seed=1600, prefetch=0, device="cpu")
    kw = dict(batch_size=1, seed=1600, prefetch=0, augment=False, drop_last=False)
    # an adoptee takes its donor's device whatever it is given
    dev_val = DeviceWeaksupFeed([va], resident_from=train_feed, **kw)
    assert dev_val._mos is train_feed._mos and dev_val.device == train_feed.device
    _epochs(WeaksupFeed([va], **kw), dev_val)
    tr.close()
    va.close()


def test_multi_region_val_adopts_two_region_donor(synth, tmp_path):
    uga = make_synthetic_region(str(tmp_path), "uga", height=256, width=320, seed=13)
    donor = DeviceWeaksupFeed([_ds(synth), _ds(uga, "uga")], batch_size=2, seed=1604,
                              prefetch=0, device="cpu")
    va = _ds(uga, "uga", split="val")
    kw = dict(batch_size=1, seed=1604, prefetch=0, augment=False, drop_last=False)
    dev_val = DeviceWeaksupFeed([va], resident_from=donor, **kw)
    assert dev_val._mos is donor._mos and dev_val._x_off == [320]
    _epochs(WeaksupFeed([va], **kw), dev_val)


@pytest.mark.parametrize("what", ["nir", "asc_aug", "transport"])
def test_resident_donor_mismatch_rejected(synth, what):
    donor = DeviceWeaksupFeed([_ds(synth)], batch_size=2, seed=1600, prefetch=0, device="cpu")
    kw = dict(batch_size=1, seed=1600, augment=False)
    if what == "nir":
        va, match = _ds(synth, nir=False, split="val"), "different region/config"
    elif what == "asc_aug":
        va, match = _ds(synth, asc_aug=True, split="val"), "ascending"
    else:
        va, match = _ds(synth, split="val"), "transport"
        kw["transport"] = "bf16"
    with pytest.raises(Ineligible, match=match):
        DeviceWeaksupFeed([va], resident_from=donor, **kw)


def test_multi_region_modality_mismatch_rejected(synth, tmp_path):
    uga = make_synthetic_region(str(tmp_path), "uga", height=128, width=128, seed=14)
    with pytest.raises(Ineligible, match="modality config"):
        DeviceWeaksupFeed([_ds(synth), _ds(uga, "uga", nir=False)], batch_size=2, device="cpu")


# ---- season rotation ----------------------------------------------------------


def _samples_by_key(batches):
    """{(census_idx, season): {key: per-sample tensor}} across an epoch."""
    out = {}
    for b in batches:
        b = uploaded(b)
        for i in range(len(b["census_idx"])):
            k = (float(b["census_idx"][i]), int(b["season"][i]))
            assert k not in out, k
            out[k] = {kk: b[kk][i] for kk in ("S2", "S1", "admin_mask")}
            out[k]["y"] = torch.tensor(b["y"][i])
    return out


def test_rotating_feed_sample_parity(synth):
    """rotate=True visits the host feed's sample multiset with identical
    per-sample tensors; only the (season-major) order and the batch
    composition change. augment=False: no batch-level draw differs."""
    ds = _ds(synth)
    kw = dict(batch_size=2, seed=1600, prefetch=0, augment=False, drop_last=False)
    host = WeaksupFeed([ds], **kw)
    rot = DeviceWeaksupFeed([ds], rotate=True, device="cpu", **kw)
    assert rot._rotating and rot._mos is None
    for epoch in (0, 1):
        hs = _samples_by_key(list(host.epoch(epoch)))
        rs = _samples_by_key(list(rot.epoch(epoch)))
        assert set(hs) == set(rs)
        for k in hs:
            for kk, a in hs[k].items():
                b = rs[k][kk]
                assert a.dtype == b.dtype and torch.equal(a, b), (k, kk)
    ds.close()


def test_rotating_feed_resident_slice_only(synth):
    ds = _ds(synth, viirs=True)
    rot = DeviceWeaksupFeed([ds], rotate=True, batch_size=2, seed=1600, prefetch=0,
                            augment=False, device="cpu")
    list(rot.epoch(0))
    assert rot._mos["S2"].shape[0] == 1  # one season
    assert rot._mos["S1"].shape[0] == rot._s1_orb
    assert "VIIRS" in rot._mos_static  # statics uploaded once
    full = DeviceWeaksupFeed([ds], batch_size=2, seed=1600, prefetch=0, device="cpu")
    assert full._mos["S2"].shape[0] == 4
    ds.close()


def test_rotating_feed_budget_gate(synth):
    with pytest.raises(Ineligible):
        DeviceWeaksupFeed([_ds(synth)], rotate=True, hbm_budget_bytes=1024,
                          batch_size=2, seed=1600, prefetch=0, device="cpu")


def test_rotating_feed_prefetch(synth):
    """The next season's slices upload on the worker while the current
    season trains, _set_active_season installs them (no second upload),
    the epoch ends having prefetched the next epoch's first season, and a
    stale prefetch is dropped safely."""
    ds = _ds(synth)
    rot = DeviceWeaksupFeed([ds], rotate=True, batch_size=2, seed=1600, prefetch=0,
                            augment=False, device="cpu")
    seasons = []
    for b in rot.epoch(0):
        s = int(b["season"][0])
        if not seasons or seasons[-1] != s:
            seasons.append(s)
        if len(seasons) >= 2 and rot._next_slices is not None:
            assert rot._next_slices[0] != rot._active_season
    assert rot._next_slices is not None
    first = sorted(seasons)[0]
    assert rot._next_slices[0] == first
    pre = rot._next_slices[1].result()
    rot._set_active_season(first)
    assert rot._mos["S2"] is pre["S2"]  # installed, not uploaded again
    rot._prefetch_season((first + 1) % 4)
    rot._set_active_season((first + 2) % 4)
    assert rot._next_slices is None and rot._mos["S2"].shape[0] == 1
    ds.close()


def test_rotating_donor_rejected(synth):
    ds = _ds(synth)
    rot = DeviceWeaksupFeed([ds], rotate=True, batch_size=2, prefetch=0, device="cpu")
    with pytest.raises(Ineligible, match="rotates"):
        DeviceWeaksupFeed([ds], resident_from=rot, batch_size=2, prefetch=0)
    ds.close()


# ---- the host feed against the JAX package's ----------------------------------


@pytest.mark.parametrize("augment", [False, True])
def test_host_feed_matches_jax_host_feed(tmp_path, augment):
    """The port's WeaksupFeed yields the JAX package's batches, key by key,
    bit for bit, on the same region (written by the JAX package) and seed."""
    paths = j_make(str(tmp_path), "rwa", height=256, width=320, seed=27,
                   with_viirs=True, with_buildings=True)
    dkw = dict(mode="weaksup", train_level="coarse", patchsize=None, overlap=None,
               fourseasons=True, viirs=True, sentinelbuildings=False)
    kw = dict(batch_size=2, seed=1610, prefetch=0, augment=augment,
              building_input=True, segmentation_input=True)
    ref = list(JWeaksupFeed([JDataset(paths, "rwa", **dkw)], **kw).epoch(1))
    got = list(WeaksupFeed([PopulationDataset(paths, "rwa", **dkw)], **kw).epoch(1))
    assert len(got) == len(ref) > 0
    for bg, br in zip(got, ref):
        # the port's batch also carries each sample's extent in the bucket
        assert set(bg) == set(br) | {"extent"}
        assert_extent_holds_the_samples(bg)
        for k in br:
            a, b = np.asarray(bg[k]), np.asarray(br[k])
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)

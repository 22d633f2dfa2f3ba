"""Device-resident weakly-supervised training feed.

Counterpart of popcorn_tpu/data/device_weaksup.py. The host training feed
(data/feed.py::WeaksupFeed, the reference's ConcatDataset + DataLoader
stack, run_train.py:423-431) crops every census-region sample from the
season mosaics on the host and uploads it — tens of MB per step, every
step, every epoch; the same pixels are re-read and re-sent whenever a
region is revisited.

This feed uploads the season mosaics and the admin-boundary raster to the
device ONCE, and assembles each batch there: one indexed gather per
modality crops every sample of the batch, beyond-crop pixels are masked by
``arange`` compares, and the reference's geometric augmentations (flips +
k*90 rotations, utils/transform.py) run as ``torch.flip``/``transpose``.
Steady-state training then moves no image bytes between host and device;
the host computes only coordinates.

Bit-parity: item order, rng streams (per-item season/orbit draws and
per-batch augmentation draws, all on the host with the host feed's numpy
generators) and bucket grouping reuse the host feed's code paths (the
WeaksupFeed hooks); the assembled batches equal the host feed's batches
after its upload (tests/test_torch_device_weaksup.py).

Multi-region training (``-tregtrain reg1 reg2 ...``) concatenates the
regions' mosaics row-wise into one resident stack — the per-item
validity mask makes inter-region padding unnecessary (see __init__).

Ascending-orbit augmentation (``-ascAug``) keeps BOTH S1 orbit stacks
resident (leading dim interleaves season and orbit); the per-item orbit
draw selects the slice on device.

NaN-bearing mosaics run HYBRID: a tile-level summed-area table answers
"does this window overlap NaN data" in O(1); such items take the
reference's host healing path (interpolate / ascending refetch,
PopulationDataset.py:418-441) and are spliced into the assembled device
batch, everything else stays device-resident — still bit-equal to the
host feed.

Eligibility: same modality config across regions and the resident stack
must fit ``hbm_budget_bytes`` (capped by the device's free memory).
Construction raises ``Ineligible`` otherwise; the trainer falls back to
the season-rotating form (``rotate=True``) or the host feed.

Data parallelism (``mesh=``, dist/mesh.py): every rank holds the whole
resident stack (as the JAX package replicates it over its mesh) and draws
the same global batches; each assembles only its own rows
(``Mesh.batch_rows``) of a batch that splits over the data ranks, with
the bucket shape, the geometric draw and the S2 dtype of the global
batch, and marks it with 'rows' so ``shard_batch`` passes it through.
Its tensors then equal the rank's rows of the host feed's batch. A
batch that does not split (a last, smaller batch) comes whole, for the
trainer to pad and split.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .dataset import PopulationDataset
from .feed import (
    TRANSPORT_KEYS,
    WeaksupFeed,
    bucket_dim,
    extents_after,
    host_tensor,
    to_bfloat16,
    widen_u16,
)
from ..aug.augment import draw_general, draw_photometric
from ..io.geotiff import has_nan, nan_tile_any


class Ineligible(Exception):
    """This dataset cannot be served from device-resident mosaics."""


def _is_raw_u16_source(src) -> bool:
    """True when a _RasterSource can serve raw uint16 windows (uint16
    GeoTIFF or its pre-decoded sidecar, not in-memory) — mirrors
    infer/device_feed.py::_read_raw_u16's eligibility without reading
    any pixels."""
    from ..io.geotiff import GeoTIFF

    g = getattr(src, "_g", None)
    return (
        getattr(src, "_mem", None) is None
        and np.dtype(getattr(src, "dtype", np.float32)) == np.uint16
        and (getattr(src, "_cache", None) is not None or isinstance(g, GeoTIFF))
    )


def _effective_budget(hbm_budget_bytes: float, device) -> float:
    """The paper budget capped by what the device actually has free: 60%
    of ``torch.cuda.mem_get_info``'s free bytes on a card, leaving
    headroom for params, optimizer state, activations and the stitch
    accumulators; the budget as given on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return hbm_budget_bytes
    free, _ = torch.cuda.mem_get_info(device)
    return min(hbm_budget_bytes, 0.6 * free)


def _season_chw(
    ds: PopulationDataset, modality: str, season_idx: int, asc: bool = False
):
    """One season's mosaic as (C, H, W) numpy: raw uint16 S2 where the
    source serves it, lossless-uint16 S2, else float32 (NaN-bearing
    mosaics stay float32; the NaN tables route their items to the host)."""
    from ..infer.device_feed import _read_raw_u16

    h, w = ds.cr_shape
    window = ((0, h), (0, w))
    src = ds._source(modality, season_idx, asc)
    if modality == "S2":
        bands = (3, 2, 1, 4) if ds.nir else (3, 2, 1)
        arr = _read_raw_u16(src, bands, window)
        if arr is not None:
            return arr
        arr = src.read(bands, window)
    else:  # S1
        arr = src.read((1, 2), window)
    if modality == "S2" and not has_nan(arr):
        # the host feed's lossless-uint16 transport rule (data/feed.py),
        # which also halves the resident S2 bytes
        u16 = arr.astype(np.uint16)
        if np.array_equal(u16, arr):
            return np.ascontiguousarray(u16)
    return np.ascontiguousarray(arr, np.float32)


_NAN_TILE = 32  # granularity of the window-has-NaN query (conservative)


def _integral_of_tiles(t: np.ndarray) -> np.ndarray:
    """Summed-area table of a 2-D tile-level bool grid: O(1) conservative
    "does this window overlap any True tile" queries."""
    th, tw = t.shape
    integ = np.zeros((th + 1, tw + 1), np.int32)
    integ[1:, 1:] = np.cumsum(np.cumsum(t, 0), 1)
    return integ


def _tile_integral(mask: np.ndarray, tile: int = _NAN_TILE) -> np.ndarray:
    """Summed-area table over ``tile``-sized blocks of a 2-D bool mask:
    O(1) conservative "does this window overlap any True pixel" queries
    at 1/tile^2 the memory of a pixel-level integral image."""
    h, w = mask.shape
    th, tw = -(-h // tile), -(-w // tile)
    pad = np.zeros((th * tile, tw * tile), bool)
    pad[:h, :w] = mask
    return _integral_of_tiles(pad.reshape(th, tile, tw, tile).any(axis=(1, 3)))


def _nan_tile_integral(arr: np.ndarray, tile: int = _NAN_TILE):
    """NaN-query table for a (C, H, W) float mosaic, or None when clean.

    Same table ``_tile_integral(isnan(arr).any(axis=0))`` builds, but the
    NaN scan runs as one native streaming pass (io/geotiff.py::
    nan_tile_any) with no full-size bool temporaries."""
    t = nan_tile_any(arr, tile)
    return _integral_of_tiles(t) if t.any() else None


def _window_has_nan(
    integ: np.ndarray, x0: int, y0: int, dx: int, dy: int,
    tile: int = _NAN_TILE,
) -> bool:
    t0, u0 = x0 // tile, y0 // tile
    t1 = min((x0 + dx - 1) // tile + 1, integ.shape[0] - 1)
    u1 = min((y0 + dy - 1) // tile + 1, integ.shape[1] - 1)
    s = integ[t1, u1] - integ[t0, u1] - integ[t1, u0] + integ[t0, u0]
    return bool(s)


def _check_same_config(dss) -> None:
    if any(d.mode != "weaksup" for d in dss):
        raise Ineligible("weaksup datasets only")
    d0 = dss[0]
    for d in dss[1:]:
        if (
            (d.s2, d.s1, d.nir, d.viirs, d.fourseasons, d.asc_aug)
            != (d0.s2, d0.s1, d0.nir, d0.viirs, d0.fourseasons, d0.asc_aug)
            or (d._gb_counts is None) != (d0._gb_counts is None)
            or (d._gb_seg is None) != (d0._gb_seg is None)
        ):
            raise Ineligible("training regions differ in modality config")


def resident_layout(datasets, ladder, transport: str) -> Dict:
    """Shapes, dtypes and byte costs of the concatenated resident stack —
    pure metadata (census tables + raster headers, NO pixel IO), shared by
    :class:`DeviceWeaksupFeed` and the trainer's feed cost gate
    (data/feed_select.py), which must estimate the rotating feed's
    per-epoch upload bytes BEFORE paying the construction's full-stack
    host read. Raises :class:`Ineligible` for configs the device feed
    cannot serve (non-weaksup datasets, mismatched modality configs)."""
    from .dataset import max_census_window

    dss = list(datasets)
    _check_same_config(dss)
    d0 = dss[0]

    # Multi-region layout: regions concatenate ROW-WISE with no gap —
    # a crop's beyond-(dx,dy) pixels are replaced by the validity mask
    # regardless of what the gather read, so crops that run past a
    # region's rows (into the next region) or columns (into the width
    # pad of a narrower region) cannot contaminate the sample. The only
    # hard requirement is that no crop runs past the stack, so a single
    # global tail/right pad of the largest bucket any census table can
    # request suffices.
    wins = [max_census_window(d) for d in dss]
    ph = bucket_dim(max(x for x, _ in wins), ladder)
    pw = bucket_dim(max(y for _, y in wins), ladder)
    offs: List[int] = []
    rows = 0
    for d in dss:
        offs.append(rows)
        rows += d.cr_shape[0]
    width = max(d.cr_shape[1] for d in dss)
    hp, wp = rows + ph, width + pw

    seasons = list(range(4)) if d0.fourseasons else [0]
    # float image modalities' resident dtype under the transport rule:
    # bf16 halves their budget cost (and the upload), see feed.py
    fdt = torch.bfloat16 if transport == "bf16" else torch.float32
    planes: Dict[str, Tuple[torch.dtype, int]] = {}
    if d0.s2:
        # costed as the float transport dtype unless every season of
        # every region is raw-uint16-readable (resident as its int16 bit
        # view): the lossless-u16 fallback conversion may still land on
        # u16, but budgeting must never undercount
        s2_u16 = all(
            _is_raw_u16_source(d._source("S2", s, False))
            for d in dss for s in seasons
        )
        planes["S2"] = (
            torch.int16 if s2_u16 else fdt,
            len(seasons) * (4 if d0.nir else 3),
        )
    n_orb = 2 if d0.asc_aug else 1  # -ascAug: both orbit stacks resident
    if d0.s1:
        planes["S1"] = (fdt, len(seasons) * n_orb * 2)
    if d0.viirs:
        planes["VIIRS"] = (fdt, 1)
    if d0._gb_counts is not None:
        planes["building_counts"] = (torch.float32, 1)
    if d0._gb_seg is not None:
        planes["building_segmentation"] = (torch.float32, 1)
    need_full = hp * wp * 4  # boundary
    need_active = hp * wp * 4
    slice_bytes = 0  # one season's swappable S2/S1 slice bytes
    for k, (dt, nchan) in planes.items():
        need_full += hp * wp * nchan * dt.itemsize
        per = nchan
        if k in ("S2", "S1"):
            per = nchan // len(seasons)
            # only the seasonal slices swap; statics (VIIRS/counts/
            # segmentation) upload once and stay
            slice_bytes += hp * wp * per * dt.itemsize
        need_active += hp * wp * per * dt.itemsize
    return {
        "offs": offs, "rows": rows, "width": width, "hp": hp, "wp": wp,
        "seasons": seasons, "n_orb": n_orb, "planes": planes,
        "need_full": need_full, "need_active": need_active,
        "slice_bytes": slice_bytes,
    }


class DeviceWeaksupFeed(WeaksupFeed):
    """WeaksupFeed whose pixel assembly runs on ``device`` from resident
    mosaics. Yields batches whose image keys are tensors on that device,
    in the form the host feed's batches take after their upload
    (infer/sliding.py::_upload): S2 as int32 values where it rides
    uint16, float32 or bfloat16 otherwise. The trainer's upload passes
    them through untouched."""

    def __init__(
        self,
        datasets,
        *,
        hbm_budget_bytes: float = 9e9,
        resident_from: "Optional[DeviceWeaksupFeed]" = None,
        rotate: bool = False,
        mesh=None,
        device="cuda",
        **kw,
    ):
        super().__init__(datasets, **kw)
        self._mesh = mesh if mesh is not None and mesh.n_data > 1 else None
        from ..infer.sliding import resolve_device

        # an adoptee lives where its donor's stacks do
        donor_dev = getattr(resident_from, "device", None)
        self.device = donor_dev if donor_dev is not None else resolve_device(device)
        self._rotating = False
        self._mos_host: Optional[Dict[str, torch.Tensor]] = None
        self._active_season: Optional[int] = None
        self._next_slices = None  # (season, Future) from _prefetch_season
        self._up_pool = None
        self._side_stream = None

        dss = self.datasets
        self._ds = dss[0] if dss else None
        if resident_from is not None:
            _check_same_config(dss)
            # Share another feed's resident stacks (the weak-validation
            # feed over the same region(s): same mosaic files, different
            # census split — one upload serves both; the reference re-reads
            # every val crop per validation pass, run_train.py:289-312).
            self._adopt_resident(resident_from)
            return

        lay = resident_layout(dss, self.ladder, self.transport)
        d0 = self._ds
        offs, hp, wp, rows = lay["offs"], lay["hp"], lay["wp"], lay["rows"]
        seasons, n_orb = lay["seasons"], lay["n_orb"]
        budget = _effective_budget(hbm_budget_bytes, self.device)
        if lay["need_full"] > budget and not rotate:
            raise Ineligible(
                f"resident stack needs {lay['need_full'] / 1e9:.1f} GB > budget "
                f"{budget / 1e9:.1f} GB"
            )
        if rotate:
            # Season-rotation middle path: only ONE season's S2/S1 slices
            # are resident at a time (statics + boundary stay); the full
            # stacks live in host RAM and each epoch visits its samples
            # season-grouped (see _epoch_batches) so every slice uploads
            # once per epoch. Per-sample tensors are bit-identical to the
            # full-resident/host feeds (same per-item RNG draws, per-item
            # bucket shapes); what changes is the visitation ORDER
            # (season-major) and therefore batch composition / per-batch
            # augmentation draws. Swap transient: old + new season slices
            # resident during the switch (prefetch holds the next slice
            # alongside the active).
            if lay["need_active"] + lay["slice_bytes"] > budget:
                raise Ineligible(
                    f"rotating resident slice needs "
                    f"{lay['need_active'] / 1e9:.1f} GB "
                    f"(+swap) > budget {budget / 1e9:.1f} GB"
                )

        def _blocks(read_one, nchan, idxs, dtype_from_parts=False):
            """(len(idxs), C, hp, wp) stack with each region's rows at its
            offset; dtype unions to float32 unless every part agrees."""
            parts = {
                (di, i): read_one(d, i)
                for di, d in enumerate(dss) for i in range(len(idxs))
            }
            dt = np.float32
            if dtype_from_parts and all(
                a.dtype == np.uint16 for a in parts.values()
            ):
                dt = np.uint16
            stack = np.zeros((len(idxs), nchan, hp, wp), dt)
            for (di, i), a in parts.items():
                h_d, w_d = dss[di].cr_shape
                stack[i, :, offs[di]:offs[di] + h_d, :w_d] = a
            return stack

        mos: Dict[str, np.ndarray] = {}
        if d0.s2:
            mos["S2"] = _blocks(
                lambda d, s: _season_chw(d, "S2", s),
                4 if d0.nir else 3, seasons, dtype_from_parts=True,
            )
        if d0.s1:
            # leading dim interleaves orbits: index = season * n_orb + orb
            # (orb 0 = descending, 1 = ascending), as _assemble reads it
            mos["S1"] = _blocks(
                lambda d, i: _season_chw(
                    d, "S1", i // n_orb, asc=bool(i % n_orb)
                ),
                2, [s * n_orb + o for s in seasons for o in range(n_orb)],
            )

        def _static(read_one):
            stat = np.zeros((1, hp, wp), np.float32)
            for di, d in enumerate(dss):
                h_d, w_d = d.cr_shape
                stat[0, offs[di]:offs[di] + h_d, :w_d] = read_one(d)
            return stat

        def _full(d):
            return ((0, d.cr_shape[0]), (0, d.cr_shape[1]))

        if d0.viirs:
            mos["VIIRS"] = _static(
                lambda d: d._source("viirs", 0, False).read((1,), _full(d))[0]
            )
        if d0._gb_counts is not None:
            mos["building_counts"] = _static(
                lambda d: d._gb_counts.read(1, window=_full(d))[0]
            )
        if d0._gb_seg is not None:
            mos["building_segmentation"] = _static(
                lambda d: d._gb_seg.read(1, window=_full(d))[0]
            )

        bnd_p = np.full((hp, wp), -1.0, np.float32)
        for di, d in enumerate(dss):
            h_d, w_d = d.cr_shape
            bnd_p[offs[di]:offs[di] + h_d, :w_d] = d._boundary(
                d.train_level
            ).read(1, window=_full(d))[0]

        # window-has-NaN query tables (tile-level, conservative): items
        # whose drawn windows overlap a NaN tile take the host healing
        # path; everything else assembles from the (NaN-bearing) resident
        # stacks, whose NaNs then sit only in masked/overwritten areas
        self._nan_q: Dict[str, list] = {}
        for k, a in mos.items():
            if a.dtype == np.uint16:
                continue  # uint16 cannot hold NaN
            per = a if a.ndim == 4 else a[None]
            qs = [_nan_tile_integral(per[i]) for i in range(per.shape[0])]
            if any(q is not None for q in qs):
                self._nan_q[k] = qs

        # transport rule on the resident stacks (data/feed.py::
        # transport_cast): float32 image modalities ride bfloat16 — half
        # the residency and upload bytes for S1. Cast AFTER the NaN tables
        # (bf16 keeps NaN, but the tables scan float32). Host-healed items
        # get the same cast in _splice_host_items, so per-sample dtypes
        # stay equal.
        host: Dict[str, torch.Tensor] = {}
        for k, a in mos.items():
            if self.transport == "bf16" and k in TRANSPORT_KEYS and a.dtype == np.float32:
                host[k] = to_bfloat16(a)
            else:
                host[k] = host_tensor(a)
        del mos

        self._seasonal = {"S2", "S1"}
        self._n_seasons = len(seasons)
        if rotate:
            self._rotating = True
            self._mos_host = host
            # statics (VIIRS/counts/seg) are season-invariant: resident once
            self._mos_static = {
                k: self._dev_put(v)
                for k, v in host.items() if k not in self._seasonal
            }
            self._mos = None  # set per active season (_set_active_season)
        else:
            self._mos = {k: self._dev_put(v) for k, v in host.items()}
        self._bnd = self._dev_put(torch.from_numpy(bnd_p))
        self._x_off = list(offs)
        self._s1_orb = n_orb
        self._resident_meta = {
            "regions": tuple(
                (d.region, d.train_level, d.cr_shape, off)
                for d, off in zip(dss, offs)
            ),
            "rows_total": rows, "hp": hp, "wp": wp,
            "s2": d0.s2, "s1": d0.s1, "nir": d0.nir,
            "fourseasons": d0.fourseasons, "s1_orbits": n_orb,
            "keys": frozenset(host), "transport": self.transport,
        }

    def _dev_put(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the feed's device (through pinned memory on a
        card; the host tensor itself on the CPU)."""
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _adopt_resident(self, donor: "DeviceWeaksupFeed") -> None:
        """Reuse ``donor``'s resident stacks for this feed's census
        tables. Valid only when both feeds window the same mosaic files
        the same way; raises Ineligible otherwise (the caller falls back
        to the host feed)."""
        meta = getattr(donor, "_resident_meta", None)
        if meta is None:
            raise Ineligible("donor feed carries no resident stacks")
        if getattr(donor, "_rotating", False):
            # a rotating donor's device contents change under the
            # adoptee's feet mid-epoch; the validation feed falls back to
            # host reads
            raise Ineligible("donor feed rotates its resident stacks")
        if meta.get("transport", "exact") != self.transport:
            raise Ineligible("donor feed uses a different transport dtype")
        d0 = self._ds
        want_keys = set()
        if d0.s2:
            want_keys.add("S2")
        if d0.s1:
            want_keys.add("S1")
        if d0.viirs:
            want_keys.add("VIIRS")
        if d0._gb_counts is not None:
            want_keys.add("building_counts")
        if d0._gb_seg is not None:
            want_keys.add("building_segmentation")
        if not (
            meta["s2"] == d0.s2 and meta["s1"] == d0.s1
            and meta["nir"] == d0.nir
            and meta["fourseasons"] == d0.fourseasons
            and meta["keys"] == want_keys
        ):
            raise Ineligible("donor resident stacks cover a different region/config")
        from .dataset import max_census_window

        by_region = {
            (reg, lvl, shape): off for reg, lvl, shape, off in meta["regions"]
        }
        x_off = []
        for d in self.datasets:
            key = (d.region, d.train_level, d.cr_shape)
            if key not in by_region:
                raise Ineligible("donor resident stacks cover a different region/config")
            # no crop may run past the stack: this census table's largest
            # window must fit the donor's global tail/right padding
            dx_max, dy_max = max_census_window(d)
            if (
                bucket_dim(dx_max, self.ladder) > meta["hp"] - meta["rows_total"]
                or bucket_dim(dy_max, self.ladder) > meta["wp"] - d.cr_shape[1]
            ):
                raise Ineligible("donor resident padding too small for this census")
            x_off.append(by_region[key])
        # a non-ascAug adoptee reads orb=0 (descending) slots of an
        # orbit-interleaved donor stack correctly; the reverse (ascAug
        # adoptee, single-orbit donor) has no asc data to read
        if d0.asc_aug and meta["s1_orbits"] == 1 and d0.s1:
            raise Ineligible("donor stacks carry no ascending-orbit data")
        self._seasonal = donor._seasonal
        self._mos = donor._mos
        self._bnd = donor._bnd
        self._x_off = x_off
        self._s1_orb = meta["s1_orbits"]
        self._nan_q = donor._nan_q
        self._resident_meta = meta

    # ---- WeaksupFeed hooks --------------------------------------------------

    def _fetch_item(self, j: int, epoch: int) -> Optional[Dict]:
        from .feed import _item_rng

        d, i = self.index[j]
        meta = self.datasets[d].get_admin_meta(i, _item_rng(self.seed, epoch, j))
        off = self._x_off[d]
        if off:
            # region d's rows live at this offset in the concatenated stack
            meta = dict(meta, x0=meta["x0"] + off)
        if self._nan_q and self._window_needs_healing(meta):
            # the drawn window overlaps NaN data: take the reference's
            # host healing path (PopulationDataset.py:418-441) for this
            # item; _item_rng is a fresh per-item generator, so the item
            # draws exactly the same season/orbit as the meta did
            try:
                return self.datasets[d].get_admin_item(
                    i, _item_rng(self.seed, epoch, j)
                )
            except ValueError:
                return None  # unhealable ("No data here!"), skip
        return meta

    def _window_needs_healing(self, meta: Dict) -> bool:
        x0, y0, dx, dy = meta["x0"], meta["y0"], meta["dx"], meta["dy"]
        season = meta["season"]
        orb = 0 if meta["descending"] else 1
        for k, qs in self._nan_q.items():
            if k == "S1":
                idx = season * self._s1_orb + orb
            elif k == "S2":
                idx = season
            else:
                idx = 0
            q = qs[idx] if idx < len(qs) else None
            if q is not None and _window_has_nan(q, x0, y0, dx, dy):
                return True
        return False

    def _item_hw(self, item: Dict) -> Tuple[int, int]:
        if "dx" in item:
            return item["dx"], item["dy"]
        return item["admin_mask"].shape  # host-healed item

    # ---- season rotation (middle path for regions over the budget) ----------

    def _upload_slices(self, s: int) -> Dict[str, torch.Tensor]:
        """Season ``s``'s S2/S1 slices on the device; returns once they are
        resident. On a card the copies run on a side stream (pinned
        memory), and the slices are marked in use by the default stream,
        where batches are assembled."""
        no = self._s1_orb
        host = {}
        if "S2" in self._mos_host:
            host["S2"] = self._mos_host["S2"][s : s + 1]
        if "S1" in self._mos_host:
            host["S1"] = self._mos_host["S1"][s * no : (s + 1) * no]
        if self.device.type != "cuda":
            return host
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side_stream):
            sl = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._side_stream)
        done.synchronize()
        consumer = torch.cuda.default_stream(self.device)
        for t in sl.values():
            t.record_stream(consumer)
        return sl

    def _prefetch_season(self, s: int) -> None:
        """Start uploading season ``s``'s slices on a worker thread while
        the current season trains — the copy runs under device compute and
        host batch assembly. The constructor's budget gate already
        reserves the two-slice transient this holds (prefetched +
        active)."""
        if self._active_season == s:
            return
        pending = self._next_slices
        if pending is not None and pending[0] == s:
            return
        if pending is not None:
            pending[1].result()  # discard a stale prefetch (bounds memory)
        if self._up_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._up_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="season-prefetch"
            )
        self._next_slices = (s, self._up_pool.submit(self._upload_slices, s))

    def _set_active_season(self, s: int) -> None:
        """Swap the resident S2/S1 slices to season ``s`` (rotating mode).
        Statics and the boundary stay resident; the constructor's budget
        gate reserved room for one slice plus the swap transient. Uses the
        prefetched slices when ``_prefetch_season(s)`` ran."""
        if self._active_season == s:
            return
        pending, self._next_slices = self._next_slices, None
        if pending is not None and pending[0] == s:
            sl = pending[1].result()
        else:
            if pending is not None:
                pending[1].result()  # stale prefetch: drop it
            sl = self._upload_slices(s)
        mos = dict(self._mos_static)
        mos.update(sl)
        self._mos = mos  # drops the previous slice's references
        self._active_season = s

    def _epoch_batches(self, epoch: int):
        if not self._rotating:
            yield from super()._epoch_batches(epoch)
            return
        # Season-major visitation: the SAME per-sample draws as the host
        # feed (identical _item_rng streams -> identical season/orbit/
        # window per sample, identical per-sample tensors), regrouped so
        # each season's resident slice uploads exactly once per epoch.
        # Batch composition therefore differs from the host feed (and so
        # do the per-batch augmentation draws) — an explicit trade,
        # pinned in tests/test_torch_device_weaksup.py.
        from .feed import _batch_rng, _item_rng, _ordered_map

        rng = np.random.default_rng(self.seed + 1000 * epoch)
        order = rng.permutation(len(self.index))
        if self.max_samples is not None:
            order = order[: self.max_samples]
        # Two passes so host RAM stays bounded: the first groups by season
        # from METAS ONLY (get_admin_meta does no pixel IO and replays the
        # same _item_rng stream _fetch_item will), the second fetches/heals
        # each season group lazily through _ordered_map's bounded window.
        groups: Dict[int, list] = {}
        for j in order:
            d, i = self.index[j]
            meta = self.datasets[d].get_admin_meta(
                i, _item_rng(self.seed, epoch, int(j))
            )
            groups.setdefault(int(meta["season"]), []).append(int(j))

        def _to_host_item(j):
            """Exact host fallback for a meta whose season slice is gone
            (group-boundary leftovers): same rng stream -> same draws."""
            d, i = self.index[j]
            try:
                return self.datasets[d].get_admin_item(
                    i, _item_rng(self.seed, epoch, int(j))
                )
            except ValueError:
                return None

        pending: Dict[Tuple[int, int], list] = {}
        nb = 0
        season_order = sorted(groups)
        for si, s in enumerate(season_order):
            self._set_active_season(s)
            # upload the NEXT slice on a worker while this season trains;
            # at the epoch's last season, prefetch its first (the epochs'
            # season order is deterministic), hiding the next epoch's
            # opening swap under validation/checkpoint host work
            nxt = season_order[(si + 1) % len(season_order)]
            if nxt != s:
                self._prefetch_season(nxt)
            season_keys = set()
            fetched = _ordered_map(
                lambda j: (j, self._fetch_item(j, epoch)), groups[s],
                self.num_workers,
                window=self.num_workers + max(2, self.prefetch),
            )
            for j, item in fetched:
                if item is None:
                    continue
                h, w = self._item_hw(item)
                key = (bucket_dim(h, self.ladder), bucket_dim(w, self.ladder))
                season_keys.add(key)
                pending.setdefault(key, []).append((j, item))
                if len(pending[key]) == self.batch_size:
                    items = [it for _, it in pending.pop(key)]
                    yield self._make_batch(
                        items, _batch_rng(self.seed, epoch, nb)
                    )
                    nb += 1
            # group boundary: metas still pending reference this season's
            # slice, which is about to rotate out — convert them to exact
            # host items (they then batch with any future same-bucket item)
            for key in season_keys:
                kept = []
                for j, item in pending.get(key, []):
                    if "dx" not in item:
                        kept.append((j, item))
                        continue
                    hi = _to_host_item(j)
                    if hi is not None:
                        kept.append((j, hi))
                if kept:
                    pending[key] = kept
                elif key in pending:
                    del pending[key]
        if not self.drop_last:
            for key, pairs in pending.items():
                items = [it for _, it in pairs]
                if items:
                    yield self._make_batch(
                        items, _batch_rng(self.seed, epoch, nb)
                    )
                    nb += 1

    # ---- device assembly ----------------------------------------------------

    def _assemble(self, items: List[Dict], bh: int, bw: int, season, orb, g) -> Dict:
        """Crop every item of the batch from the resident stacks, mask
        beyond its (dx, dy) crop (images 0, admin mask -1) and apply the
        batch's geometric draw ``g`` — (B, bh, bw, C) tensors, with the
        static single-channel keys as (B, bh, bw, 1)."""
        dev = self.device

        def col(key):
            # host-healed items ride along with empty device crops (their
            # slots are overwritten in _splice_host_items)
            return np.asarray([it.get(key, 0) for it in items], np.int64)

        x0, y0, dx, dy = col("x0"), col("y0"), col("dx"), col("dy")
        # one gather a key: rows (B, bh, 1) and cols (B, 1, bw) broadcast
        # over the batch's crops (exact copies of the resident values)
        rows = torch.from_numpy(x0[:, None, None] + np.arange(bh)[None, :, None]).to(dev)
        cols = torch.from_numpy(y0[:, None, None] + np.arange(bw)[None, None, :]).to(dev)
        rsel = torch.from_numpy(np.arange(bh)[None, :, None] >= dx[:, None, None]).to(dev)
        csel = torch.from_numpy(np.arange(bw)[None, None, :] >= dy[:, None, None]).to(dev)
        outside = rsel | csel  # (B, bh, bw): beyond the item's crop
        s1_idx = torch.from_numpy(season * self._s1_orb + orb).to(dev)
        s2_idx = torch.from_numpy(season).to(dev)
        batch = {}
        for k, a in self._mos.items():
            if k in self._seasonal:
                idx = (s1_idx if k == "S1" else s2_idx)[:, None, None]
                # advanced indices around a slice: (B, bh, bw, C)
                sl = a[idx, :, rows, cols]
            else:
                sl = a[0][rows, cols][..., None]
            batch[k] = sl.masked_fill_(outside[..., None], 0)
        batch["admin_mask"] = self._bnd[rows, cols].masked_fill_(outside, -1.0)
        if g is None:
            return batch
        return {k: _geometric(v, g) for k, v in batch.items()}

    def _local_rows(self, n: int) -> Optional[np.ndarray]:
        """This rank's rows of an n-item batch under a mesh, None when
        the batch comes whole."""
        if self._mesh is None or n % self._mesh.n_data:
            return None
        return self._mesh.batch_rows(n)

    def _make_batch(self, items: List[Dict], rng: np.random.Generator) -> Dict:
        hosts = [i for i, it in enumerate(items) if "dx" not in it]
        if len(hosts) == len(items):
            # every member took the healing path: assemble exactly like
            # the host feed (same rng draw order -> bit-identical batch)
            return WeaksupFeed._make_batch(self, items, rng)

        dims = [self._item_hw(it) for it in items]
        h = max(d[0] for d in dims)
        w = max(d[1] for d in dims)
        bh, bw = bucket_dim(h, self.ladder), bucket_dim(w, self.ladder)

        g = draw_general(rng) if self.augment else None
        orb = np.asarray(
            [0 if it.get("descending", True) else 1 for it in items], np.int64
        )
        season = np.asarray([it["season"] for it in items], np.int64)
        if self._rotating:
            # the active resident stacks hold exactly ONE season at index
            # 0 (S2: (1,C,hp,wp); S1: (n_orb,2,hp,wp)) — _epoch_batches
            # guarantees every device item in the batch drew that season
            season = np.zeros_like(season)
        s2_float = self._s2_fractional(items, hosts)
        rows = self._local_rows(len(items))
        if rows is not None:
            # this rank's rows; shape, draws and S2 dtype stay the global
            # batch's
            items = [items[i] for i in rows]
            hosts = [i for i, it in enumerate(items) if "dx" not in it]
            season, orb = season[rows], orb[rows]
        batch = self._assemble(items, bh, bw, season, orb, g)

        if hosts or s2_float:
            batch = self._splice_host_items(batch, items, hosts, bh, bw, g, s2_float)
        # -binp/-sinp segmentation policy (reference utils/utils.py:153-159)
        if self.building_input and self.segmentation_input:
            if "building_segmentation" not in batch and "building_counts" in batch:
                batch["building_segmentation"] = (
                    batch["building_counts"][..., 0] > 0.5
                ).float()
        elif not self.segmentation_input:
            batch.pop("building_segmentation", None)
        # squeeze static single-channel keys to the host feed's (B, H, W)
        for k in ("building_counts", "building_segmentation"):
            if k in batch and batch[k].ndim == 4:
                batch[k] = batch[k][..., 0].contiguous()
        if "S2" in batch and batch["S2"].dtype == torch.int16:
            batch["S2"] = widen_u16(batch["S2"])
        batch["y"] = np.asarray([it["y"] for it in items], np.float32)
        batch["census_idx"] = np.asarray(
            [it["census_idx"] for it in items], np.float32
        )
        batch["season"] = np.asarray([it["season"] for it in items], np.int32)
        batch["extent"] = extents_after([self._item_hw(it) for it in items], bh, bw, g)
        if rows is not None:
            batch["rows"] = rows
        return self._finish_batch(batch, rng)

    def _s2_fractional(self, items, hosts) -> bool:
        """Whether a host-healed item carries fractional S2 values, so the
        batch's S2 ships float (the host feed's per-batch transport
        dtype)."""
        if not (self._mos and "S2" in self._mos and self._mos["S2"].dtype == torch.int16):
            return False
        for i in hosts:
            a = items[i].get("S2")
            if a is not None and not np.array_equal(a.astype(np.uint16), a):
                return True
        return False

    def _splice_host_items(self, batch, items, hosts, bh, bw, g, s2_float):
        """Overwrite host-healed items' slots in the assembled device
        batch: pad to the bucket, apply the SAME geometric draw host-side
        (index permutations — bitwise identical to the on-device one),
        and match the host feed's per-batch S2 transport dtype (healed
        values are fractional, so such batches ship float32, or bfloat16
        under the bf16 transport)."""
        from ..aug.augment import apply_geometric
        from .feed import pad_item_to

        if s2_float and "S2" in batch and batch["S2"].dtype == torch.int16:
            s2 = widen_u16(batch["S2"]).float()
            # integers below 2^16 are finite: torch's cast rounds them to
            # nearest even, as bf16_bits does
            batch["S2"] = s2.to(torch.bfloat16) if self.transport == "bf16" else s2
        s2_u16 = "S2" in batch and batch["S2"].dtype == torch.int16
        for i in hosts:
            it = pad_item_to(items[i], bh, bw)
            for k in list(batch):
                if k not in it:
                    continue
                a = it[k]
                if k == "S2" and s2_u16:
                    a = a.astype(np.uint16)
                if g is not None:
                    a = np.ascontiguousarray(apply_geometric(a, g, hw_axes=(0, 1)))
                tgt = batch[k]
                if tgt.ndim == a.ndim + 1 and tgt.shape[-1] == 1:
                    a = a[..., None]
                if tgt.dtype == torch.bfloat16:
                    # the host feed's transport cast, at the same point
                    t = to_bfloat16(a)
                elif a.dtype == np.uint16:
                    t = host_tensor(a)
                else:
                    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
                tgt[i] = t.to(tgt.device)
        return batch

    def _finish_batch(self, batch, rng):
        if self.augment:
            p = draw_photometric(rng)
            batch["photometric"] = np.asarray(
                [float(p.apply_brightness), p.beta, float(p.apply_gamma), p.gamma],
                np.float32,
            )
        else:
            batch["photometric"] = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
        return batch


def _geometric(a: torch.Tensor, g) -> torch.Tensor:
    """The reference's transform order on (B, H, W[, C]): vflip, hflip,
    then k*90 CCW rotation (aug/augment.py::apply_geometric's np.rot90
    over axes (1, 2)); exact index permutations."""
    if g.vflip:
        a = torch.flip(a, (1,))
    if g.hflip:
        a = torch.flip(a, (2,))
    if g.rot_k == 1:  # np.rot90(m, 1, (1, 2)) == flip(swapaxes(m, 1, 2), 1)
        a = torch.flip(a.transpose(1, 2), (1,))
    elif g.rot_k == 2:
        a = torch.flip(a, (1, 2))
    elif g.rot_k == 3:  # np.rot90(m, 3, (1, 2)) == flip(swapaxes(m, 1, 2), 2)
        a = torch.flip(a.transpose(1, 2), (2,))
    return a.contiguous()

"""Host->device data feed: bucketing, batching, augmentation, prefetch.

The reference trains on per-region variable-size bbox crops padded to the
per-batch max (data/PopulationDataset.py:884-958, DataLoader workers at
run_train.py:431). This feed instead pads every crop up to a small ladder of static bucket
shapes (multiples of 64, so the UNet's pad-to-64 path is a no-op) and
groups same-bucket items into batches. Masked semantics make the padding
inert: images pad with 0 and the admin mask with -1 (never a census idx),
exactly like the reference collate.

Geometric augmentations (flips, k*90 rotations — shape-changing!) run here
on the host per batch (one draw per batch, matching the reference's
allsame=True GPU transforms); photometric S2 params are drawn per batch
and applied on device (data.normalize).

A background prefetch thread overlaps raster IO with device compute
(double buffering; SURVEY.md §7 hard-part 5).
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..aug.augment import apply_geometric, draw_general, draw_photometric
from ..utils.profiling import span
from .dataset import PopulationDataset

DEFAULT_LADDER = (256, 512, 1024, 1536, 2048, 3072, 4096)


def _ordered_map(
    fn: Callable, seq: Iterable, num_workers: int, window: int
) -> Iterator:
    """``map(fn, seq)`` with a pool of worker threads, yielding results in
    input order via a sliding window of at most ``window`` in-flight items.

    The counterpart of the reference's ``DataLoader(num_workers=N)``
    process pool (run_train.py:431): threads suffice because the native
    GeoTIFF reader does its tile decode in C++ (zlib inflate releases the
    GIL) and is safe for concurrent reads on one handle (per-handle IO
    mutex, io/native/geotiff.cpp). Order preservation keeps the batch
    stream bit-identical for every worker count.
    """
    if num_workers <= 1:
        for x in seq:
            yield fn(x)
        return
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        futs: deque = deque()
        it = iter(seq)
        for x in itertools.islice(it, max(window, num_workers)):
            futs.append(ex.submit(fn, x))
        for x in it:
            nxt = futs.popleft()
            futs.append(ex.submit(fn, x))
            yield nxt.result()
        while futs:
            yield futs.popleft().result()


def _item_rng(seed: int, epoch: int, j: int) -> np.random.Generator:
    """Per-sample RNG derived from (seed, epoch, position): sample draws
    (season, orbit, NaN healing) no longer thread one sequential stream, so
    the stream is identical for any ``num_workers``."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, int(j)]))


def _batch_rng(seed: int, epoch: int, b: int) -> np.random.Generator:
    """Per-batch RNG (geometric/photometric draws); the extra trailing 1
    keeps it on a different SeedSequence stream than _item_rng."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, int(b), 1]))


def bucket_dim(n: int, ladder: Sequence[int] = DEFAULT_LADDER) -> int:
    for v in ladder:
        if n <= v:
            return v
    return ((n + 1023) // 1024) * 1024


def pad_item_to(
    item: Dict, h: int, w: int
) -> Dict:
    """Pad one item's arrays to (h, w): images with 0, admin mask with -1
    (reference collate, PopulationDataset.py:896-939)."""
    out = dict(item)
    for key in ("S2", "S1", "VIIRS"):
        if key in item:
            a = item[key]
            out[key] = np.pad(
                a, ((0, h - a.shape[0]), (0, w - a.shape[1]), (0, 0))
            )
    for key in ("building_counts", "building_segmentation"):
        if key in item:
            a = item[key]
            out[key] = np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])))
    if "admin_mask" in item:
        a = item["admin_mask"]
        out["admin_mask"] = np.pad(
            a,
            ((0, h - a.shape[0]), (0, w - a.shape[1])),
            constant_values=-1.0,
        )
    return out


# Modalities the transport rule applies to: the normalized image inputs
# (their z-score runs on device AFTER the upcast, so transport precision
# only touches raw sensor values). Masks/counts/targets always ride exact.
TRANSPORT_KEYS = ("S2", "S1", "VIIRS")


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> the bit patterns of bfloat16, as np.uint16: rounded to
    nearest even, and a NaN kept as the quiet NaN of its sign (0x7FC0 or
    0xFFC0), as the ``ml_dtypes`` cast of the JAX package rounds."""
    a = np.ascontiguousarray(a, np.float32)
    b = a.view(np.uint32)
    # uint32 wraps only for NaN patterns, which are replaced below
    out = ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out[nan] = ((b[nan] >> 16) & 0x8000).astype(np.uint16) | np.uint16(0x7FC0)
    return out


def to_bfloat16(a: np.ndarray) -> torch.Tensor:
    """A float32 array as a CPU torch.bfloat16 tensor (``bf16_bits``)."""
    return torch.from_numpy(bf16_bits(a).view(np.int16)).view(torch.bfloat16)


def host_tensor(a) -> torch.Tensor:
    """A host array as the CPU tensor that is uploaded: a uint16 array
    (lossless S2) as its int16 bit view, since torch's uint16 support on
    CUDA is partial (``widen_u16`` restores the values on the device); a
    tensor (bf16 transport) as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def widen_u16(t: torch.Tensor) -> torch.Tensor:
    """The int16 bit view of uint16 values -> their int32 values."""
    return t.to(torch.int32).bitwise_and_(0xFFFF)


def transport_cast(batch: Dict, transport: str) -> Dict:
    """Apply the data-plane ``transport`` rule to an assembled batch/dict.

    "exact" (default): float modalities ship as float32 (plus the
    lossless-uint16 S2 rule) — bit-parity with the reference's data
    plane. "bf16": float32 image modalities ship as bfloat16 — HALF the
    host->device bytes and device residency for S1 (S2 already rides 2-byte
    uint16 when lossless), held on the host as CPU torch.bfloat16 tensors
    (``to_bfloat16``). Opt-in and lossy (~3 significant digits on
    raw sensor values, BEFORE normalization); census-level accuracy is
    pinned by tests/test_transport.py. Geometric augmentations are index
    permutations, so they commute with the cast and host/device feed
    parity is preserved per mode."""
    if transport == "bf16":
        for key in TRANSPORT_KEYS:
            a = batch.get(key)
            if isinstance(a, np.ndarray) and a.dtype == np.float32:
                batch[key] = to_bfloat16(a)
    elif transport != "exact":
        raise ValueError(f"unknown transport {transport!r}")
    return batch


class WeaksupFeed:
    """Batched, bucketed, augmented feed over one or more weaksup datasets
    (the ConcatDataset + DataLoader + transform stack of run_train.py:423-431).
    """

    def __init__(
        self,
        datasets: Sequence[PopulationDataset],
        *,
        batch_size: int = 2,
        bucket_ladder: Sequence[int] = DEFAULT_LADDER,
        seed: int = 1600,
        augment: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        building_input: bool = False,
        segmentation_input: bool = False,
        max_samples: Optional[int] = None,
        num_workers: int = 1,
        transport: str = "exact",
    ):
        if transport not in ("exact", "bf16"):
            raise ValueError(f"unknown transport {transport!r}")
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.ladder = tuple(bucket_ladder)
        self.seed = seed
        self.augment = augment
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.building_input = building_input
        self.segmentation_input = segmentation_input
        self.max_samples = max_samples
        self.transport = transport
        self.index: List[Tuple[int, int]] = [
            (d, i) for d, ds in enumerate(self.datasets) for i in range(len(ds))
        ]

    def __len__(self) -> int:
        return len(self.index) // self.batch_size

    def _make_batch(self, items: List[Dict], rng: np.random.Generator) -> Dict:
        h = max(it["admin_mask"].shape[0] for it in items)
        w = max(it["admin_mask"].shape[1] for it in items)
        bh, bw = bucket_dim(h, self.ladder), bucket_dim(w, self.ladder)
        items = [pad_item_to(it, bh, bw) for it in items]
        batch: Dict = {}
        for key in ("S2", "S1", "VIIRS"):
            if key in items[0]:
                arr = np.stack([it[key] for it in items]).astype(np.float32)
                if key == "S2":
                    # uint16 over the wire when lossless (see InferenceFeed;
                    # geometric augs are index permutations, so they commute
                    # with the integer representation; the photometric aug
                    # runs on device after the f32 upcast)
                    u16 = arr.astype(np.uint16)
                    if np.array_equal(u16, arr):
                        arr = u16
                batch[key] = arr
        for key in ("building_counts", "building_segmentation"):
            if key in items[0]:
                batch[key] = np.stack([it[key] for it in items]).astype(np.float32)
        batch["admin_mask"] = np.stack([it["admin_mask"] for it in items]).astype(
            np.float32
        )
        # -binp/-sinp segmentation policy (reference utils/utils.py:153-159):
        # with both flags, derive the segmentation from counts when absent;
        # without -sinp, drop any segmentation raster.
        if self.building_input and self.segmentation_input:
            if "building_segmentation" not in batch and "building_counts" in batch:
                batch["building_segmentation"] = (
                    batch["building_counts"] > 0.5
                ).astype(np.float32)
        elif not self.segmentation_input:
            batch.pop("building_segmentation", None)
        batch["y"] = np.asarray([it["y"] for it in items], np.float32)
        batch["census_idx"] = np.asarray(
            [it["census_idx"] for it in items], np.float32
        )
        batch["season"] = np.asarray([it["season"] for it in items], np.int32)

        if self.augment:
            g = draw_general(rng)
            for key in ("S2", "S1", "VIIRS", "building_counts", "building_segmentation"):
                if key in batch:
                    batch[key] = np.ascontiguousarray(
                        apply_geometric(batch[key], g, hw_axes=(1, 2))
                    )
            batch["admin_mask"] = np.ascontiguousarray(
                apply_geometric(batch["admin_mask"], g, hw_axes=(1, 2))
            )
            p = draw_photometric(rng)
            batch["photometric"] = np.asarray(
                [float(p.apply_brightness), p.beta, float(p.apply_gamma), p.gamma],
                np.float32,
            )
        else:
            batch["photometric"] = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
        return transport_cast(batch, self.transport)

    # hooks overridden by DeviceWeaksupFeed (data/device_weaksup.py): item
    # fetch and the (h, w) used for bucket grouping
    def _fetch_item(self, j: int, epoch: int) -> Optional[Dict]:
        d, i = self.index[j]
        try:
            return self.datasets[d].get_admin_item(i, _item_rng(self.seed, epoch, j))
        except ValueError:
            return None  # unhealable sample ("No data here!"), skip

    def _item_hw(self, item: Dict) -> Tuple[int, int]:
        return item["admin_mask"].shape

    def _epoch_batches(self, epoch: int) -> Iterator[Dict]:
        rng = np.random.default_rng(self.seed + 1000 * epoch)
        order = rng.permutation(len(self.index))
        if self.max_samples is not None:
            # -ms epoch sample cap (reference arguments/train.py:58)
            order = order[: self.max_samples]

        items_in_order = _ordered_map(
            lambda j: self._fetch_item(j, epoch), order, self.num_workers,
            window=self.num_workers + max(2, self.prefetch),
        )
        # group by bucket shape so batch members share a static shape
        pending: Dict[Tuple[int, int], List[Dict]] = {}
        nb = 0
        for item in items_in_order:
            if item is None:
                continue
            h, w = self._item_hw(item)
            key = (bucket_dim(h, self.ladder), bucket_dim(w, self.ladder))
            pending.setdefault(key, []).append(item)
            if len(pending[key]) == self.batch_size:
                yield self._make_batch(
                    pending.pop(key), _batch_rng(self.seed, epoch, nb)
                )
                nb += 1
        if not self.drop_last:
            for items in pending.values():
                if items:
                    yield self._make_batch(items, _batch_rng(self.seed, epoch, nb))
                    nb += 1

    def epoch(self, epoch: int) -> Iterator[Dict]:
        """Iterate one epoch with background prefetch. The caller's wait
        for each batch is the span ``feed.batch`` (utils/profiling.py),
        on the caller's thread and not the prefetch thread's."""
        if self.prefetch <= 0:
            it = self._epoch_batches(epoch)
            while True:
                with span("feed.batch"):
                    b = next(it, None)
                if b is None:
                    return
                yield b
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        err: List[BaseException] = []

        def worker():
            try:
                for b in self._epoch_batches(epoch):
                    q.put(b)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            with span("feed.batch"):
                b = q.get()
            if b is done:
                break
            yield b
        t.join()
        if err:
            raise err[0]


class InferenceFeed:
    """Batched feed over a test dataset's sliding-window patch grid, with
    background prefetch (run_eval.py's DataLoader, batch of patches)."""

    def __init__(
        self,
        dataset: PopulationDataset,
        *,
        batch_size: int = 1,
        prefetch: int = 2,
        num_workers: int = 1,
        indices=None,
        transport: str = "exact",
    ):
        if transport not in ("exact", "bf16"):
            raise ValueError(f"unknown transport {transport!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.transport = transport
        # optional subset of patch indices to serve (used by the
        # device-resident mosaic feed's partial fallback, infer/device_feed)
        self.indices = list(range(len(dataset))) if indices is None else list(indices)

    def __len__(self) -> int:
        n = len(self.indices)
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Dict]:
        n = len(self.indices)
        fetched = _ordered_map(
            self.dataset.get_test_item, self.indices, self.num_workers,
            window=self.num_workers + max(2, self.prefetch) * self.batch_size,
        )
        for s in range(0, n, self.batch_size):
            k = min(n, s + self.batch_size) - s
            items = [next(fetched) for _ in range(k)]
            npad = self.batch_size - len(items)
            batch: Dict = {}
            for key in ("S2", "S1", "VIIRS", "building_counts"):
                if key in items[0]:
                    arr = np.stack([it[key] for it in items]).astype(np.float32)
                    if key == "S2":
                        # S2 mosaics are stored uint16 (MPC: uint16+LZW,
                        # reference README.md:245); the reader upcasts to
                        # f32. When the roundtrip is lossless, ship uint16
                        # to the device — HALF the bytes of the biggest
                        # transfer — and let the normalize jit upcast
                        # (fused into the subtract/divide). Float-sourced
                        # or NaN-healed patches fail the check and stay
                        # f32. Runs in the prefetch worker thread.
                        u16 = arr.astype(np.uint16)
                        if np.array_equal(u16, arr):
                            arr = u16
                    if npad:
                        arr = np.concatenate([arr, np.repeat(arr[-1:], npad, 0)], 0)
                    batch[key] = arr
            batch["mask"] = np.stack(
                [it["mask"] for it in items]
                + [np.zeros_like(items[0]["mask"])] * npad
            )
            batch["img_coords"] = np.asarray(
                [it["img_coords"] for it in items]
                + [items[-1]["img_coords"]] * npad,
                np.int64,
            )
            batch["valid"] = np.asarray([True] * len(items) + [False] * npad)
            batch["season"] = np.asarray(
                [it["season"] for it in items] + [items[-1]["season"]] * npad, np.int32
            )
            yield transport_cast(batch, self.transport)

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        err: List[BaseException] = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is done:
                break
            yield b
        t.join()
        if err:
            raise err[0]

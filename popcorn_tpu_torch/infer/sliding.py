"""Country-scale sliding-window inference with ensemble stitching.

Counterpart of popcorn_tpu/infer/sliding.py (reference run_eval.py:71-203).
Patches come from the device-resident season mosaics
(``_run_device_feed_pass``, infer/device_feed.py) where the stitch is on
the device, else from the host InferenceFeed:

  * per patch, ``prep`` normalizes the input and computes the frozen
    building score ONCE (the reference recomputes it inside every member);
  * ``members`` folds the Bag-of-POPCORN members in member order into
    sum and sum-of-squares maps of the population density and the
    occupancy scale, then multiplies them by the halo-validity mask;
  * the patch maps are added in place into country-scale accumulators,
    and one finalize computes the visit-count mean and the std
    sqrt((sum_sq - n*mean^2)/(n-1)) (run_eval.py:137-154), including the
    reference's count > 1 divide-mask quirk. The accumulators stay on the
    device while their five float32 maps fit _DEVICE_STITCH_BUDGET_BYTES,
    the JAX package's budget; above it (a country the size of Uganda, 2.4e9
    pixels at 10 m) each patch's maps come to the host and are added
    there, with an int32 visit count, as the JAX package's host stitch
    does (popcorn_tpu/infer/sliding.py:482-532, 934-940).

Ranks (``mesh``, dist/mesh.py): the patches split over the 'data' ranks
(rank d takes every n_data-th patch) and the members over the 'ensemble'
ranks (rank e takes members e*m .. e*m+m-1 of ceil(n/n_ensemble) = m;
slots past the last member, the JAX package's padded slots, hold none).
Each rank folds its (patch, member) pairs into its own accumulators, and
rank 0 sums them (one reduce a map) and finalizes; the other ranks return
None. The sums add the same terms as one device's, in another order.

Quantized eval: with ``quantize`` int8s/w4a8 each member's static int8
scales are calibrated once, on the first patch batch of the region, and
kept for the rest of it (popcorn_tpu/infer/sliding.py:374-416); with
'int8' and ``pallas_stream=True`` the builder runs the dynamic int8
kernels too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data.dataset import PopulationDataset
from ..data.feed import InferenceFeed, host_tensor, widen_u16
from ..data.normalize import NormStats, normalize_and_assemble
from ..dist.mesh import resolve_device
from ..nn.popcorn import (
    builder_quantized,
    calibrate_member_scales,
    check_config,
    compute_dtype,
    create_building_score,
    fold_unpadded,
    popcorn_predict,
    quantize_static_int8,
)

Tree = Dict[str, Any]

_ACC_KEYS = ("dense_sum", "dense_sq", "scale_sum", "scale_sq", "count")
_PREP_KEYS = ("S2", "S1", "VIIRS", "building_counts")
# the five float32 country-scale maps stay on the device below this many
# bytes (popcorn_tpu/infer/sliding.py:537-538)
_DEVICE_STITCH_BUDGET_BYTES = 6e9


def make_patch_forward(mcfg: ModelConfig, consts: Tree, stats: NormStats, n_members: int):
    """Ensemble patch forward: fn(members, batch) -> dict of (B,H,W) float32
    maps — dense/scale sums and sums of squares over members and the visit
    count, all multiplied by the validity mask so the caller only adds."""
    import dataclasses

    check_config(mcfg)
    mcfg_member = dataclasses.replace(mcfg, sentinel_buildings=False)
    needs_counts = mcfg.occupancy_model and not mcfg.sentinel_buildings

    def prep(batch):
        """Normalize + building score, once per patch batch."""
        sample = {}
        if mcfg.s2 and "S2" in batch:
            sample["S2"] = batch["S2"]  # integer S2 upcasts inside normalize
        if mcfg.s1 and "S1" in batch:
            sample["S1"] = batch["S1"]
        if mcfg.viirs and "VIIRS" in batch:
            sample["VIIRS"] = batch["VIIRS"]
        x = normalize_and_assemble(sample, stats)
        if mcfg.sentinel_buildings or not mcfg.occupancy_model:
            score = create_building_score(
                consts["builder"], x, s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir,
                quantize=builder_quantized(mcfg), dtype=compute_dtype(mcfg),
            )
        else:
            score = batch["building_counts"]
        return x, score

    # static int8: the members' scales, calibrated on the first batch the
    # fold sees (None where the static path does not apply: one stream, or
    # a patch whose sides are not multiples of 4)
    static_q = quantize_static_int8(mcfg) and mcfg.s1 and mcfg.s2
    calibrated: Dict[str, Any] = {}

    def member_scales(member_params, x):
        if not static_q:
            return [None] * len(member_params)
        if "scales" not in calibrated:
            ok = x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0
            calibrated["scales"] = [
                calibrate_member_scales(p, consts, x, mcfg_member) if ok else None
                for p in member_params
            ]
        return calibrated["scales"]

    def members(member_params, x, score, mask, valid):
        """The member fold (popcorn_tpu/infer/sliding.py:175-246): members
        in order, float32 sums, then the mask multiply. Each member runs
        on the unpadded patch where the JAX fold does (its packed fold:
        both streams, even sides), and pads by the reference's rule
        elsewhere (its plain fold)."""
        m = mask.float() * valid.float()[:, None, None]
        zeros = torch.zeros(score.shape[:3], dtype=torch.float32, device=x.device)
        ds, dsq, ss, ssq = (zeros.clone() for _ in range(4))
        inputs = {"input": x, "building_counts": score}
        padding = None if fold_unpadded(mcfg_member, x.shape[1], x.shape[2]) else False
        for params, scales in zip(member_params, member_scales(member_params, x)):
            out = popcorn_predict(params, consts, inputs, mcfg_member, padding=padding, scales=scales)
            dense = out["popdensemap"].float()
            scale = out["scale"]
            scale = torch.zeros_like(dense) if scale is None else scale.float()
            ds += dense
            dsq += dense * dense
            ss += scale
            ssq += scale * scale
        return {
            "dense_sum": ds * m,
            "dense_sq": dsq * m,
            "scale_sum": ss * m,
            "scale_sq": ssq * m,
            "count": m * n_members,
        }

    @torch.no_grad()
    def fn(member_params, batch):
        if needs_counts and "building_counts" not in batch:
            raise ValueError(
                "occupancy model without sentinel buildings (-occmodel without "
                "-senbuilds) requires 'building_counts' in every batch: open "
                "the dataset with sentinelbuildings=False, or pass -senbuilds."
            )
        x, score = prep({k: batch[k] for k in _PREP_KEYS if k in batch})
        return members(member_params, x, score, batch["mask"], batch["valid"])

    @torch.no_grad()
    def calibrate(member_params, batch):
        """Calibrate the static int8 scales on ``batch`` before the fold
        sees another patch first (a no-op otherwise)."""
        if static_q and "scales" not in calibrated:
            member_scales(member_params, prep({k: batch[k] for k in _PREP_KEYS if k in batch})[0])

    fn.static_int8 = static_q
    fn.calibrate = calibrate
    return fn


class StitchAccumulators:
    """Country-scale accumulators, patch maps added in place: on a device
    (the JAX package's device-resident stitch, sliding.py:541, a float32
    count), or on the host (its StitchAccumulators, sliding.py:482, an int32
    count; each patch's maps are fetched to the host first)."""

    def __init__(self, shape: Tuple[int, int], device, host: bool = False):
        h, w = shape
        dev = "cpu" if host else device
        self.accs = {k: torch.zeros((h, w), dtype=torch.float32, device=dev) for k in _ACC_KEYS}
        if host:
            self.accs["count"] = torch.zeros((h, w), dtype=torch.int32)

    def add(self, x: int, y: int, res: Dict[str, torch.Tensor], b: int) -> None:
        ph, pw = res["dense_sum"].shape[-2:]
        for k, acc in self.accs.items():
            acc[x : x + ph, y : y + pw] += res[k][b].to(acc.dtype)

    def finalize(self) -> Dict[str, torch.Tensor]:
        return finalize_maps(self.accs)


def finalize_maps(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Visit-count averaging + sum-of-squares std (run_eval.py:137-154) of
    the five accumulators, on their device.

    Reproduces the reference's div_mask = count > 1: pixels visited once
    keep their raw sum and get std 0. The whole-frame path
    (infer/spatial.py) passes its member x season count as a constant map."""
    cnt_i = a["count"].to(torch.int32)
    cnt = cnt_i.float()
    div = cnt_i > 1
    safe = torch.where(div, cnt, torch.ones_like(cnt))
    out = {"count": cnt_i}
    for src, sq, mean_k, std_k in (
        ("dense_sum", "dense_sq", "map", "map_std"),
        ("scale_sum", "scale_sq", "scale", "scale_std"),
    ):
        mean = torch.where(div, a[src] / safe, a[src])
        var = torch.where(
            div,
            (a[sq] - mean**2 * cnt) / torch.clamp(cnt - 1.0, min=1.0),
            torch.zeros_like(cnt),
        )
        out[mean_k] = mean
        out[std_k] = torch.sqrt(torch.clamp(var, min=0.0))
    return out


def _upload(
    batch: Dict[str, Any], device: torch.device,
    keys: Sequence[str] = ("S2", "S1", "VIIRS", "building_counts", "mask", "valid"),
) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors of ``keys`` (pinned and asynchronous
    on CUDA). Tensors already on ``device`` (the device-resident feeds'
    batches) pass through untouched.

    uint16 arrays (lossless S2) travel as their 2 bytes, reinterpreted as
    int16, and widen to int32 on the device: torch's uint16 support is
    partial on CUDA. bf16-transport values (CPU torch.bfloat16 tensors)
    travel as they are."""
    out = {}
    for k in keys:
        if k not in batch:
            continue
        a = batch[k]
        if isinstance(a, torch.Tensor) and a.device.type == device.type:
            out[k] = a
            continue
        u16 = isinstance(a, np.ndarray) and a.dtype == np.uint16
        t = host_tensor(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = widen_u16(t) if u16 else t
    return out


def stitch_on_host(device_stitch: str, shape: Tuple[int, int]) -> bool:
    """Whether the stitch runs on the host: ``device_stitch`` "host", or
    "auto" with the five float32 accumulators of a region of ``shape`` not
    under _DEVICE_STITCH_BUDGET_BYTES."""
    if device_stitch not in ("auto", "host", "device"):
        raise ValueError(f"device_stitch={device_stitch!r}: 'auto', 'host' or 'device'")
    h, w = shape
    return device_stitch == "host" or (
        device_stitch == "auto" and h * w * 4 * len(_ACC_KEYS) >= _DEVICE_STITCH_BUDGET_BYTES
    )


def _run_device_feed_pass(
    dataset: PopulationDataset,
    fwd,
    member_params,
    acc: StitchAccumulators,
    dev: torch.device,
    *,
    timings: Optional[Dict[str, float]],
    progress: bool,
    transport: str,
    debug_nans: bool,
):
    """Run the sliding window from device-resident season mosaics
    (popcorn_tpu/infer/sliding.py::_run_device_feed_pass), patches in the
    host feed's order, one a forward (the host feed's batch of 1).

    Returns (remaining, n_seen): the sorted indices into
    dataset.patch_indices that still need the host feed (patches whose
    window overlaps a NaN tile take the reference's per-patch healing,
    PopulationDataset.py:418-441, a host-side repair), and the number of
    patches visited here.

    Three stages a season: host assembly of season s+1 (season_arrays; on
    a thread when the host has more than two cores, else inline while the
    upload runs), the upload of season s (one worker, pinned memory, on a
    side CUDA stream), and the compute on the main stream, which waits for
    the upload's event before its first crop. ``timings``: 'feed_wait_s'
    and 'upload_s' count only the main thread's blocked time; 'read_span_s'
    and 'upload_span_s' are the stages' own spans, wherever they ran;
    'warmup_s' is the first patch's wall, drained; 'dispatch_s' the rest
    of the crop/forward/stitch issue; 'n_device_patches' the patches
    cropped on the device.
    """
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ..data.dataset import validity_mask
    from ..data.device_weaksup import _window_has_nan
    from .device_feed import make_device_crop, season_arrays

    p = dataset.patchsize
    coords = np.asarray(dataset.patch_indices)
    order = list(dict.fromkeys(int(s) for s in coords[:, 2]))
    by_season = {s: np.nonzero(coords[:, 2] == s)[0] for s in order}
    crop = make_device_crop(p)
    mask = torch.from_numpy(validity_mask(p, p, dataset.overlap)[None]).to(dev)
    valid = torch.ones((1,), dtype=torch.bool, device=dev)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None
    main = torch.cuda.current_stream(dev) if cuda else None
    overlap = (os.cpu_count() or 1) > 2
    t = timings if timings is not None else {}
    for k in ("feed_wait_s", "upload_s", "dispatch_s", "read_span_s", "upload_span_s", "warmup_s"):
        t.setdefault(k, 0.0)
    t.setdefault("n_device_patches", 0)

    holder: Dict = {}

    def assemble(s):
        t0 = time.perf_counter()
        holder[s] = season_arrays(dataset, s, transport=transport)
        holder[f"t{s}"] = time.perf_counter() - t0

    def upload(mos_host):
        t0 = time.perf_counter()
        if not cuda:
            return {k: host_tensor(a) for k, a in mos_host.items()}, None, time.perf_counter() - t0
        with torch.cuda.stream(side):
            mos = {k: host_tensor(a).pin_memory().to(dev, non_blocking=True)
                   for k, a in mos_host.items()}
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        return mos, done, time.perf_counter() - t0

    bar = None
    if progress:
        from tqdm import tqdm

        bar = tqdm(total=len(coords), leave=False, desc="device-feed")
    remaining: list = []
    n_seen = 0
    first_visit = True
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="season-upload")
    try:
        assemble(order[0])
        for si, s in enumerate(order):
            if s not in holder:
                # pipeline bubble: this season's assembly did not finish
                # ahead of time (its thread failed, or serial mode)
                assemble(s)
            mos_host, nan_q = holder.pop(s)
            t_asm = holder.pop(f"t{s}")
            t["read_span_s"] += t_asm
            if si == 0 or not overlap:
                t["feed_wait_s"] += t_asm
            idxs = [int(i) for i in by_season[s]]
            if nan_q:
                # tile-level hybrid: only patches whose window overlaps a
                # NaN tile need the host feed's healing; filter BEFORE the
                # upload so a season with no clean patch never uploads
                clean = []
                for i in idxs:
                    x, y = int(coords[i][0]), int(coords[i][1])
                    if any(_window_has_nan(q, x, y, p, p) for q in nan_q.values()):
                        remaining.append(i)
                        if bar is not None:
                            bar.update(1)
                    else:
                        clean.append(i)
                idxs = clean
            if si == 0 and remaining and remaining[0] == 0 and fwd.static_int8:
                # the host feed's first patch calibrates static int8: heal
                # and calibrate on it here too, before any device crop
                first = next(iter(InferenceFeed(dataset, indices=[0], prefetch=0,
                                                transport=transport)))
                fwd.calibrate(member_params, _upload(first, dev))
            fut = pool.submit(upload, mos_host) if idxs else None
            del mos_host
            th = None
            if si + 1 < len(order):
                if overlap:
                    th = threading.Thread(target=assemble, args=(order[si + 1],))
                    th.start()
                else:
                    assemble(order[si + 1])
            if fut is not None:
                t0 = time.perf_counter()
                mos, done, t_up = fut.result()
                if cuda:
                    main.wait_event(done)
                    for v in mos.values():
                        # allocated on the side stream, read on this one
                        v.record_stream(main)
                t["upload_s"] += time.perf_counter() - t0
                t["upload_span_s"] += t_up
                t0 = time.perf_counter()
                warm = 0.0
                for i in idxs:
                    t_fv = time.perf_counter()
                    x, y = int(coords[i][0]), int(coords[i][1])
                    batch = crop(mos, x, y)
                    batch["mask"] = mask
                    batch["valid"] = valid
                    res = fwd(member_params, batch)
                    if debug_nans and any(bool(torch.isnan(res[k]).any()) for k in ("dense_sum", "scale_sum")):
                        raise FloatingPointError(
                            f"NaN in the member outputs of patch {n_seen} (img_coords {x}, {y})"
                        )
                    acc.add(x, y, res, 0)
                    if first_visit:
                        # drain the first visit and book its whole wall
                        # (first-call costs and the first run) as warmup
                        if cuda:
                            torch.cuda.synchronize(dev)
                        warm = t["warmup_s"] = time.perf_counter() - t_fv
                        first_visit = False
                    n_seen += 1
                    t["n_device_patches"] += 1
                    if bar is not None:
                        bar.update(1)
                t["dispatch_s"] += time.perf_counter() - t0 - warm
                del mos
            if th is not None:
                th.join()
    finally:
        pool.shutdown(wait=True)
        if bar is not None:
            bar.close()
    return sorted(remaining), n_seen


def run_sliding_inference(
    members: Sequence[Tree],
    consts: Tree,
    mcfg: ModelConfig,
    dataset: PopulationDataset,
    *,
    stats: Optional[NormStats] = None,
    batch_size: int = 1,
    progress: bool = False,
    num_workers: int = 1,
    device="cuda",
    device_stitch: str = "auto",
    device_feed: str = "auto",
    transport: str = "exact",
    return_device: bool = False,
    timings: Optional[Dict[str, float]] = None,
    debug_nans: bool = False,
    mesh=None,
) -> Optional[Dict[str, Any]]:
    """Full-region ensemble inference -> stitched mean/std maps.

    members/consts: parameter trees of torch tensors (moved to ``device``).

    device_stitch: "auto" keeps the five accumulators on the device while
    they fit _DEVICE_STITCH_BUDGET_BYTES, else stitches on the host;
    "host"/"device" force the mode (popcorn_tpu/infer/sliding.py:934-940).
    The forward runs on ``device`` either way.

    device_feed: "auto" uploads each season's mosaics to the device once
    and crops the patches there (``_run_device_feed_pass``) whenever the
    stitch is on the device, the dataset is in test mode and has a patch
    size; "on" forces it (and raises with a host stitch), "off" takes the
    host InferenceFeed, whose batches are uploaded one batch ahead of the
    forward that uses them. Patches that need the reference's NaN healing
    take the host feed after the device pass. The device feed's batch is
    1 patch (there is no host round trip to amortise); at batch 1 both
    feeds give bit-equal maps.

    transport: "exact" or "bf16", the data plane's dtype for the float
    image modalities (data/feed.py::transport_cast).

    return_device: return the finalized maps of a device stitch as device
    tensors (census aggregation runs on them there), else numpy arrays. A
    host stitch always returns numpy arrays, as the JAX package does.

    timings: optional dict filled with the wall-clock split of the run, the
    JAX package's keys: 'feed_wait_s' (host blocked obtaining the next
    patch batch or season mosaic: raster reads, assembly), 'upload_s'
    (host blocked on a season's upload, device feed only), 'dispatch_s'
    (issuing the forward and stitch work and the host stitch's fetches;
    device compute is asynchronous behind it), 'finalize_s' (finalize, the
    fetch of numpy maps, and the device's drain), 'total_s', 'n_patches'
    (valid patch visits); with the device feed also 'read_span_s',
    'upload_span_s', 'warmup_s' and 'n_device_patches'
    (``_run_device_feed_pass``).

    debug_nans: raise FloatingPointError at the first patch whose member
    outputs hold a NaN, naming it (what jax_debug_nans stops the JAX
    eval on).

    mesh: this rank's place among the ranks that share the eval (module
    docstring); ``device`` is then the mesh's. Under more than one rank
    the device feed is off (``device_feed='on'`` raises) and static int8
    takes the dynamic kernels, as in the JAX package; rank 0 returns the
    maps, the others None.
    """
    import dataclasses

    from ..compat.weights import to_torch

    if device_feed not in ("auto", "on", "off"):
        raise ValueError(f"device_feed={device_feed!r}: 'auto', 'on' or 'off'")
    ranked = mesh is not None and mesh.size > 1
    if ranked and device_feed == "on":
        raise ValueError(
            "device_feed='on' requires a single-process run with device-resident "
            "stitch accumulators (mesh=None); use device_feed='auto'"
        )
    dev = mesh.device if mesh is not None else resolve_device(device)
    host = stitch_on_host(device_stitch, dataset.shape())
    if device_feed == "on" and host:
        raise ValueError(
            "device_feed='on' requires device-resident stitch accumulators "
            "(the region under the device-stitch budget); use device_feed='auto'"
        )
    dev_feed = not host and not ranked and (
        device_feed == "on"
        or (device_feed == "auto" and dataset.mode == "test" and bool(dataset.patchsize))
    )
    indices = None  # every patch
    members = list(members)
    if ranked:
        if quantize_static_int8(mcfg):
            # popcorn_tpu/infer/sliding.py:381-383: mesh-sharded folds keep
            # the dynamic int8 kernels (the calibrated scales do not
            # thread through the sharded fold)
            mcfg = dataclasses.replace(mcfg, quantize="int8")
        per = -(-len(members) // mesh.n_ensemble)
        members = members[mesh.ensemble_index * per:(mesh.ensemble_index + 1) * per]
        indices = list(range(len(dataset.patch_indices)))[mesh.data_index::mesh.n_data]
        if not members:
            indices = []
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    member_params = [to_torch(p, dev) for p in members]
    consts = to_torch(consts, dev)
    fwd = make_patch_forward(mcfg, consts, stats, len(members))
    acc = StitchAccumulators(dataset.shape(), dev, host=host)

    if timings is not None:
        for k in ("feed_wait_s", "upload_s", "dispatch_s", "finalize_s", "total_s"):
            timings.setdefault(k, 0.0)
        timings.setdefault("n_patches", 0)
    t_run0 = time.perf_counter()

    remaining, n_seen = indices, 0  # None: every patch through the host feed
    if dev_feed:
        remaining, n_seen = _run_device_feed_pass(
            dataset, fwd, member_params, acc, dev, timings=timings, progress=progress,
            transport=transport, debug_nans=debug_nans,
        )

    feed_wait = 0.0
    feed = InferenceFeed(dataset, batch_size=batch_size, prefetch=2, num_workers=num_workers,
                         indices=remaining, transport=transport)
    source = feed
    if progress and len(feed):
        from tqdm import tqdm

        source = tqdm(feed, total=len(feed), leave=False)
    src = iter(source)

    def next_batch():
        nonlocal feed_wait
        t0 = time.perf_counter()
        b = next(src, None)
        feed_wait += time.perf_counter() - t0
        return b

    # one-batch lookahead: the next batch is uploaded before the current
    # one's forward runs
    t_loop0 = time.perf_counter()
    cur = next_batch()
    cur_dev = _upload(cur, dev) if cur is not None else None
    while cur is not None:
        nxt = next_batch()
        nxt_dev = _upload(nxt, dev) if nxt is not None else None
        res = fwd(member_params, cur_dev)
        if host:
            res = {k: v.cpu() for k, v in res.items()}
        for b in range(len(cur["valid"])):
            if not cur["valid"][b]:
                continue
            x, y = (int(v) for v in cur["img_coords"][b])
            if debug_nans and any(bool(torch.isnan(res[k][b]).any()) for k in ("dense_sum", "scale_sum")):
                raise FloatingPointError(
                    f"NaN in the member outputs of patch {n_seen} (img_coords {x}, {y})"
                )
            acc.add(x, y, res, b)
            n_seen += 1
        cur, cur_dev = nxt, nxt_dev
    t_fin0 = time.perf_counter()
    if ranked:
        for a in acc.accs.values():
            mesh.reduce_to_root(a)
        if not mesh.is_root:
            return None
    maps = acc.finalize()
    if host or not return_device:
        maps = {k: v.cpu().numpy() for k, v in maps.items()}
    elif timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        t1 = time.perf_counter()
        timings["feed_wait_s"] += feed_wait
        timings["dispatch_s"] += (t_fin0 - t_loop0) - feed_wait
        timings["finalize_s"] += t1 - t_fin0
        timings["total_s"] += t1 - t_run0
        timings["n_patches"] += n_seen
    return maps

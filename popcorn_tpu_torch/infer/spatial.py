"""Whole-frame inference: a region's season, or a dated frame, as one map.

Counterpart of popcorn_tpu/infer/spatial.py. The stitched eval
(infer/sliding.py) runs 2048^2 patches that overlap by 128 px, computes
every overlap band twice and, by the reference's halo convention, leaves
the frame's outer ``overlap``-px ring with stitch count 0 and zero. The
whole-frame path computes the model once over the whole frame:

  * the true model output in the border ring (interiors agree with the
    stitched map to the patch stitch's halo bound);
  * no overlap recompute and no stitch.

How it runs here:

  * one rank: the whole frame (padded to a multiple of 4 rows and 32
    columns) is one tensor on the device; above ``_CHUNK_MIN_H`` rows the
    builder runs in strips of 512 rows, above ``_MEMBER_CHUNK_MIN_H`` the
    member fold runs in strips of ``_MEMBER_CHUNK_ROWS``, each strip with
    ``HALO`` rows of true context on each side, beyond the
    model's receptive field, so kept rows equal the whole-frame values to
    about 3e-7 (the bound the JAX package relies on for its own strips);
  * several ranks (dist/mesh.py): rows pad to a multiple of 4 x n_data
    and rank d computes its block of rows with two halos of context on
    each side, keeps its own rows, and the maps are gathered: the row
    geometry of dist/rows.py, which spatial training shares. Members split
    over the 'ensemble' ranks, whose sums add up.

Strip and block starts stay on multiples of 4 of the frame, and each
member window of the reference-padded frame (``add_padding(force=False)``,
applied only at the frame's true edges) starts on a multiple of 4, so the
two max-pools see the same grid as on the whole frame.

The JAX package's ``_spatial_cfg`` turns off its Pallas kernels, only
because a Pallas call has no SPMD sharding rule; a rank's tensors are
local, so here the builder and the members run kernels A and B and the
head kernel C, as the stitched eval does. ``quantize`` is dropped, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data.feed import transport_cast
from ..data.normalize import NormStats, normalize_and_assemble
from ..dist.mesh import Mesh, resolve_device
from ..dist.rows import HALO, Rows, member_window, rank_rows
from ..io.geotiff import has_nan
from ..nn.popcorn import check_config, compute_dtype, create_building_score, popcorn_predict
from .sliding import _upload, finalize_maps

Tree = Dict

_CHUNK_MIN_H = 3072  # from this height a single rank chunks the builder
_MEMBER_CHUNK_MIN_H = 5120  # from this height a single rank folds members
# in strips (the member fold's temporaries are about 256 B a pixel)
_MEMBER_CHUNK_ROWS = 2048  # kept rows a member strip
_ACC4 = ("dense_sum", "dense_sq", "scale_sum", "scale_sq")


def data_axis_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.n_data


def _spatial_cfg(mcfg: ModelConfig) -> ModelConfig:
    """The whole-frame config: the JAX package's ``_spatial_cfg`` keeps
    ``quantize=None``; its other changes (no Pallas kernels, the 'spatial'
    layout) answer SPMD sharding and TPU lane layout, which do not apply
    to a rank's local tensors, so the kernels stay on."""
    return dataclasses.replace(mcfg, quantize=None)


def _pad_frame(a: np.ndarray, mh: int, mw: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pad an HWC frame so H % mh == 0 and W % mw == 0.

    Edge replication keeps the padded band in-distribution for the UNet
    (zeros would bleed a false dark border through the 3x3 convs); the pad
    is cropped off the output, and callers sum the cropped map."""
    h, w = a.shape[:2]
    ph, pw = (-h) % mh, (-w) % mw
    if ph == 0 and pw == 0:
        return a, (0, 0)
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (a.ndim - 2)
    return np.pad(a, pad, mode="edge"), (ph, pw)


def _device(mesh: Optional[Mesh], device=None) -> torch.device:
    return resolve_device(mesh.device if mesh is not None else device or "cuda")


def _rows_on(sample: Dict, keys, rows: slice, dev) -> Dict[str, torch.Tensor]:
    """``rows`` of the frame's ``keys`` on ``dev``, through the eval's
    upload (infer/sliding.py::_upload: pinned, uint16 S2 as its int16 bits
    widened there)."""
    return _upload({k: sample[k][:, rows] for k in keys if k in sample}, torch.device(dev), keys)


def _inputs(sample: Dict, mcfg: ModelConfig, stats: NormStats, rows: slice, dev) -> torch.Tensor:
    """Normalized (B, h, W, C) model input of ``rows`` of the frame."""
    keys = [k for k, on in (("S2", mcfg.s2), ("S1", mcfg.s1), ("VIIRS", mcfg.viirs)) if on]
    return normalize_and_assemble(_rows_on(sample, keys, rows, dev), stats)


def _strips(rows: Rows, s: int):
    """The blocks of at most ``s`` kept rows (multiples of 4) of ``rows``."""
    s = max(4, s - s % 4)
    for k0 in range(rows.k0, rows.k1, s):
        yield Rows(rows.hp, k0, min(rows.k1, k0 + s))


def _gather_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(B, hb, W) blocks of every data rank -> (B, hp, W), in rank order."""
    if data_axis_size(mesh) == 1:
        return t
    return mesh.all_gather(t.transpose(0, 1).contiguous(), "data").transpose(0, 1)


def _score(builder: Tree, x: torch.Tensor, mcfg: ModelConfig, chunk: bool) -> torch.Tensor:
    dtype = compute_dtype(mcfg)
    if chunk:
        return chunked_building_score({"builder": builder}, x, mcfg, dtype)
    return create_building_score(builder, x, s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir, dtype=dtype)


def _member_block(params: Tree, consts: Tree, mcfg_member: ModelConfig, x_u: torch.Tensor,
                  score_u: torch.Tensor, rows: Rows, base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One member's (density, scale) over the kept rows of ``rows``, from
    ``x_u``/``score_u``: the frame's rows from ``base`` that hold
    [rows.u0, rows.u1), run unpadded on their window of the reference-padded
    frame (dist/rows.py::member_window)."""
    x, s, keep, cols = member_window(x_u, score_u, rows, base)
    out = popcorn_predict(params, consts, {"input": x, "building_counts": s}, mcfg_member,
                          padding=None)
    dense = out["popdensemap"][:, keep, cols].float()
    scale = out["scale"]
    scale = torch.zeros_like(dense) if scale is None else scale[:, keep, cols].float()
    return dense, scale


def chunked_building_score(consts: Tree, x: torch.Tensor, mcfg: ModelConfig, dtype,
                           rows_per_chunk: int = 512) -> torch.Tensor:
    """Row-chunked building score of a whole frame on one device
    (popcorn_tpu/infer/spatial.py::chunked_building_score): strips of
    ``rows_per_chunk`` kept rows, each computed on a window with
    ``HALO`` rows of true context on each side, beyond the
    builder's receptive field, so the kept rows equal the whole-frame
    builder to about 3e-7; at the true frame edges the window's edge is
    the frame's, which keeps the reference's reflect padding exactly."""
    b, h, w, _ = x.shape
    s = min(rows_per_chunk, max(4, h - 2 * HALO))
    while h % s:
        s -= 4
    win_h = min(s + 2 * HALO, h)
    out = torch.empty((b, h, w), dtype=torch.float32, device=x.device)
    for r0 in range(0, h, s):
        start = min(max(r0 - HALO, 0), h - win_h)
        score = create_building_score(consts["builder"], x[:, start:start + win_h], s1=mcfg.s1,
                                      s2=mcfg.s2, nir=mcfg.nir, dtype=dtype)
        out[:, r0:r0 + s] = score[:, r0 - start:r0 - start + s]
    return out


def make_spatial_builtup(consts: Tree, mcfg: ModelConfig, mesh: Optional[Mesh] = None,
                         stats: Optional[NormStats] = None, device=None):
    """fn(s2, s1) -> (B, H, W) built-up score of a whole frame: (B, H, W,
    C) inputs whose H is a multiple of 4 x n_data (every rank passes the
    same frame; each computes its rows and the map is gathered)."""
    from ..compat.weights import to_torch

    mcfg = _spatial_cfg(mcfg)
    dev = _device(mesh, device)
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    builder = to_torch(consts["builder"], dev)

    @torch.no_grad()
    def fn(s2, s1) -> torch.Tensor:
        rows = rank_rows(s2.shape[1], mesh)
        x = _inputs({"S2": s2, "S1": s1}, mcfg, stats, slice(rows.u0, rows.u1), dev)
        score = _score(builder, x, mcfg, False)
        return _gather_rows(score[:, rows.k0 - rows.u0:rows.k1 - rows.u0], mesh)

    return fn


def spatial_builtup_map(consts: Tree, mcfg: ModelConfig, s2: np.ndarray, s1: np.ndarray,
                        mesh: Optional[Mesh] = None, *, stats: Optional[NormStats] = None,
                        device=None, _fn=None) -> np.ndarray:
    """Whole-frame built-up probability of HWC inputs: rows padded to a
    multiple of 4 x n_data (each block stays 4-divisible through the two
    max-pools), columns to a multiple of 32, cropped after."""
    nd = data_axis_size(mesh)
    fn = _fn or make_spatial_builtup(consts, mcfg, mesh, stats, device)
    h, w = s2.shape[:2]
    s2p, _ = _pad_frame(s2, 4 * nd, 32)
    s1p, _ = _pad_frame(s1, 4 * nd, 32)
    return fn(s2p[None], s1p[None])[0, :h, :w].cpu().numpy()


def make_spatial_popcorn(params: Tree, consts: Tree, mcfg: ModelConfig,
                         mesh: Optional[Mesh] = None, stats: Optional[NormStats] = None,
                         device=None):
    """fn(params, s2, s1) -> (B, H, W) POPCORN density of a whole frame
    (inputs as ``make_spatial_builtup``'s). The popcount is not returned:
    a padded frame would count its pad band; callers sum the cropped map
    (``spatial_density_map``)."""
    from ..compat.weights import to_torch

    mcfg = _spatial_cfg(mcfg)
    mcfg_member = dataclasses.replace(mcfg, sentinel_buildings=False)
    dev = _device(mesh, device)
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    consts = to_torch(consts, dev)

    @torch.no_grad()
    def fn(p, s2, s1) -> torch.Tensor:
        rows = rank_rows(s2.shape[1], mesh)
        x = _inputs({"S2": s2, "S1": s1}, mcfg, stats, slice(rows.u0, rows.u1), dev)
        score = _score(consts["builder"], x, mcfg, False)
        dense, _ = _member_block(to_torch(p, dev), consts, mcfg_member, x, score, rows, rows.u0)
        return _gather_rows(dense, mesh)

    return fn


def spatial_density_map(params: Tree, consts: Tree, mcfg: ModelConfig, s2: np.ndarray,
                        s1: np.ndarray, mesh: Optional[Mesh] = None, *,
                        stats: Optional[NormStats] = None, device=None,
                        _fn=None) -> Tuple[np.ndarray, float]:
    """Whole-frame POPCORN density map of HWC inputs, cropped to their
    extent, and its sum (the popcount over the true frame, without the pad
    band)."""
    nd = data_axis_size(mesh)
    fn = _fn or make_spatial_popcorn(params, consts, mcfg, mesh, stats, device)
    h, w = s2.shape[:2]
    s2p, _ = _pad_frame(s2, 4 * nd, 32)
    s1p, _ = _pad_frame(s1, 4 * nd, 32)
    m = fn(params, s2p[None], s1p[None])[0, :h, :w].float().cpu().numpy()
    return m, float(m.sum())


def make_spatial_ensemble(mcfg: ModelConfig, consts: Tree, stats: Optional[NormStats],
                          n_members: int, n_ensemble: int = 1, mesh: Optional[Mesh] = None,
                          device=None, strip_rows: int = _MEMBER_CHUNK_ROWS):
    """The whole-frame ensemble fold of ONE season
    (popcorn_tpu/infer/spatial.py::make_spatial_ensemble).

    fn(members, sample, acc) -> acc with this rank's share of the season's
    per-member density/scale sums and sums of squares added: ``members``
    the ``n_members`` parameter trees (this rank folds its 'ensemble'
    share of them), ``sample`` the frame's (1, H, W, C) host arrays (every
    rank the same; H a multiple of 4 x n_data), ``acc`` the four
    (H / n_data, W) float32 maps of this rank's rows. The builder score is
    computed once; the members fold in order (the patch fold's math,
    infer/sliding.py). One rank folds frames of ``_MEMBER_CHUNK_MIN_H``
    rows and more in strips of ``strip_rows`` kept rows (``_strip_fold``)
    and chunks the builder from ``_CHUNK_MIN_H`` rows. The ranks' partial
    sums are summed by ``reduce_maps``."""
    from ..compat.weights import to_torch

    if n_ensemble > 1 and (mesh is None or mesh.n_ensemble != n_ensemble):
        raise ValueError("n_ensemble > 1 requires the mesh")
    mcfg_sp = _spatial_cfg(mcfg)
    mcfg_member = dataclasses.replace(mcfg_sp, sentinel_buildings=False)
    dev = _device(mesh, device)
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    consts = to_torch(consts, dev)
    per = -(-n_members // n_ensemble)
    e = 0 if mesh is None else mesh.ensemble_index
    single = data_axis_size(mesh) == 1

    def fold(local, x, score, rows: Rows, acc, base: int, r0: int):
        sums = None
        for p in local:
            d, s = _member_block(p, consts, mcfg_member, x, score, rows, base)
            t = (d, d * d, s, s * s)
            sums = t if sums is None else tuple(a + b for a, b in zip(sums, t))
        if sums is not None:
            for k, v in zip(_ACC4, sums):
                acc[k][rows.k0 - r0:rows.k1 - r0] += v[0]

    def _strip_fold(local, x, score, rows: Rows, acc, base: int):
        """Big frames on one device: the member fold over strips of
        ``strip_rows`` kept rows, each with its halos of true context, so
        the temporaries are a strip's, not the frame's."""
        for strip in _strips(rows, strip_rows):
            fold(local, x, score, strip, acc, base, rows.k0)

    @torch.no_grad()
    def fn(members: Sequence[Tree], sample: Dict, acc: Dict[str, torch.Tensor]):
        local = [to_torch(p, dev) for p in list(members)[e * per:(e + 1) * per]]
        hp = next(iter(sample.values())).shape[1]
        rows = rank_rows(hp, mesh)
        x = _inputs(sample, mcfg, stats, slice(rows.u0, rows.u1), dev)
        if mcfg.sentinel_buildings or not mcfg.occupancy_model:
            # one rank chunks the builder on big frames; a rank's block is
            # already 1/n of the frame
            score = _score(consts["builder"], x, mcfg_sp, single and hp >= _CHUNK_MIN_H)
        else:
            bc = _rows_on(sample, ("building_counts",), slice(rows.u0, rows.u1),
                          dev)["building_counts"].float()
            score = bc[..., 0] if bc.dim() == 4 else bc
        if single and hp >= _MEMBER_CHUNK_MIN_H:
            _strip_fold(local, x, score, rows, acc, rows.u0)
        else:
            fold(local, x, score, rows, acc, rows.u0, rows.k0)
        return acc

    return fn


def new_accumulators(hp: int, wp: int, mesh: Optional[Mesh] = None, device=None) -> Dict[str, torch.Tensor]:
    """The four zero maps of this rank's rows of an (hp, wp) frame."""
    dev = _device(mesh, device)
    return {k: torch.zeros((hp // data_axis_size(mesh), wp), dtype=torch.float32, device=dev)
            for k in _ACC4}


def reduce_maps(acc: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Every rank's partial sums -> the whole frame's (hp, wp) maps: summed
    over the 'ensemble' ranks, gathered over the 'data' ranks."""
    if mesh is None or mesh.size == 1:
        return acc
    out = {}
    for k, v in acc.items():
        mesh.all_reduce(v, "ensemble")
        out[k] = mesh.all_gather(v, "data")
    return out


def run_spatial_inference(
    members,
    consts: Tree,
    mcfg: ModelConfig,
    dataset,
    *,
    stats: Optional[NormStats] = None,
    mesh: Optional[Mesh] = None,
    device=None,
    progress: bool = False,
    transport: str = "exact",
    timings: Optional[Dict[str, float]] = None,
    return_device: bool = False,
) -> Optional[Dict]:
    """Whole-region ensemble inference, the stitch-free counterpart of
    sliding.run_sliding_inference (popcorn_tpu/infer/spatial.py::
    run_spatial_inference).

    Each season's mosaics are read once; NaN-bearing ones are healed
    whole-frame (the patch path heals per window; identical wherever a
    window holds the NaN's full interpolation neighbourhood), then the
    ``transport`` rule applies (data/feed.py::transport_cast); every member
    runs over the whole region (module docstring), and the mean/std maps
    finalize on the device from the exact member x season count
    (infer/sliding.py::finalize_maps, the stitched path's). Against the
    stitched path the frame's outer overlap ring holds true model output
    (the stitched path zeroes it, the reference's convention).

    Returns on rank 0 (the others: None) the stitched path's dict: map,
    map_std, scale, scale_std, count, cropped to the region: numpy, or
    with ``return_device`` tensors on the device (the Evaluator's census
    then runs there, as after a device stitch).

    timings: optional dict filled with the wall split: 'feed_wait_s' (the
    seasons' host reads, healing and padding), 'fold_s' (uploads and the
    folds, drained), 'finalize_s' (the ranks' reduction, the mean/std and
    the fetch to the host unless ``return_device``), 'total_s', 'n_seasons'.
    """
    from ..data.dataset import interpolate_nan
    from .device_feed import season_arrays

    check_config(mcfg, spatial=True)
    members = list(members)
    nd = data_axis_size(mesh)
    ne = 1 if mesh is None else mesh.n_ensemble
    dev = _device(mesh, device)
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    h, w = dataset.shape()
    hp, wp = h + (-h) % (4 * nd), w + (-w) % 32
    fold = make_spatial_ensemble(mcfg, consts, stats, len(members), n_ensemble=ne, mesh=mesh,
                                 device=dev)
    acc = new_accumulators(hp, wp, mesh, dev)
    seasons = range(4) if dataset.fourseasons else (0,)
    n_seasons = 0
    t = {k: 0.0 for k in ("feed_wait_s", "fold_s", "finalize_s", "total_s")}
    t_run = time.perf_counter()
    for si in seasons:
        t0 = time.perf_counter()
        mosaics, _ = season_arrays(dataset, si)
        sample = {}
        for k, arr in mosaics.items():
            a = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
            if a.dtype.kind == "f" and has_nan(a):
                a = interpolate_nan(np.ascontiguousarray(a, np.float32))
            a, _ = _pad_frame(a, 4 * nd, 32)
            sample[k] = transport_cast({k: np.ascontiguousarray(a)}, transport)[k][None]
        t1 = time.perf_counter()
        acc = fold(members, sample, acc)
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t["feed_wait_s"] += t1 - t0
        t["fold_s"] += time.perf_counter() - t1
        n_seasons += 1
        if progress:
            print(f"spatial season {si}: folded {len(members)} members")
    t0 = time.perf_counter()
    full = reduce_maps(acc, mesh)
    if mesh is not None and not mesh.is_root:
        return None
    full = {k: v[:h, :w] for k, v in full.items()}
    full["count"] = torch.full((h, w), len(members) * n_seasons, dtype=torch.int32, device=dev)
    out = finalize_maps(full)
    if not return_device:
        out = {k: v.cpu().numpy() for k, v in out.items()}
    elif timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        t1 = time.perf_counter()
        t["finalize_s"] += t1 - t0
        t["total_s"] += t1 - t_run
        for k, v in t.items():
            timings[k] = timings.get(k, 0.0) + v
        timings["n_seasons"] = timings.get("n_seasons", 0) + n_seasons
    return out

"""Country-scale sliding-window inference with ensemble stitching.

Counterpart of popcorn_tpu/infer/sliding.py (reference run_eval.py:71-203),
host-feed path:

  * per patch, ``prep`` normalizes the input and computes the frozen
    building score ONCE (the reference recomputes it inside every member);
  * ``members`` folds the Bag-of-POPCORN members in member order into
    sum and sum-of-squares maps of the population density and the
    occupancy scale, then multiplies them by the halo-validity mask;
  * the patch maps are added in place into country-scale accumulators
    that stay on the device, and one finalize computes the visit-count
    mean and the std sqrt((sum_sq - n*mean^2)/(n-1)) (run_eval.py:137-154),
    including the reference's count > 1 divide-mask quirk.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data.dataset import PopulationDataset
from ..data.feed import InferenceFeed
from ..data.normalize import NormStats, normalize_and_assemble
from ..nn.popcorn import check_config, create_building_score, popcorn_predict

Tree = Dict[str, Any]

_ACC_KEYS = ("dense_sum", "dense_sq", "scale_sum", "scale_sq", "count")
_PREP_KEYS = ("S2", "S1", "VIIRS", "building_counts")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA without a card raises; nothing drops to the
    CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


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
                consts["builder"], x, s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir
            )
        else:
            score = batch["building_counts"]
        return x, score

    def members(member_params, x, score, mask, valid):
        """The plain member fold (popcorn_tpu/infer/sliding.py:229-246):
        members in order, float32 sums, then the mask multiply."""
        m = mask.float() * valid.float()[:, None, None]
        zeros = torch.zeros(score.shape[:3], dtype=torch.float32, device=x.device)
        ds, dsq, ss, ssq = (zeros.clone() for _ in range(4))
        inputs = {"input": x, "building_counts": score}
        for params in member_params:
            out = popcorn_predict(params, consts, inputs, mcfg_member, padding=False)
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

    return fn


class StitchAccumulators:
    """Country-scale accumulators on a device, patch maps added in place
    (the JAX package's device-resident stitch, sliding.py:541)."""

    def __init__(self, shape: Tuple[int, int], device):
        h, w = shape
        self.accs = {k: torch.zeros((h, w), dtype=torch.float32, device=device) for k in _ACC_KEYS}

    def add(self, x: int, y: int, res: Dict[str, torch.Tensor], b: int) -> None:
        ph, pw = res["dense_sum"].shape[-2:]
        for k in _ACC_KEYS:
            self.accs[k][x : x + ph, y : y + pw] += res[k][b]

    def finalize(self) -> Dict[str, torch.Tensor]:
        """Visit-count averaging + sum-of-squares std (run_eval.py:137-154).

        Reproduces the reference's div_mask = count > 1: pixels visited
        once keep their raw sum and get std 0."""
        a = self.accs
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
    batch: Dict[str, np.ndarray], device: torch.device,
    keys: Sequence[str] = ("S2", "S1", "VIIRS", "building_counts", "mask", "valid"),
) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors of ``keys`` (pinned and asynchronous
    on CUDA).

    uint16 arrays (lossless S2) travel as their 2 bytes, reinterpreted as
    int16, and widen to int32 on the device: torch's uint16 support is
    partial on CUDA."""
    out = {}
    for k in keys:
        if k not in batch:
            continue
        a = np.ascontiguousarray(batch[k])
        u16 = a.dtype == np.uint16
        t = torch.from_numpy(a.view(np.int16) if u16 else a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(torch.int32).bitwise_and_(0xFFFF) if u16 else t
    return out


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
    return_device: bool = False,
) -> Dict[str, Any]:
    """Full-region ensemble inference -> stitched mean/std maps.

    members/consts: parameter trees of torch tensors (moved to ``device``).
    Patches come from the host InferenceFeed; each batch is uploaded one
    batch ahead of the forward that uses it. The accumulators stay on the
    device; ``return_device`` returns the finalized maps as device tensors
    (census aggregation runs on them there), else as numpy arrays.
    """
    from ..compat.weights import to_torch

    dev = resolve_device(device)
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    member_params = [to_torch(p, dev) for p in members]
    consts = to_torch(consts, dev)
    fwd = make_patch_forward(mcfg, consts, stats, len(members))
    acc = StitchAccumulators(dataset.shape(), dev)

    feed = InferenceFeed(dataset, batch_size=batch_size, prefetch=2, num_workers=num_workers)
    source = feed
    if progress and len(feed):
        from tqdm import tqdm

        source = tqdm(feed, total=len(feed), leave=False)
    it = iter(source)

    # one-batch lookahead: the next batch is uploaded before the current
    # one's forward runs
    cur = next(it, None)
    cur_dev = _upload(cur, dev) if cur is not None else None
    while cur is not None:
        nxt = next(it, None)
        nxt_dev = _upload(nxt, dev) if nxt is not None else None
        res = fwd(member_params, cur_dev)
        for b in range(len(cur["valid"])):
            if cur["valid"][b]:
                x, y = (int(v) for v in cur["img_coords"][b])
                acc.add(x, y, res, b)
        cur, cur_dev = nxt, nxt_dev
    maps = acc.finalize()
    if return_device:
        return maps
    return {k: v.cpu().numpy() for k, v in maps.items()}

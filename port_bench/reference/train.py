"""Weakly supervised training steps of one POPCORN member in plain PyTorch.

Written from the reference repository's description of its training
(run_train.py, utils/losses.py, utils/transform.py, model/popcorn.py):

* a sample is a census region's bounding box with a 32-pixel halo,
  clamped to the raster, from one season's S2 (R, G, B, NIR) and S1
  mosaics and the train level's id raster; samples of a batch are
  zero-padded (the id raster with -1) to one shape and flipped and
  rotated by multiples of 90 degrees together;
* S2 gets the photometric augmentation (brightness, then per-channel
  gamma on the 4-band input, both through [0, 1] clamps of x / 10000);
* the forward is the member's (model.py), the UNet frozen by the memory
  tiers when the batch has more pixels than ``limit1`` / ``limit2``; the
  popcount is the density summed over the sample's census region;
* the loss is mean |log(popcount + 1) - log(census + 1)| plus
  ``scale_regularization`` x mean |scale| over the sparsity mask (the
  region's built pixels and a 60 x 60 lattice of rows and columns drawn
  by torch.randperm, clipped to the region; the whole region when that is
  empty), times ``lam_weak``;
* the gradient is clipped to global norm ``gradient_clip`` (scaled by
  clip / norm when the norm reaches it), then Adam (0.9, 0.999, 1e-8,
  bias-corrected) steps by ``learning_rate``.

What a training run draws from its own random streams (which season and
which flip each sample got, the photometric draw, the lattice's
generator state) is taken from the program's step inputs: ``find_layout``
checks each sample against every season and orientation of the region as
written, and the steps then run on the batches assembled here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from ..traffic.region import SEASONS, read_level, read_season
from .model import Popcorn, dda_input, identity, load_state, load_stats, no_tf32

HALO = 32
S2_MAX = 10000.0


@dataclasses.dataclass
class TrainSettings:
    learning_rate: float = 1e-4
    gradient_clip: float = 0.01
    lam_weak: float = 100.0
    scale_regularization: float = 0.01
    limit1: int = 9_000_000
    limit2: int = 9_000_000


def dihedral(a: torch.Tensor, vflip: bool, hflip: bool, k: int) -> torch.Tensor:
    """Flip rows, flip columns, then rotate k x 90 degrees counter-clockwise,
    over the (H, W) axes 1 and 2 of a (B, H, W, ...) tensor."""
    if vflip:
        a = torch.flip(a, (1,))
    if hflip:
        a = torch.flip(a, (2,))
    return torch.rot90(a, k, (1, 2)) if k else a


ORIENTATIONS = [(v, h, k) for v in (False, True) for h in (False, True) for k in range(4)]


class Region:
    """The region as written, on ``device``: every season's S2 (R, G, B,
    NIR) and S1 as (H, W, C), the train level's id raster and census."""

    def __init__(self, root: str, level: str, device):
        self.s2, self.s1 = [], []
        for season in SEASONS:
            s2, s1 = read_season(root, season)
            self.s2.append(torch.from_numpy(
                np.moveaxis(s2[[2, 1, 0, 3]], 0, -1).astype(np.float32)).to(device))
            self.s1.append(torch.from_numpy(np.moveaxis(s1, 0, -1).copy()).to(device))
        ids, table = read_level(root, level)
        self.ids = torch.from_numpy(ids).to(device)
        self.table: pd.DataFrame = table
        self.h, self.w = ids.shape

    def window(self, census_idx: float):
        row = self.table[self.table["idx"] == int(census_idx)].iloc[0]
        xmin, xmax, ymin, ymax = (int(v) for v in row["bbox"].strip("[]()").split(","))
        x0, y0 = max(xmin - HALO, 0), max(ymin - HALO, 0)
        x1, y1 = min(xmax + HALO, self.h), min(ymax + HALO, self.w)
        return (x0, x1, y0, y1), float(np.float32(row["POP20"]))

    def sample(self, census_idx: float, season: int, hw) -> Optional[Dict[str, torch.Tensor]]:
        """One unaugmented sample padded to ``hw``: S2, S1, admin mask
        (None where the crop does not fit ``hw``)."""
        (x0, x1, y0, y1), _ = self.window(census_idx)
        bh, bw = hw
        if x1 - x0 > bh or y1 - y0 > bw:
            return None
        out = {}
        for key, src, fill in (("S2", self.s2[season], 0), ("S1", self.s1[season], 0)):
            t = torch.full((bh, bw, src.shape[-1]), fill, dtype=src.dtype, device=src.device)
            t[: x1 - x0, : y1 - y0] = src[x0:x1, y0:y1]
            out[key] = t
        adm = torch.full((bh, bw), -1.0, dtype=torch.float32, device=self.ids.device)
        adm[: x1 - x0, : y1 - y0] = self.ids[x0:x1, y0:y1]
        out["admin_mask"] = adm
        return out


def find_layout(region: Region, batch: Dict[str, torch.Tensor]):
    """(batch assembled from the region, number of samples that match no
    season and orientation). ``batch``: the program's step input, read
    for its census ids, its shape and its photometric draw only; a sample
    that matches nothing keeps the program's tensors, and counts."""
    b, h, w = batch["admin_mask"].shape
    out = {k: [] for k in ("S2", "S1", "admin_mask")}
    misses = 0
    for i in range(b):
        idx = float(batch["census_idx"][i])
        found = None
        for v, hf, k in ORIENTATIONS:
            hw = (w, h) if k % 2 else (h, w)
            for season in range(len(SEASONS)):
                s = region.sample(idx, season, hw)
                if s is None:
                    break
                s = {key: dihedral(t[None], v, hf, k)[0] for key, t in s.items()}
                if all(torch.equal(s[key], batch[key][i].to(s[key].device).float())
                       for key in out):
                    found = s
                    break
            if found is not None:
                break
        _, pop = region.window(idx)
        if found is None or pop != float(batch["y"][i]):
            misses += 1
            found = {key: batch[key][i].to(region.ids.device).float() for key in out}
        for key in out:
            out[key].append(found[key])
    assembled = {k: torch.stack(v) for k, v in out.items()}
    assembled["census_idx"] = batch["census_idx"].float().to(region.ids.device)
    assembled["y"] = batch["y"].float().to(region.ids.device)
    assembled["photometric"] = batch["photometric"].float().to(region.ids.device)
    return assembled, misses


def photometric(s2: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Brightness (x beta) then gamma (x ** gamma) on raw 4-band S2, each
    applied where its draw says, through [0, 1] clamps of x / 10000."""
    x = s2.float()
    if p[0] > 0.5:
        x = torch.clamp(x / S2_MAX * p[1], 0, 1) * S2_MAX
    if p[2] > 0.5:
        x = torch.clamp((torch.clamp(x, min=0) / S2_MAX) ** p[3], 0, 1) * S2_MAX
    return x


def sparsity_mask(score, admin, idx, gen_state) -> torch.Tensor:
    sel = admin == idx[:, None, None]
    m = (score > 0) & sel
    g = torch.Generator()
    g.set_state(gen_state)
    _, h, w = m.shape
    rows = torch.zeros(h, dtype=torch.bool)
    cols = torch.zeros(w, dtype=torch.bool)
    rows[torch.randperm(h, generator=g)[: min(60, h)]] = True
    cols[torch.randperm(w, generator=g)[: min(60, w)]] = True
    m = (m | (rows[:, None] & cols[None, :]).to(m.device)[None]) & sel
    return m if bool(m.any()) else sel


def is_trainable(sd: Dict[str, torch.Tensor], key: str) -> bool:
    """A member's trained tensors: the UNet's and head's convolution
    weights and biases (not its frozen BatchNorms, not the streams'
    unused out convs)."""
    if not (key.startswith("unetmodel.") or key.startswith("head.")) or ".outc." in key:
        return False
    return f"{key.rsplit('.', 1)[0]}.running_mean" not in sd


def run_steps(region: Region, member_path: str, batches: Sequence[Dict], gen_states: Sequence,
              cfg: TrainSettings, device, q=identity, popcount_scale: float = 1.0,
              grad_scale: float = 1.0) -> Dict[str, object]:
    """Follow the program's first ``len(batches)`` steps from the member's
    weights: {'loss': [per step], 'popcount': [per step, per sample],
    'grad1': {key: clipped first gradient},
    'change': {key: parameters after the steps minus before},
    'batch_misses': samples assembled differently}. ``q`` rounds the
    convolutions' operands (model.fp8 for the precision control);
    ``popcount_scale`` scales the first sample's population count (a
    planted fault); ``grad_scale`` scales every gradient before the clip
    (-1: a backward whose sign is wrong, a planted fault)."""
    stats = load_stats(device)
    sd = load_state(member_path, device)
    keys = [k for k in sd if is_trainable(sd, k)]
    params = {k: sd[k].clone() for k in keys}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    builder = Popcorn(sd, q)
    losses, popcounts, grad1, misses = [], [], None, 0
    b1, b2, eps = 0.9, 0.999, 1e-8
    with no_tf32():
        for t, (batch, gstate) in enumerate(zip(batches, gen_states), start=1):
            bt, m = find_layout(region, batch)
            misses += m
            s2 = photometric(bt["S2"], bt["photometric"]).permute(0, 3, 1, 2)
            x6 = dda_input(s2, bt["S1"].permute(0, 3, 1, 2), stats)
            with torch.no_grad():
                score = builder.building_score("building_extractor.", x6)
            npix = x6.shape[0] * x6.shape[2] * x6.shape[3]
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            net = Popcorn({**sd, **leaves}, q)
            dense, scale = net.occupancy(x6, score, frozen_encoder=npix > cfg.limit1,
                                         frozen_unet=npix > cfg.limit2)
            sel = bt["admin_mask"] == bt["census_idx"][:, None, None]
            pc = torch.sum(dense * sel, dim=(1, 2))
            if popcount_scale != 1.0:
                pc = pc * torch.cat([pc.new_full((1,), popcount_scale), pc.new_ones(len(pc) - 1)])
            mask = sparsity_mask(score, bt["admin_mask"], bt["census_idx"], gstate)
            l1 = torch.mean(torch.abs(torch.log(pc + 1) - torch.log(bt["y"] + 1)))
            reg = torch.sum(torch.abs(scale) * mask) / torch.clamp(torch.sum(mask), min=1)
            loss = (l1 + cfg.scale_regularization * reg) * cfg.lam_weak
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
            g = {k: torch.zeros_like(params[k]) if d is None else d.detach() * grad_scale
                 for k, d in zip(keys, grads)}
            norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
            if norm >= cfg.gradient_clip:
                g = {k: v / norm * cfg.gradient_clip for k, v in g.items()}
            if t == 1:
                grad1 = g
            losses.append(float(loss.detach()))
            popcounts.append(pc.detach().double().cpu())
            for k in keys:
                mu[k] = b1 * mu[k] + (1 - b1) * g[k]
                nu[k] = b2 * nu[k] + (1 - b2) * g[k] * g[k]
                upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                params[k] = params[k] - cfg.learning_rate * upd
    return {"loss": losses, "popcount": popcounts, "grad1": grad1,
            "change": {k: params[k] - sd[k] for k in keys}, "batch_misses": misses}

"""The Bag-of-POPCORN evaluation of a region in plain PyTorch.

Written from the reference repository's description of its eval
(run_eval.py; data/PopulationDataset.py): patches of ``patch`` pixels on
a grid of stride patch - 2 x overlap with extra rows and columns flush
with the bottom and right edges, once per season; per patch the frozen
building score once, then every member's density and occupancy scale;
each patch adds its members' sums and sums of squares to the country's
maps over its interior (the ``overlap`` ring of every patch is left
out), and the visit count; the mean is the sum over the count where a
pixel was visited more than once (the sum itself where once), the std
sqrt((sum_sq - count x mean^2) / (count - 1)) there and 0 elsewhere;
census counts are per-region sums of the mean map; the dasymmetric
adjustment scales each census region of the train level to its census
total (regions that sum to 0, and pixels of no region, are left as they
are). Sums accumulate in float64.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..traffic.region import SEASONS, read_level, read_season
from .model import Popcorn, dda_input, identity, load_state, load_stats, no_tf32


def patch_grid(h: int, w: int, patch: int, overlap: int, fourseasons: bool) -> List[Tuple[int, int, int]]:
    """(row, column, season) of every patch visit."""
    stride = patch - 2 * overlap
    xs = list(range(0, h - patch, stride))
    ys = list(range(0, w - patch, stride))
    xy = [(x, y) for x in xs for y in ys]
    xy += [(h - patch, y) for y in ys] + [(x, w - patch) for x in xs] + [(h - patch, w - patch)]
    seasons = range(4) if fourseasons else (0,)
    return [(x, y, s) for s in seasons for x, y in xy]


def ensemble_maps(root: str, member_paths: Sequence[str], *, patch: int, overlap: int,
                  fourseasons: bool, device, q=identity) -> Dict[str, torch.Tensor]:
    """The stitched maps of the region at ``root``: 'map', 'map_std',
    'scale', 'scale_std' (float64, on ``device``)."""
    stats = load_stats(device)
    members = [Popcorn(load_state(p, device), q) for p in member_paths]
    n = len(members)
    ids, _ = read_level(root, "coarse")
    h, w = ids.shape
    acc = {k: torch.zeros((h, w), dtype=torch.float64, device=device)
           for k in ("dense", "dense_sq", "scale", "scale_sq", "count")}
    inner = torch.zeros((patch, patch), dtype=torch.float64, device=device)
    inner[overlap:patch - overlap, overlap:patch - overlap] = 1.0
    grid = patch_grid(h, w, patch, overlap, fourseasons)
    with no_tf32(), torch.no_grad():
        for s, season in enumerate(SEASONS if fourseasons else SEASONS[:1]):
            s2, s1 = read_season(root, season)
            s2 = torch.from_numpy(s2[[2, 1, 0, 3]].astype(np.float32)).to(device)  # R, G, B, NIR
            s1 = torch.from_numpy(s1).to(device)
            for x, y, si in grid:
                if si != s:
                    continue
                x6 = dda_input(s2[None, :, x:x + patch, y:y + patch],
                               s1[None, :, x:x + patch, y:y + patch], stats)
                score = members[0].building_score("building_extractor.", x6)
                sums = {k: torch.zeros((patch, patch), dtype=torch.float64, device=device)
                        for k in ("dense", "dense_sq", "scale", "scale_sq")}
                for m in members:
                    dense, scale = (t[0].double() for t in m.occupancy(x6, score))
                    sums["dense"] += dense
                    sums["dense_sq"] += dense * dense
                    sums["scale"] += scale
                    sums["scale_sq"] += scale * scale
                win = (slice(x, x + patch), slice(y, y + patch))
                for k, v in sums.items():
                    acc[k][win] += v * inner
                acc["count"][win] += inner * n
            del s2, s1
    cnt = acc["count"]
    div = cnt > 1
    safe = torch.where(div, cnt, torch.ones_like(cnt))
    out = {}
    for src, name in (("dense", "map"), ("scale", "scale")):
        mean = torch.where(div, acc[src] / safe, acc[src])
        var = torch.where(div, (acc[src + "_sq"] - mean ** 2 * cnt) / torch.clamp(cnt - 1, min=1),
                          torch.zeros_like(cnt))
        out[name] = mean
        out[name + "_std"] = torch.sqrt(torch.clamp(var, min=0))
    return out


class Census:
    """One census level of the region: per-region sums of a map and the
    dasymmetric adjustment to the census totals."""

    def __init__(self, root: str, level: str, device):
        ids, table = read_level(root, level)
        self.table: pd.DataFrame = table
        self.ids = torch.from_numpy(ids.astype(np.int64)).to(device)
        self.valid = ~table["bbox"].isna().to_numpy()
        self.idx = table["idx"].to_numpy().astype(np.int64)
        self.n = int(max(self.idx.max(), int(self.ids.max())) + 1)

    def sums(self, m: torch.Tensor) -> np.ndarray:
        """Sums over each census row's region, in row order, rows with a bbox."""
        tot = torch.bincount(self.ids.reshape(-1), weights=m.reshape(-1).double(), minlength=self.n)
        return tot.cpu().numpy()[self.idx][self.valid]

    def adjust(self, m: torch.Tensor) -> torch.Tensor:
        tot = torch.bincount(self.ids.reshape(-1), weights=m.reshape(-1).double(), minlength=self.n)
        lut = torch.ones(self.n, dtype=torch.float64, device=m.device)
        pop = torch.tensor(self.table["POP20"].to_numpy(np.float64), device=m.device)
        idx = torch.as_tensor(self.idx, device=m.device)
        ok = torch.as_tensor(self.valid, device=m.device) & (tot[idx] > 0)
        lut[idx[ok]] = pop[ok] / tot[idx[ok]]
        return m.double() * lut[self.ids]


def evaluate(root: str, member_paths: Sequence[str], *, patch: int, overlap: int,
             fourseasons: bool, levels: Sequence[str], train_level: str, device,
             q=identity) -> Dict[str, object]:
    """Everything the eval produces: the four maps, the census sums of the
    mean map per level, the adjusted map and its census sums per level."""
    out: Dict[str, object] = dict(ensemble_maps(root, member_paths, patch=patch, overlap=overlap,
                                                fourseasons=fourseasons, device=device, q=q))
    census = {lv: Census(root, lv, device) for lv in set(levels) | {train_level}}
    for lv in levels:
        out[f"census.{lv}"] = census[lv].sums(out["map"])
    out["adj"] = census[train_level].adjust(out["map"])
    for lv in levels:
        out[f"adj_census.{lv}"] = census[lv].sums(out["adj"])
    return out

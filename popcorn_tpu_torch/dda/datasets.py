"""Datasets and samplers for training the DDA built-up extractor.

Re-implements the behaviour of the reference's DDA data layer
(model/DDA_model/utils/datasets.py): an urban-extraction dataset over
labeled and unlabeled sites, a labeled/unlabeled batch sampler, and a
tiles-inference dataset — generalised over a simple JSON manifest so any
S1/S2(+label) patch collection works:

  manifest.json: {"samples": [{"s1": path, "s2": path,
                               "label": path|null, "site": str}, ...],
                  "patch_size": int}

Rasters are read with the native GeoTIFF IO. Arrays come back HWC float32;
S1 is 2ch (VV,VH), S2 4ch (B02,B03,B04,B08) — DDA band order
(utils/constants.py:176), i.e. already in network order [S1|S2].

The port's copy of popcorn_tpu/dda/datasets.py, which imports no jax.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..io.geotiff import GeoTIFF


class UrbanExtractionDataset:
    """Labeled + unlabeled patches for consistency training
    (reference: datasets.py:123-227)."""

    def __init__(self, manifest_path: str, include_unlabeled: bool = True):
        with open(manifest_path) as f:
            m = json.load(f)
        self.root = os.path.dirname(os.path.abspath(manifest_path))
        self.samples = m["samples"]
        self.patch_size = m.get("patch_size")
        if not include_unlabeled:
            self.samples = [s for s in self.samples if s.get("label")]
        self.labeled_idx = [i for i, s in enumerate(self.samples) if s.get("label")]
        self.unlabeled_idx = [i for i, s in enumerate(self.samples) if not s.get("label")]

    def __len__(self):
        return len(self.samples)

    def _path(self, p):
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def __getitem__(self, i: int) -> Dict:
        s = self.samples[i]
        with GeoTIFF(self._path(s["s1"])) as g:
            s1 = np.transpose(g.read((1, 2)), (1, 2, 0))
        with GeoTIFF(self._path(s["s2"])) as g:
            s2 = np.transpose(g.read((1, 2, 3, 4)), (1, 2, 0))
        out = {"x": np.concatenate([s1, s2], -1), "site": s.get("site", "")}
        if s.get("label"):
            with GeoTIFF(self._path(s["label"])) as g:
                out["y"] = g.read(1, squeeze=True).astype(np.float32)
            out["labeled"] = True
        else:
            out["labeled"] = False
        return out


def labeled_unlabeled_batches(
    ds: UrbanExtractionDataset,
    rng: np.random.Generator,
    *,
    labeled_per_batch: int,
    unlabeled_per_batch: int,
) -> Iterator[Tuple[Dict, Optional[Dict]]]:
    """One epoch of paired (labeled, unlabeled) batches — the reference's
    LabeledUnlabeledSampler (datasets.py:25-66): both pools shuffled, the
    epoch length set by the labeled pool."""
    lab = rng.permutation(ds.labeled_idx)
    unl = rng.permutation(ds.unlabeled_idx) if ds.unlabeled_idx else np.array([], int)
    n_batches = len(lab) // labeled_per_batch
    u = 0
    for b in range(n_batches):
        li = lab[b * labeled_per_batch : (b + 1) * labeled_per_batch]
        lab_items = [ds[int(i)] for i in li]
        lab_batch = {
            "x": np.stack([it["x"] for it in lab_items]),
            "y": np.stack([it["y"] for it in lab_items]),
        }
        unl_batch = None
        if unlabeled_per_batch and len(unl):
            ui = []
            for _ in range(unlabeled_per_batch):
                ui.append(int(unl[u % len(unl)]))
                u += 1
            unl_items = [ds[i] for i in ui]
            unl_batch = {"x": np.stack([it["x"] for it in unl_items])}
        yield lab_batch, unl_batch


class TilesInferenceDataset:
    """All tiles of one site for inference/eval (datasets.py:368-513)."""

    def __init__(self, manifest_path: str, site: Optional[str] = None):
        self.ds = UrbanExtractionDataset(manifest_path)
        self.idx = [
            i
            for i, s in enumerate(self.ds.samples)
            if site is None or s.get("site") == site
        ]

    def __len__(self):
        return len(self.idx)

    def __iter__(self):
        for i in self.idx:
            yield self.ds[i]


def make_synthetic_dda_manifest(
    root: str,
    *,
    n_labeled: int = 6,
    n_unlabeled: int = 4,
    size: int = 64,
    seed: int = 0,
) -> str:
    """Synthetic fixture: random S1/S2 tiles with blob labels."""
    from ..io.geotiff import write_geotiff

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    samples = []
    for i in range(n_labeled + n_unlabeled):
        blob = (rng.random((size, size)) < 0.03).astype(np.float32)
        from scipy import ndimage

        label = ndimage.binary_dilation(blob, np.ones((5, 5))).astype(np.float32)
        s1 = np.stack([-16 + 6 * label + rng.normal(0, 1, (size, size)),
                       -22 + 5 * label + rng.normal(0, 1, (size, size))]).astype(np.float32)
        s2 = np.stack([1400 + 500 * label + 100 * rng.normal(0, 1, (size, size))
                       for _ in range(4)]).astype(np.float32)
        t = (30.0 + i, 1e-4, -1.5, 1e-4)
        write_geotiff(os.path.join(root, f"s1_{i}.tif"), s1, transform=t)
        write_geotiff(os.path.join(root, f"s2_{i}.tif"), s2, transform=t)
        rec = {"s1": f"s1_{i}.tif", "s2": f"s2_{i}.tif", "site": "a" if i % 2 else "b"}
        if i < n_labeled:
            write_geotiff(os.path.join(root, f"y_{i}.tif"), label, transform=t)
            rec["label"] = f"y_{i}.tif"
        samples.append(rec)
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        json.dump({"samples": samples, "patch_size": size}, f)
    return path

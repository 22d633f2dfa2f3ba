"""Fusion-DA consistency training of the dual-stream built-up extractor.

Counterpart of popcorn_tpu/dda/train.py. The released DDA checkpoint
("fusionda_*_lossweight0.5") comes from semi-supervised domain-adaptation
training: supervised segmentation loss on labeled sites for the SAR,
optical and fusion heads, plus a consistency loss between the two
streams' probabilities on unlabeled target-domain sites, weighted by
CONSISTENCY_TRAINER.LOSS_FACTOR (0.5, utils/constants.py:174). The result
exports directly into the POPCORN frozen-extractor format.

Randomness: the augmentation and the sampler draw from
``np.random.default_rng(cfg.seed)`` with the JAX package's calls in its
order, so both packages draw the same samples and the same augmentations.
The initial weights come from a second numpy generator on the same seed
(nn/init.py's draws, not JAX's bits); ``init=`` starts the trainer from
given trees instead (compat/weights.py::from_jax_dda).

Optimizer: the JAX package's ``optax.adamw(lr, weight_decay=0.01)`` over
the params and the BN gamma/beta is ``torch.optim.AdamW(lr, betas=(0.9,
0.999), eps=1e-8, weight_decay=0.01)`` over the same leaves: both update
p(1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps). The step runs in full
float32 (TF32 off, nn/ops.py::float32_exact).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compat.weights import to_torch
from ..config import load_dataset_stats
from ..infer.sliding import resolve_device
from ..nn.init import init_dual_stream
from ..nn.ops import float32_exact
from ..train.state import tree_flatten
from .datasets import UrbanExtractionDataset, labeled_unlabeled_batches
from .losses import get_criterion, mse_prob_loss
from .metrics import MultiThresholdMetric, morphology_metrics
from .network import dual_stream_train_forward, init_bn, to_frozen_consts

Tree = Dict[str, Any]


@dataclasses.dataclass
class DDAConfig:
    """The subset of the reference's fvcore config actually used
    (experiment_manager.py:36-74, utils/constants.py:169-179)."""

    topology: Tuple[int, int] = (8, 16)
    loss_type: str = "SoftDiceLoss"
    consistency_loss_type: str = "MeanSquareErrorLoss"
    loss_factor: float = 0.5
    lr: float = 1e-4
    weight_decay: float = 0.01
    epochs: int = 10
    labeled_per_batch: int = 4
    unlabeled_per_batch: int = 4
    seed: int = 7
    # AUGMENTATION.* (reference DDA_model/utils/augmentations.py:11-31):
    # flip + rot90 + per-channel color shift + per-channel gamma, plus an
    # optional random crop, composed into every training sample.
    random_flip: bool = True
    random_rotate: bool = True
    color_shift: bool = True
    gamma_correction: bool = True
    crop_size: int = 0  # 0 = no crop (reference: cfg.AUGMENTATION.CROP_SIZE)


def dda_augment(
    rng: np.random.Generator, x: np.ndarray, y: Optional[np.ndarray], cfg: DDAConfig
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One sample's DDA training augmentation draw, on HWC float arrays
    (the reference's compose_transformations pipeline,
    DDA_model/utils/augmentations.py:11-31): a random aligned crop, p=0.5
    horizontal (axis 1) then vertical (axis 0) flips, k in {1,2,3}
    quarter-turns, per-channel color factors in [0.5, 1.5] and gammas in
    [0.25, 2]. As in the JAX package, the photometric ops act on S2 scaled
    by 1/10000 into [0, 1] and skip the dB-valued S1 channels."""
    if y is not None:
        y = np.asarray(y)
    if cfg.crop_size and (x.shape[0] > cfg.crop_size or x.shape[1] > cfg.crop_size):
        m, n = x.shape[:2]
        i = 0 if m == cfg.crop_size else int(rng.integers(0, m - cfg.crop_size))
        j = 0 if n == cfg.crop_size else int(rng.integers(0, n - cfg.crop_size))
        x = x[i : i + cfg.crop_size, j : j + cfg.crop_size]
        if y is not None:
            y = y[i : i + cfg.crop_size, j : j + cfg.crop_size]
    if cfg.random_flip:
        if rng.random() < 0.5:  # horizontal (axis 1)
            x = np.flip(x, axis=1)
            y = np.flip(y, axis=1) if y is not None else None
        if rng.random() < 0.5:  # vertical (axis 0)
            x = np.flip(x, axis=0)
            y = np.flip(y, axis=0) if y is not None else None
    if cfg.random_rotate:
        k = int(rng.integers(1, 4))
        x = np.rot90(x, k, axes=(0, 1))
        y = np.rot90(y, k, axes=(0, 1)) if y is not None else None
    x = np.ascontiguousarray(x, dtype=np.float32)
    if cfg.color_shift or cfg.gamma_correction:
        s2 = np.clip(x[..., 2:] / 10000.0, 0.0, 1.0)
        if cfg.color_shift:
            factors = rng.uniform(0.5, 1.5, s2.shape[-1]).astype(np.float32)
            s2 = np.clip(s2 * factors[None, None, :], 0.0, 1.0)
        if cfg.gamma_correction:
            gamma = rng.uniform(0.25, 2.0, s2.shape[-1]).astype(np.float32)
            s2 = np.clip(np.power(s2, gamma[None, None, :]), 0.0, 1.0)
        x = np.concatenate([x[..., :2], s2 * 10000.0], axis=-1)
    return x, (np.ascontiguousarray(y, dtype=np.float32) if y is not None else None)


def normalize_dda_input(x: np.ndarray, stats=None) -> np.ndarray:
    """z-score the [S1|S2] 6ch input with the dataset stats."""
    stats = stats or load_dataset_stats()
    s1m = np.asarray(stats["sen1"]["mean"], np.float32)
    s1s = np.asarray(stats["sen1"]["std"], np.float32)
    s2m = np.asarray(stats["sen2springNIR"]["mean"], np.float32)
    s2s = np.asarray(stats["sen2springNIR"]["std"], np.float32)
    out = x.copy()
    out[..., :2] = (x[..., :2] - s1m) / s1s
    out[..., 2:] = (x[..., 2:] - s2m) / s2s
    return out


def _fresh(tree: Tree, device) -> Tree:
    """Detached float32 copies of a tree's leaves on ``device``."""
    if isinstance(tree, dict):
        return {k: _fresh(v, device) for k, v in tree.items()}
    return to_torch(tree, device).detach().clone()


class DDATrainer:
    """DDA consistency training on ``device`` ('cuda' by default; raises
    without a card unless the caller passes 'cpu'). ``init``: (params,
    bn_params, bn_state) to start from instead of the seeded draw."""

    def __init__(self, manifest: str, cfg: Optional[DDAConfig] = None, *, device="cuda",
                 init: Optional[Tuple[Tree, Tree, Tree]] = None):
        self.cfg = cfg or DDAConfig()
        self.device = resolve_device(device)
        self.ds = UrbanExtractionDataset(manifest)
        if init is None:
            params = init_dual_stream(np.random.default_rng(self.cfg.seed), self.cfg.topology)
            bn_params, bn_state = init_bn(self.cfg.topology)
        else:
            params, bn_params, bn_state = init
        self.params = _fresh(params, self.device)
        self.bn_params = _fresh(bn_params, self.device)
        self.bn_state = _fresh(bn_state, self.device)
        trainable = [v for t in (self.params, self.bn_params) for _, v in tree_flatten(t)]
        for t in trainable:
            t.requires_grad_(True)
        self.optimizer = torch.optim.AdamW(
            trainable, lr=self.cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.cfg.weight_decay,
        )
        self._sup = get_criterion(self.cfg.loss_type)
        self._cons = (
            mse_prob_loss
            if self.cfg.consistency_loss_type == "MeanSquareErrorLoss"
            else get_criterion(self.cfg.consistency_loss_type)
        )
        self._rng = np.random.default_rng(self.cfg.seed)
        self.epoch_losses: List[float] = []  # train_epoch's means, in order

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def step(self, xl: torch.Tensor, yl: torch.Tensor, xu: Optional[torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a labeled batch and an optional unlabeled
        one; the unlabeled forward starts from the running state the
        labeled forward left (popcorn_tpu/dda/train.py:154-163). Returns
        the loss (a device scalar)."""
        with float32_exact():
            sar, opt, fus, st = dual_stream_train_forward(
                self.params, self.bn_params, self.bn_state, xl, train=True)
            y = yl[..., None]
            loss = self._sup(sar, y) + self._sup(opt, y) + self._sup(fus, y)
            if xu is not None:
                sar_u, opt_u, _, st = dual_stream_train_forward(
                    self.params, self.bn_params, st, xu, train=True)
                loss = loss + self.cfg.loss_factor * self._cons(torch.sigmoid(sar_u),
                                                                torch.sigmoid(opt_u))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        self.bn_state = st
        return loss.detach()

    def _augment_batch(self, batch, labeled: bool):
        """Per-sample DDA training augmentation of a stacked batch (the
        reference applies compose_transformations inside __getitem__ for
        both pools, datasets.py:123-227)."""
        xs, ys = [], []
        for b in range(batch["x"].shape[0]):
            x, y = dda_augment(self._rng, batch["x"][b], batch["y"][b] if labeled else None, self.cfg)
            xs.append(x)
            if labeled:
                ys.append(y)
        out = {"x": np.stack(xs)}
        if labeled:
            out["y"] = np.stack(ys)
        return out

    def train_epoch(self, augment: bool = True) -> float:
        losses = []
        for lab, unl in labeled_unlabeled_batches(
            self.ds, self._rng,
            labeled_per_batch=self.cfg.labeled_per_batch,
            unlabeled_per_batch=self.cfg.unlabeled_per_batch,
        ):
            if augment:
                lab = self._augment_batch(lab, labeled=True)
                if unl is not None:
                    unl = self._augment_batch(unl, labeled=False)
            xl = self._upload(normalize_dda_input(lab["x"]))
            yl = self._upload(lab["y"])
            xu = self._upload(normalize_dda_input(unl["x"])) if unl is not None else None
            losses.append(float(self.step(xl, yl, xu)))
        self.epoch_losses.append(float(np.mean(losses)) if losses else float("nan"))
        return self.epoch_losses[-1]

    def train(self) -> float:
        last = float("nan")
        for _ in range(self.cfg.epochs):
            last = self.train_epoch()
        return last

    @torch.no_grad()
    def evaluate(self, thresholds=None) -> Dict[str, float]:
        """Threshold-sweep F1 on the labeled samples (fusion head)
        (reference: evaluation.py:64-224)."""
        thresholds = thresholds if thresholds is not None else np.linspace(0, 1, 101)
        m = MultiThresholdMetric(np.asarray(thresholds))
        with float32_exact():
            for i in self.ds.labeled_idx:
                it = self.ds[int(i)]
                x = self._upload(normalize_dda_input(it["x"][None]))
                _, _, fus, _ = dual_stream_train_forward(
                    self.params, self.bn_params, self.bn_state, x, train=False)
                m.add_sample(it["y"], torch.sigmoid(fus)[0, ..., 0].cpu().numpy())
        return m.best()

    @torch.no_grad()
    def export_for_popcorn(self) -> Tuple[Tree, Tree]:
        """(unet_params, frozen_bn_consts) in the trees that
        nn/unet.py::dual_stream_features and
        nn/popcorn.py::create_building_score read."""
        return (_fresh(self.params, self.device),
                to_frozen_consts(_fresh(self.bn_params, self.device), self.bn_state))

    def test_per_site(self, manifest: Optional[str] = None) -> Dict[str, Dict]:
        """Per-site test report — see :func:`model_testing`."""
        ds = UrbanExtractionDataset(manifest) if manifest else self.ds
        return model_testing(self.params, self.bn_params, self.bn_state, ds)


HEADS = ("sar", "optical", "fusion")


@torch.no_grad()
def model_testing(
    params: Tree, bn_params: Tree, bn_state: Tree, ds: UrbanExtractionDataset, *,
    threshold: float = 0.5,
) -> Dict[str, Dict]:
    """Per-site test loop over the labeled samples of a manifest
    (popcorn_tpu/dda/train.py::model_testing; the reference's
    DDA_model/utils/evaluation.py:252-453), on the device of ``params``:
    per head (SAR / optical / fusion) the pixel-pooled precision, recall,
    F1 and IoU at ``threshold``, per site and over all sites under
    ``"test"``, and the sample-mean morphology metrics (boundary, closed,
    opened and gradient IoU, SSIM, Hausdorff).

    Returns ``{site_or_"test": {head: {metric: value}}}``."""
    if not ds.labeled_idx:
        raise ValueError("model_testing needs at least one labeled sample")
    dev = params["sar_out"]["w"].device
    sites: Dict[str, Dict[str, Dict]] = {}

    def _bucket(site: str):
        if site not in sites:
            sites[site] = {
                h: {"pix": MultiThresholdMetric(np.asarray([threshold])), "morph": []}
                for h in HEADS
            }
        return sites[site]

    with float32_exact():
        for i in ds.labeled_idx:
            it = ds[int(i)]
            x = torch.from_numpy(normalize_dda_input(it["x"][None])).to(dev)
            logits = dual_stream_train_forward(params, bn_params, bn_state, x, train=False)[:3]
            probs = {h: torch.sigmoid(v)[0, ..., 0].cpu().numpy() for h, v in zip(HEADS, logits)}
            for bucket in (_bucket(it.get("site") or "test"), _bucket("test")):
                for h in HEADS:
                    bucket[h]["pix"].add_sample(it["y"], probs[h])
                    bucket[h]["morph"].append(morphology_metrics(it["y"], probs[h], threshold))

    report: Dict[str, Dict] = {}
    for site, heads in sites.items():
        report[site] = {}
        for h in HEADS:
            pix = heads[h]["pix"]
            morph = heads[h]["morph"]
            entry = {
                "precision": float(pix.precision[0]),
                "recall": float(pix.recall[0]),
                "f1": float(pix.f1()[0]),
                "iou": float(pix.iou[0]),
                "n_samples": len(morph),
            }
            for k in ("boundary_iou", "closed_iou", "opened_iou", "gradient_iou", "ssim",
                      "hausdorff"):
                vals = [m[k] for m in morph if np.isfinite(m[k])]
                entry[k] = float(np.mean(vals)) if vals else float("nan")
            report[site][h] = entry
    return report


def format_site_report(report: Dict[str, Dict]) -> str:
    """Human-readable table of a model_testing report."""
    lines = []
    metrics = ("f1", "precision", "recall", "iou", "boundary_iou",
               "closed_iou", "opened_iou", "gradient_iou", "ssim")
    for site in sorted(report, key=lambda s: (s != "test", s)):
        for h in HEADS:
            e = report[site][h]
            vals = " ".join(f"{m}={e[m]:.4f}" for m in metrics)
            lines.append(f"{site:>12} {h:>8} n={e['n_samples']:<3} {vals}")
    return "\n".join(lines)

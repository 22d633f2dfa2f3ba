"""Segmentation metrics for the DDA built-up extractor.

Re-implements the reference's multi-threshold accumulator and morphology
metrics (model/DDA_model/utils/metrics.py) with numpy/scipy.

NOTE (bug fixed, documented): the reference swaps its FP/FN accumulators
(metrics.py:30-31 computes FP = y_true & ~y_pred and FN = ~y_true &
y_pred, i.e. reversed). Since F1 is symmetric in FP/FN the reference's
F1 numbers are still correct, but its precision/recall/FPR/FNR are
exchanged. This implementation uses the standard definitions.

The port's copy of popcorn_tpu/dda/metrics.py, which imports no jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

EPS = 1e-5


class MultiThresholdMetric:
    """TP/TN/FP/FN accumulated over samples for a vector of thresholds."""

    def __init__(self, thresholds: np.ndarray):
        self.thresholds = np.asarray(thresholds, np.float32)
        n = len(self.thresholds)
        self.TP = np.zeros(n)
        self.TN = np.zeros(n)
        self.FP = np.zeros(n)
        self.FN = np.zeros(n)

    def add_sample(self, y_true: np.ndarray, y_prob: np.ndarray):
        t = y_true.astype(bool).reshape(-1)[None, :]
        p = y_prob.reshape(-1)[None, :] >= self.thresholds[:, None]
        self.TP += (t & p).sum(1)
        self.TN += (~t & ~p).sum(1)
        self.FP += (~t & p).sum(1)
        self.FN += (t & ~p).sum(1)

    @property
    def precision(self):
        return self.TP / np.maximum(self.TP + self.FP, EPS)

    @property
    def recall(self):
        return self.TP / np.maximum(self.TP + self.FN, EPS)

    @property
    def iou(self):
        return self.TP / np.maximum(self.TP + self.FP + self.FN, EPS)

    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / np.maximum(p + r, EPS)

    def basic_rates(self):
        fpr = self.FP / np.maximum(self.FP + self.TN, EPS)
        fnr = self.FN / np.maximum(self.FN + self.TP, EPS)
        return fpr, fnr

    def best(self) -> Dict[str, float]:
        f1 = self.f1()
        i = int(np.argmax(f1))
        return {
            "f1": float(f1[i]),
            "precision": float(self.precision[i]),
            "recall": float(self.recall[i]),
            "iou": float(self.iou[i]),
            "threshold": float(self.thresholds[i]),
        }


def f1_score(y_true: np.ndarray, y_prob: np.ndarray, threshold: float = 0.5) -> float:
    m = MultiThresholdMetric(np.asarray([threshold]))
    m.add_sample(y_true, y_prob)
    return float(m.f1()[0])


# ------------------------- morphology metrics (metrics.py:108-155) ----------


def _binary(y, thr=0.5):
    return np.asarray(y) >= thr


def gradient_mask(m: np.ndarray) -> np.ndarray:
    """Morphological gradient (dilation - erosion) of a binary mask."""
    from scipy import ndimage

    s = np.ones((3, 3), bool)
    return ndimage.binary_dilation(m, s) ^ ndimage.binary_erosion(m, s)


def _iou_masks(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter / max(union, 1))


def _gaussian_window(size: int = 7, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    window_size: int = 7,
    max_val: float = 1.0,
) -> float:
    """Mean structural similarity with a gaussian window (sigma 1.5).

    Pure numpy/scipy equivalent of the reference's kornia SSIM
    (model/DDA_model/utils/metrics.py:133-135: kornia.metrics.ssim with
    windowsize 7 followed by torch.mean). Local statistics come from
    'valid'-mode gaussian filtering so no padding semantics leak in.
    """
    from scipy.signal import fftconvolve

    a = np.asarray(y_true, np.float64)
    b = np.asarray(y_pred, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    w = _gaussian_window(window_size)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):
        return fftconvolve(x, w, mode="valid")

    mu_a = filt(a)
    mu_b = filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = filt(a * a) - mu_aa
    var_b = filt(b * b) - mu_bb
    cov = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def morphology_metrics(y_true: np.ndarray, y_prob: np.ndarray, threshold=0.5) -> Dict[str, float]:
    """Boundary/opened/closed/gradient IoU + SSIM + Hausdorff distance."""
    from scipy import ndimage
    from scipy.spatial.distance import directed_hausdorff

    t = _binary(y_true)
    p = _binary(y_prob, threshold)
    s = np.ones((3, 3), bool)
    out = {
        "iou": _iou_masks(t, p),
        # reference boundary_IoU (metrics.py:108-112): IoU of the 3x3-dilated
        # masks (the name notwithstanding, it dilates — it does not extract a
        # boundary ring; the ring variant is gradient_iou below)
        "boundary_iou": _iou_masks(
            ndimage.binary_dilation(t, s), ndimage.binary_dilation(p, s)
        ),
        "gradient_iou": _iou_masks(gradient_mask(t), gradient_mask(p)),
        "opened_iou": _iou_masks(
            ndimage.binary_opening(t, s), ndimage.binary_opening(p, s)
        ),
        "closed_iou": _iou_masks(
            ndimage.binary_closing(t, s), ndimage.binary_closing(p, s)
        ),
        # SSIM on the thresholded masks, as the reference applies it to the
        # binarized built-up maps (metrics.py:133-135)
        "ssim": ssim(t.astype(np.float64), p.astype(np.float64)),
    }
    pt = np.argwhere(t)
    pp = np.argwhere(p)
    if len(pt) and len(pp):
        out["hausdorff"] = float(
            max(directed_hausdorff(pt, pp)[0], directed_hausdorff(pp, pt)[0])
        )
    else:
        out["hausdorff"] = float("inf") if len(pt) != len(pp) else 0.0
    return out

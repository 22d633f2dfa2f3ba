"""Segmentation losses for training the DDA built-up extractor.

Counterpart of popcorn_tpu/dda/losses.py (the reference's criterion
factory and dice / jaccard loss family,
model/DDA_model/utils/loss_functions.py:10-200), on torch tensors with the
same formulas and the same EPS. All losses take (logits, targets) of any
matching shape.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

EPS = 1e-6


def bce_with_logits(logits, y):
    return -torch.mean(y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))


def weighted_cross_entropy(negative_weight: float = 1.0, positive_weight: float = 1.0):
    """2-class CE over logits (..., 2) and integer {0,1} targets (...):
    torch CrossEntropyLoss(weight=[neg, pos]) for channel-last logits."""

    w = torch.tensor([negative_weight, positive_weight], dtype=torch.float32)

    def f(logits, y):
        logp = F.log_softmax(logits, dim=-1)
        y = y.long()
        picked = torch.gather(logp, -1, y[..., None])[..., 0]
        wy = w.to(logits.device)[y]
        return -torch.sum(wy * picked) / torch.clamp(torch.sum(wy), min=EPS)

    return f


def _flat(logits, y):
    return torch.sigmoid(logits).reshape(-1), y.reshape(-1)


def soft_dice_loss(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + EPS) / (torch.sum(p) + torch.sum(t) + EPS)


def dice_like_loss(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter) / (torch.sum(p**2) + torch.sum(t**2) + EPS)


def jaccard_like_loss(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    denom = torch.sum(p**2) + torch.sum(t**2) - inter + EPS
    return 1.0 - (2.0 * inter) / denom


def power_jaccard_loss(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    denom = torch.sum(p**2) + torch.sum(t**2) - inter + EPS
    return 1.0 - inter / denom


def iou_loss(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t) - inter + EPS
    return 1.0 - inter / union


def soft_dice_loss_balanced(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    dice_pos = (2.0 * inter) / (torch.sum(p) + torch.sum(t) + EPS)
    n_inter = torch.sum((1 - p) * (1 - t))
    dice_neg = (2.0 * n_inter) / (torch.sum(1 - p) + torch.sum(1 - t) + EPS)
    return 2.0 - dice_pos - dice_neg


def jaccard_like_balanced_loss(logits, y):
    p, t = _flat(logits, y)
    inter = torch.sum(p * t)
    denom = torch.sum(p**2) + torch.sum(t**2) - inter + EPS
    piccard = 2.0 * inter / denom
    n_p, n_t = 1 - p, 1 - t
    n_inter = torch.sum(n_p * n_t)
    n_denom = torch.sum(n_p**2) + torch.sum(n_t**2) - n_inter + EPS
    return 1.0 - piccard - 2.0 * n_inter / n_denom


def mse_prob_loss(p, q):
    """MSE between two probability maps (the consistency loss)."""
    return torch.mean((p - q) ** 2)


_CRITERIA = {
    "BCEWithLogitsLoss": lambda **kw: bce_with_logits,
    "CrossEntropyLoss": lambda negative_weight=1.0, positive_weight=1.0, **kw:
        weighted_cross_entropy(negative_weight, positive_weight),
    "SoftDiceLoss": lambda **kw: soft_dice_loss,
    "SoftDiceSquaredSumLoss": lambda **kw: soft_dice_loss,  # ref alias (loss_functions.py:53)
    "SoftDiceBalancedLoss": lambda **kw: soft_dice_loss_balanced,
    "PowerJaccardLoss": lambda **kw: power_jaccard_loss,
    "MeanSquareErrorLoss": lambda **kw: mse_prob_loss,
    "IoULoss": lambda **kw: iou_loss,
    "DiceLikeLoss": lambda **kw: dice_like_loss,
    "JaccardLikeLoss": lambda **kw: jaccard_like_loss,
    "JaccardLikeBalancedLoss": lambda **kw: jaccard_like_balanced_loss,
}


def get_criterion(loss_type: str, negative_weight: float = 1.0,
                  positive_weight: float = 1.0) -> Callable:
    """Name -> loss fn (reference: loss_functions.py:10-36)."""
    if loss_type not in _CRITERIA:
        raise ValueError(f"unknown loss {loss_type}")
    return _CRITERIA[loss_type](
        negative_weight=negative_weight, positive_weight=positive_weight
    )

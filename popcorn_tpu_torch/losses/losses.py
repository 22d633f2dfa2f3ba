"""Census-count regression losses and metrics (reference:
utils/losses.py:12-127), on torch tensors.

Counterpart of popcorn_tpu/losses/losses.py: a weighted sum of
name-selected population losses plus an occupancy-scale L1
regularisation, with the monitored metrics (r2, mape, correlation)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

EPS = 1e-8


def r2(pred: torch.Tensor, gt: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """R2 score (reference: utils/losses.py:101-127)."""
    ss_tot = torch.sum((gt - torch.mean(gt)) ** 2)
    ss_res = torch.sum((gt - pred) ** 2)
    return 1.0 - ss_res / (ss_tot + eps)


def mape(pred: torch.Tensor, gt: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Mean absolute percentage error over gt > 0.1 (utils/losses.py:91-97)."""
    pos = gt > 0.1
    n = torch.clamp(torch.sum(pos), min=1)
    rel = torch.where(pos, torch.abs(pred - gt) / (gt + eps), torch.zeros_like(gt))
    return 100.0 * torch.sum(rel) / n


def pearson_corr(pred: torch.Tensor, gt: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pearson correlation (torch.corrcoef equivalent)."""
    pm = pred - torch.mean(pred)
    gm = gt - torch.mean(gt)
    denom = torch.sqrt(torch.sum(pm**2) * torch.sum(gm**2))
    return torch.sum(pm * gm) / (denom + eps)


def _metric_dict(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All monitored metrics (reference utils/losses.py:51-59). r2 and the
    correlation need more than one sample; with one they are 0."""
    log_p = torch.log(pred + 1.0)
    log_g = torch.log(gt + 1.0)
    many = pred.shape[0] > 1
    zero = pred.new_zeros(())
    return {
        "l1_loss": torch.mean(torch.abs(pred - gt)),
        "log_l1_loss": torch.mean(torch.abs(log_p - log_g)),
        "mse_loss": torch.mean((pred - gt) ** 2),
        "log_mse_loss": torch.mean((log_p - log_g) ** 2),
        "mr2": r2(pred, gt) if many else zero,
        "mape": mape(pred, gt),
        "mCorrelation": pearson_corr(pred, gt) if many else zero,
    }


def get_loss(
    popcount: torch.Tensor,
    census_gt: torch.Tensor,
    *,
    scale_abs_mean: Optional[torch.Tensor] = None,
    loss: Sequence[str] = ("log_l1_loss",),
    lam: Sequence[float] = (1.0,),
    scale_regularization: float = 0.0,
    tag: str = "",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted loss + aux log dict (reference: utils/losses.py:12-88).

    scale_abs_mean is the (masked) mean |scale| computed inside the model
    forward, the reference's scale[mask].abs().mean()."""
    popcount = popcount.float()
    census_gt = census_gt.float()
    metrics = _metric_dict(popcount, census_gt)

    optimization_loss = popcount.new_zeros(())
    for lo, la in zip(loss, lam):
        if lo in metrics:
            optimization_loss = optimization_loss + metrics[lo] * la

    if scale_abs_mean is not None:
        metrics["scale"] = scale_abs_mean
        if scale_regularization > 0.0:
            optimization_loss = optimization_loss + scale_regularization * scale_abs_mean

    prefix = "Population" if tag == "" else f"Population_{tag}"
    aux = {f"{prefix}/{k}": v for k, v in metrics.items()}
    aux["optimization_loss"] = optimization_loss
    return optimization_loss, aux

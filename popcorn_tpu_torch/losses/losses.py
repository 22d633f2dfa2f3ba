"""Census-count metrics (reference: utils/losses.py:91-127), on torch
tensors. The training losses are not ported yet."""

from __future__ import annotations

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

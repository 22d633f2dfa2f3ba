"""Census-level test metrics (reference: utils/metrics.py:12-25)."""

from __future__ import annotations

from typing import Dict

import torch

from .losses import mape, pearson_corr, r2


def get_test_metrics(pred, y, tag: str = "") -> Dict[str, float]:
    pred = torch.as_tensor(pred, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    log_p = torch.log(pred + 1.0)
    log_y = torch.log(y + 1.0)
    d = {
        "l1_loss": torch.mean(torch.abs(pred - y)),
        "r2": r2(pred, y),
        "mape": mape(pred, y),
        "log_l1_loss": torch.mean(torch.abs(log_p - log_y)),
        "mse_loss": torch.mean((pred - y) ** 2),
        "log_mse_loss": torch.mean((log_p - log_y) ** 2),
        "Correlation": pearson_corr(pred, y),
    }
    return {f"Population_{tag}/{k}": float(v) for k, v in d.items()}

"""Device-side normalization and input assembly.

Counterpart of popcorn_tpu/data/normalize.py (reference apply_normalize,
utils/utils.py:105-214): per-modality z-score with the dataset_stats JSON,
then channel concatenation into the model input
[S2(R,G,B[,NIR]), S1(VV,VH), VIIRS?].

The stats key choice mirrors the reference exactly: S2 uses
'sen2springNIR' when 4 channels else 'sen2spring' (utils.py:114-117) —
the *spring* statistics are applied to every season.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import load_dataset_stats


class NormStats:
    """Per-modality mean/std as float32 tensors on one device."""

    def __init__(self, stats: Optional[Dict] = None, device="cpu"):
        stats = stats or load_dataset_stats()
        self.device = torch.device(device)

        def t(key, field):
            return torch.tensor(stats[key][field], dtype=torch.float32, device=self.device)

        self.s2_mean, self.s2_std = t("sen2spring", "mean"), t("sen2spring", "std")
        self.s2nir_mean, self.s2nir_std = t("sen2springNIR", "mean"), t("sen2springNIR", "std")
        self.s1_mean, self.s1_std = t("sen1", "mean"), t("sen1", "std")
        self.viirs_mean, self.viirs_std = t("viirs", "mean"), t("viirs", "std")


def normalize_and_assemble(sample: Dict[str, torch.Tensor], stats: NormStats) -> torch.Tensor:
    """Normalize S2/S1/VIIRS (NHWC) and concat into the model input.

    S2 may arrive as uint16 (the feed ships lossless S2 as 2-byte integers);
    it is upcast to float32 here, as the JAX package's prep does
    (infer/sliding.py:98-101)."""
    parts = []
    if "S2" in sample:
        x = sample["S2"].float()
        if x.shape[-1] == 4:
            x = (x - stats.s2nir_mean) / stats.s2nir_std
        else:
            x = (x - stats.s2_mean) / stats.s2_std
        parts.append(x)
    if "S1" in sample:
        parts.append((sample["S1"].float() - stats.s1_mean) / stats.s1_std)
    if "VIIRS" in sample:
        parts.append((sample["VIIRS"].float() - stats.viirs_mean) / stats.viirs_std)
    if not parts:
        raise ValueError("no modalities to assemble")
    return torch.cat(parts, dim=-1)


def photometric_s2_traced(s2: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """S2 brightness + gamma augmentation with the draw as a tensor.

    ``params`` is a length-4 float32 tensor [apply_brightness, beta,
    apply_gamma, gamma] on the image's device, so a draw needs no host
    sync. Semantics of aug.augment.apply_photometric_s2 / the reference
    utils/transform.py:175-276, including the 3-channel gamma->multiply
    quirk (aug/augment.py) and torchvision's [0, 1] clamps."""
    s2max = 10000.0
    apply_b = params[0] > 0.5
    beta = params[1]
    apply_g = params[2] > 0.5
    gamma = params[3]

    xb = torch.clamp(s2 / s2max * beta, 0.0, 1.0) * s2max
    x = torch.where(apply_b, xb, s2)

    x01 = torch.clamp(x, min=0.0) / s2max
    if s2.shape[-1] == 3:
        xg = torch.clamp(x01 * gamma, 0.0, 1.0) * s2max
    else:
        xg = torch.clamp(x01**gamma, 0.0, 1.0) * s2max
    return torch.where(apply_g, xg, x)

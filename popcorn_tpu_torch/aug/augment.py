"""Data augmentations, reproducing the reference's semantics
(utils/transform.py + the wiring in run_train.py:386-402 and
utils/utils.py:130-214):

  General (applied jointly to the normalized input concat AND the stacked
  masks — admin mask etc.):
    * RandomVerticalFlip(p=0.5, allsame=True)
    * RandomHorizontalFlip(p=0.5, allsame=True)
    * RandomRotationTransform(angles=[90,180,270], p=0.75, expand=True,
      mask fill=-1)
  S2-only (applied to RAW reflectances BEFORE normalization):
    * RandomBrightness(p=0.9, beta in [0.666, 1.5])
    * RandomGamma(p=0.9, gamma in [0.6666, 1.5])

Split: the *geometric* transforms run on the host in numpy (np.rot90/flip
are views; the copies they imply are folded into the pad-to-bucket copy
the feed performs anyway). Rotation by 90/270 swaps H and W. The
*photometric* transforms are pure elementwise math.

Reference quirks reproduced faithfully (documented):
  * torchvision adjust_brightness/adjust_gamma clamp to [0,1] after
    scaling by 1/10000, so values clip at 10000.
  * The reference's RandomGamma applies *brightness* (a multiply) when the
    tensor has exactly 3 channels, and true per-channel gamma otherwise
    (utils/transform.py:213-221) — the 4-channel (NIR) path gets gamma.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

S2_MAX = 10000.0


@dataclasses.dataclass
class GeneralAugParams:
    """One draw of the general (geometric) augmentations for a batch."""

    vflip: bool
    hflip: bool
    rot_k: int  # number of CCW 90-degree rotations, 0 = no rotation


def draw_general(rng: np.random.Generator) -> GeneralAugParams:
    """Sample the batch-wide geometric augmentation (allsame=True draws)."""
    vflip = rng.random() < 0.5
    hflip = rng.random() < 0.5
    rot_k = 0
    if rng.random() < 0.75:
        rot_k = int(rng.choice([1, 2, 3]))  # 90, 180, 270 degrees
    return GeneralAugParams(vflip=vflip, hflip=hflip, rot_k=rot_k)


def apply_geometric(
    arr: np.ndarray, p: GeneralAugParams, hw_axes: Tuple[int, int] = (1, 2)
) -> np.ndarray:
    """Apply flips + k*90 rotation to an array with H,W at hw_axes.

    TF.rotate(angle, expand=True) with angle in {90,180,270} equals an
    exact np.rot90 (CCW for positive angles in torchvision).
    """
    h_ax, w_ax = hw_axes
    if p.vflip:
        arr = np.flip(arr, axis=h_ax)
    if p.hflip:
        arr = np.flip(arr, axis=w_ax)
    if p.rot_k:
        arr = np.rot90(arr, k=p.rot_k, axes=(h_ax, w_ax))
    return arr


@dataclasses.dataclass
class PhotometricParams:
    """One draw of the S2 photometric augmentations for a batch."""

    apply_brightness: bool
    beta: float
    apply_gamma: bool
    gamma: float


def draw_photometric(rng: np.random.Generator) -> PhotometricParams:
    return PhotometricParams(
        apply_brightness=rng.random() < 0.9,
        beta=float(rng.uniform(0.666, 1.5)),
        apply_gamma=rng.random() < 0.9,
        gamma=float(rng.uniform(0.6666, 1.5)),
    )


def _adjust_brightness(x01, beta, xp):
    return xp.clip(x01 * beta, 0.0, 1.0)


def _adjust_gamma(x01, gamma, xp):
    return xp.clip(x01**gamma, 0.0, 1.0)


def apply_photometric_s2(x, p: PhotometricParams, xp=np):
    """RandomBrightness then RandomGamma on raw S2 (B,H,W,C), C in {3,4}.

    ``xp`` is the array module (numpy).
    """
    c = x.shape[-1]
    if p.apply_brightness:
        x01 = x / S2_MAX
        x01 = _adjust_brightness(x01, p.beta, xp)
        x = x01 * S2_MAX
    if p.apply_gamma:
        x01 = xp.clip(x, 0.0, None) / S2_MAX
        if c == 3:
            # reference quirk: 3-channel path multiplies instead of powering
            x01 = _adjust_brightness(x01, p.gamma, xp)
        else:
            x01 = _adjust_gamma(x01, p.gamma, xp)
        x = x01 * S2_MAX
    return x

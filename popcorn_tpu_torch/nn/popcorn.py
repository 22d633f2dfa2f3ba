"""The POPCORN population-mapping model, eval path.

Counterpart of popcorn_tpu/nn/popcorn.py (reference model/popcorn.py):

  popdensemap = relu(head(unet(x))[..., 0]) * building_score  (occupancy)
  popcount    = sum over the admin region

with a frozen dual-stream UNet feature extractor, a second frozen
dual-stream UNet as on-the-fly building extractor, and the 4-layer 1x1
head. The port has one engine, plain NHWC: the JAX package's packed and
wide engines (nn/packed.py, nn/wide.py) are TPU lane layouts of the same
math. Training (sparse masks, gradients) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import ModelConfig
from .head import head_apply
from .ops import add_padding, revert_padding
from .unet import building_logits, dual_stream_features

Tree = Dict[str, Any]


def reorder_to_dda(x: torch.Tensor, *, s1: bool, s2: bool, nir: bool) -> torch.Tensor:
    """Reorder the assembled input [S2: R,G,B(,NIR)][S1: VV,VH] into DDA's
    6-channel order [VV, VH, B02(B), B03(G), B04(R), B08(NIR)]
    (model/popcorn.py:129-145: RGB is flipped to the BGR order the DDA
    checkpoint was trained on). Missing modalities are zero-filled."""
    b, h, w, _ = x.shape

    def zeros(c):
        return x.new_zeros((b, h, w, c))

    if s2:
        n_s2 = 4 if nir else 3
        bgr = torch.flip(x[..., :3], dims=(-1,))  # R,G,B -> B,G,R
        nir_c = x[..., 3:4] if nir else zeros(1)
        s1_c = x[..., n_s2 : n_s2 + 2] if s1 else zeros(2)
        return torch.cat([s1_c, bgr, nir_c], dim=-1)
    if s1:
        return torch.cat([x[..., :2], zeros(4)], dim=-1)
    raise ValueError("at least one of S1/S2 must be enabled")


def check_config(cfg: ModelConfig) -> None:
    """Raise for model options the port does not run yet."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port's kernels take "
            "float32 only (bf16 is not ported yet)"
        )
    if cfg.quantize:
        raise NotImplementedError(f"quantize={cfg.quantize!r} is not ported yet")


@torch.no_grad()
def create_building_score(
    builder: Tree, x_input: torch.Tensor, *, s1: bool, s2: bool, nir: bool
) -> torch.Tensor:
    """On-the-fly built-up probability (model/popcorn.py:279-322):
    reflect-pad 14 px, the frozen building-extractor UNet, sigmoid, unpad.
    Returns the (B, H, W) score."""
    xp, pad = add_padding(x_input, force=True)
    x6 = reorder_to_dda(xp, s1=s1, s2=s2, nir=nir)
    logits = building_logits(builder["params"], builder["bn"], x6, s1=s1, s2=s2)
    score = torch.sigmoid(logits.float())
    return revert_padding(score, pad)[..., 0]


@torch.no_grad()
def popcorn_forward(
    params: Tree,
    consts: Tree,
    inputs: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    train: bool = False,
    padding: bool = True,
    sparse: bool = False,
) -> Dict[str, Any]:
    """Full POPCORN forward pass, eval semantics (model/popcorn.py:100-193).

    params: {'unet': dual-stream tree, 'head': {'l1'..'l4': {w,b}}}
    consts: {'unet_bn': BN constants, 'builder': {'params','bn'}}
    inputs: {'input': (B,H,W,C) normalized modality concat,
             optional 'building_counts': (B,H,W) or (B,H,W,1),
             optional 'admin_mask': (B,H,W), 'census_idx': (B,)}

    Returns {'popcount': (B,), 'popdensemap': (B,H,W), 'scale': (B,H,W)
    or None, 'scale_abs_mean': mean |scale| or None, 'building_counts'}.
    """
    if train or sparse:
        raise NotImplementedError("the port runs the eval forward only (train/sparse not ported yet)")
    check_config(cfg)
    x = inputs["input"]
    if "building_counts" not in inputs or cfg.sentinel_buildings:
        building_counts = create_building_score(
            consts["builder"], x, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir
        )
    else:
        building_counts = inputs["building_counts"]
        if building_counts.dim() == 4:
            building_counts = building_counts[..., 0]

    xp, pad = add_padding(x, force=padding)
    x6 = reorder_to_dda(xp, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir)
    feats = dual_stream_features(params["unet"], consts["unet_bn"], x6, s1=cfg.s1, s2=cfg.s2)
    feats = revert_padding(feats, pad).contiguous()
    out = head_apply(params["head"], feats, n_out=1)[..., 0].float()

    if cfg.occupancy_model:
        scale = torch.relu(out)
        popdensemap = scale * building_counts.float()
    else:
        scale = None
        popdensemap = torch.relu(out)

    if "admin_mask" in inputs:
        sel = inputs["admin_mask"] == inputs["census_idx"][:, None, None]
        popcount = torch.sum(popdensemap * sel, dim=(1, 2))
    else:
        popcount = torch.sum(popdensemap, dim=(1, 2))
    return {
        "popcount": popcount,
        "popdensemap": popdensemap,
        "scale": scale,
        "scale_abs_mean": None if scale is None else torch.mean(torch.abs(scale)),
        "building_counts": building_counts,
    }

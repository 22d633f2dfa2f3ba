"""The POPCORN population-mapping model.

Counterpart of popcorn_tpu/nn/popcorn.py (reference model/popcorn.py):

  popdensemap = relu(head(unet(x))[..., 0]) * building_score  (occupancy)
  popcount    = sum over the admin region

with a dual-stream UNet feature extractor (trainable in training), a
second frozen dual-stream UNet as on-the-fly building extractor, and the
4-layer 1x1 head. The port has one engine, plain NHWC: the JAX package's
packed and wide engines (nn/packed.py, nn/wide.py) are TPU lane layouts
of the same math. As in the JAX package, the sparsity mask of training
only restricts the scale regulariser: the head runs densely, and every
pixel that can add to popcount lies in the mask.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig
from .head import head_apply, head_train
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


def sparsity_mask(
    generator: torch.Generator,
    building_counts: Optional[torch.Tensor],
    admin_mask: torch.Tensor,
    census_idx: torch.Tensor,
    *,
    occupancy: bool,
) -> torch.Tensor:
    """The training sparsity mask (model/popcorn.py:361-377;
    popcorn_tpu/nn/popcorn.py::sparsity_mask).

    mask = (buildings > 0 [if occupancy]) AND (admin == census_idx), plus a
    random 60x60 row/column lattice (one draw shared across the batch, as
    in the reference) clipped to the admin region, falling back to the
    whole admin region when the batch's mask is empty. The lattice rows
    and columns are ``torch.randperm(n, generator=generator)[:60]``, drawn
    on the generator's device (the trainer's is on the CPU) and moved to
    the mask's; JAX's draw cannot be matched bit for bit, so tests inject
    its mask through ``popcorn_forward(mask=...)``."""
    admin_sel = admin_mask == census_idx[:, None, None]
    if building_counts is not None and building_counts.dim() == 4:
        building_counts = building_counts[..., 0]
    m = (building_counts > 0) & admin_sel if occupancy else admin_sel
    _, h, w = m.shape
    gdev = generator.device
    xi = torch.randperm(h, generator=generator, device=gdev)[: min(60, h)]
    yi = torch.randperm(w, generator=generator, device=gdev)[: min(60, w)]
    rows = torch.zeros(h, dtype=torch.bool, device=gdev)
    cols = torch.zeros(w, dtype=torch.bool, device=gdev)
    rows[xi] = True
    cols[yi] = True
    lattice = (rows[:, None] & cols[None, :]).to(m.device)
    m = (m | lattice[None]) & admin_sel
    return torch.where(m.any(), m, admin_sel)


@torch.no_grad()
def popcorn_predict(
    params: Tree, consts: Tree, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
    *, padding: bool = True,
) -> Dict[str, Any]:
    """The eval forward without autograd: every UNet block and the
    channel-0 head through their kernels on the card."""
    return popcorn_forward(params, consts, inputs, cfg, padding=padding)


def popcorn_forward(
    params: Tree,
    consts: Tree,
    inputs: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    train: bool = False,
    padding: bool = True,
    encoder_no_grad: bool = False,
    unet_no_grad: bool = False,
    sparse: bool = False,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Full POPCORN forward pass (model/popcorn.py:100-193).

    params: {'unet': dual-stream tree, 'head': {'l1'..'l4': {w,b}}}
    consts: {'unet_bn': BN constants, 'builder': {'params','bn'}}
    inputs: {'input': (B,H,W,C) normalized modality concat,
             optional 'building_counts': (B,H,W) or (B,H,W,1),
             optional 'admin_mask': (B,H,W), 'census_idx': (B,)}

    ``train`` differentiates the UNet blocks (except those frozen by the
    memory tiers ``encoder_no_grad`` / ``unet_no_grad``, which run their
    kernels without a gradient, nn/unet.py) and the head, whose training
    forward is kernel C with two channels and whose backward is kernel D
    (nn/head.py::head_train). Without ``train`` the whole model runs its
    kernels and the head emits channel 0 only: call it under no_grad
    (``popcorn_predict``), as the kernels refuse tensors that need a
    gradient. ``sparse`` draws the sparsity mask from ``generator``
    unless a precomputed ``mask`` (B,H,W) bool is given.

    Returns {'popcount': (B,), 'popdensemap': (B,H,W), 'scale': (B,H,W)
    or None, 'scale_abs_mean': mean |scale| (over the mask when sparse) or
    None, 'building_counts', and 'sparsity_mask' when sparse}.
    """
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

    if sparse and mask is None:
        if generator is None:
            raise ValueError("sparse=True requires a generator or a precomputed mask")
        mask = sparsity_mask(
            generator, building_counts, inputs["admin_mask"], inputs["census_idx"],
            occupancy=cfg.occupancy_model,
        )
    if not sparse:
        mask = None

    xp, pad = add_padding(x, force=padding)
    x6 = reorder_to_dda(xp, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir)
    trainable = train and not unet_no_grad
    feats = dual_stream_features(
        params["unet"], consts["unet_bn"], x6, s1=cfg.s1, s2=cfg.s2,
        train=trainable, encoder_stop_grad=encoder_no_grad,
        remat=cfg.remat_unet and trainable,
    )
    feats = revert_padding(feats, pad).contiguous()
    if train:
        out = head_train(params["head"], feats)[..., 0]
    else:
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
    if scale is None:
        scale_abs_mean = None
    elif mask is not None:
        # |scale| mean over the sparsity mask: the reference's mean over
        # scale[sparsity_mask]
        scale_abs_mean = torch.sum(torch.abs(scale) * mask) / torch.clamp(torch.sum(mask), min=1)
    else:
        scale_abs_mean = torch.mean(torch.abs(scale))
    result = {
        "popcount": popcount,
        "popdensemap": popdensemap,
        "scale": scale,
        "scale_abs_mean": scale_abs_mean,
        "building_counts": building_counts,
    }
    if mask is not None:
        result["sparsity_mask"] = mask
    return result

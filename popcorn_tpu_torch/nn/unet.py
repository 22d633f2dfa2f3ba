"""Dual-stream UNet built-up-area extractor (DDA, topology 8/16).

Counterpart of popcorn_tpu/nn/unet.py, over the same parameter trees
(HWIO weights, frozen BN as per-channel scale/shift) as torch tensors:

  - two independent UNet streams (SAR: 2ch, optical: 4ch), each
    inc -> down1 -> down2 -> up2(skip=down1) -> up1(skip=inc), every block
    DoubleConv = (conv3x3 -> frozen BN -> ReLU) x 2 (networks.py:253-271);
  - features = concat(sar 8ch, optical 8ch) = 16ch (networks.py:192-211);
  - building logits = fusion_out (1x1, 16->1) over the fused features when
    both streams are active, else the stream's own out conv.

Every DoubleConv goes through kernel A (nn/double_conv.py) and every Up
block through kernel B (nn/up_block.py) on CUDA; on the CPU both run
their plain versions. Tensors are NHWC.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .double_conv import double_conv as _double_conv
from .ops import conv1x1, max_pool_2x2
from .up_block import up_block

Tree = Dict[str, Any]

SAR_IN = 2  # VV, VH (utils/constants.py:176)
OPT_IN = 4  # B02, B03, B04, B08


def double_conv(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """(conv3x3 -> frozen BN -> ReLU) x 2 (reference: networks.py:253-271)."""
    return _double_conv(p, bn, x.contiguous())


def _up_block(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Up = tconv(x1) -> pad to x2 -> concat[x2, up] -> DoubleConv."""
    return up_block(p, bn, x1.contiguous(), x2.contiguous())


def unet_stream(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """One UNet stream, returning the pre-outconv 8ch features."""
    x1 = double_conv(p["inc"], bn["inc"], x)
    d1 = double_conv(p["down1"], bn["down1"], max_pool_2x2(x1))
    d2 = double_conv(p["down2"], bn["down2"], max_pool_2x2(d1))
    u2 = _up_block(p["up2"], bn["up2"], d2, d1)
    return _up_block(p["up1"], bn["up1"], u2, x1)


def dual_stream_features(
    p: Tree, bn: Tree, x6: torch.Tensor, *, s1: bool = True, s2: bool = True
) -> torch.Tensor:
    """Fused features: concat of the active streams' outputs.

    x6 is the 6-channel DDA-ordered input [VV, VH, B02, B03, B04, B08].
    """
    feats = []
    if s1:
        feats.append(unet_stream(p["sar"], bn["sar"], x6[..., :SAR_IN]))
    if s2:
        feats.append(unet_stream(p["opt"], bn["opt"], x6[..., SAR_IN:]))
    return torch.cat(feats, dim=-1)


def building_logits(
    p: Tree, bn: Tree, x6: torch.Tensor, *, s1: bool = True, s2: bool = True
) -> torch.Tensor:
    """Built-up logits (networks.py:213-237): fusion_out over the fused
    16ch features with both streams, else that stream's out conv."""
    if s1 and s2:
        return conv1x1(dual_stream_features(p, bn, x6), p["fusion_out"])
    if s1:
        return conv1x1(unet_stream(p["sar"], bn["sar"], x6[..., :SAR_IN]), p["sar_out"])
    return conv1x1(unet_stream(p["opt"], bn["opt"], x6[..., SAR_IN:]), p["opt_out"])

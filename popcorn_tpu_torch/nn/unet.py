"""Dual-stream UNet built-up-area extractor (DDA, topology 8/16).

Counterpart of popcorn_tpu/nn/unet.py, over the same parameter trees
(HWIO weights, frozen BN as per-channel scale/shift) as torch tensors:

  - two independent UNet streams (SAR: 2ch, optical: 4ch), each
    inc -> down1 -> down2 -> up2(skip=down1) -> up1(skip=inc), every block
    DoubleConv = (conv3x3 -> frozen BN -> ReLU) x 2 (networks.py:253-271);
  - features = concat(sar 8ch, optical 8ch) = 16ch (networks.py:192-211);
  - building logits = fusion_out (1x1, 16->1) over the fused features when
    both streams are active, else the stream's own out conv.

Gradient routing. A block that takes no gradient runs kernel A
(DoubleConv, nn/double_conv.py) or kernel B (Up block, nn/up_block.py)
under ``torch.no_grad()``; on the CPU both run their plain versions. That
is every block in eval, the encoder (inc, down1, down2) under
``encoder_stop_grad``, and every block when the caller freezes the whole
UNet. A block that trains runs the differentiable plain composition
(``F.conv2d``/einsum, frozen BN, ReLU) under autograd, optionally
recomputed in the backward (``remat``): the JAX package trains the same
blocks through XLA convs, not through its Pallas kernels
(popcorn_tpu/nn/popcorn.py::use_pallas_stream returns False in training).
The choice follows the explicit ``train``/``encoder_stop_grad`` arguments,
never a fallback. Tensors are NHWC.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .double_conv import double_conv as _double_conv_kernel
from .double_conv import double_conv_plain
from .ops import conv1x1, max_pool_2x2
from .up_block import up_block as _up_block_kernel
from .up_block import up_block_plain

Tree = Dict[str, Any]

SAR_IN = 2  # VV, VH (utils/constants.py:176)
OPT_IN = 4  # B02, B03, B04, B08


def double_conv(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """(conv3x3 -> frozen BN -> ReLU) x 2 through kernel A."""
    return _double_conv_kernel(p, bn, x.contiguous())


def _up_block(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Up = tconv(x1) -> pad to x2 -> concat[x2, up] -> DoubleConv, through
    kernel B."""
    return _up_block_kernel(p, bn, x1.contiguous(), x2.contiguous())


def _run(kernel_fn, plain_fn, trainable: bool, remat: bool, *args) -> torch.Tensor:
    """One block: its kernel without a gradient, or its differentiable
    plain composition (recomputed in the backward with ``remat``)."""
    if not trainable:
        with torch.no_grad():
            return kernel_fn(*args)
    if remat:
        return checkpoint(plain_fn, *args, use_reentrant=False)
    return plain_fn(*args)


def unet_stream(
    p: Tree,
    bn: Tree,
    x: torch.Tensor,
    *,
    train: bool = False,
    encoder_stop_grad: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """One UNet stream, returning the pre-outconv 8ch features.

    ``train`` makes the blocks trainable; ``encoder_stop_grad`` (the
    reference's ``encoder_no_grad``, networks.py:124-133) keeps the
    downward path frozen while up2/up1 still train."""
    enc = train and not encoder_stop_grad
    x1 = _run(double_conv, double_conv_plain, enc, remat, p["inc"], bn["inc"], x)
    d1 = _run(double_conv, double_conv_plain, enc, remat, p["down1"], bn["down1"], max_pool_2x2(x1))
    d2 = _run(double_conv, double_conv_plain, enc, remat, p["down2"], bn["down2"], max_pool_2x2(d1))
    u2 = _run(_up_block, up_block_plain, train, remat, p["up2"], bn["up2"], d2, d1)
    return _run(_up_block, up_block_plain, train, remat, p["up1"], bn["up1"], u2, x1)


def dual_stream_features(
    p: Tree,
    bn: Tree,
    x6: torch.Tensor,
    *,
    s1: bool = True,
    s2: bool = True,
    train: bool = False,
    encoder_stop_grad: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Fused features: concat of the active streams' outputs.

    x6 is the 6-channel DDA-ordered input [VV, VH, B02, B03, B04, B08].
    """
    kw = dict(train=train, encoder_stop_grad=encoder_stop_grad, remat=remat)
    feats = []
    if s1:
        feats.append(unet_stream(p["sar"], bn["sar"], x6[..., :SAR_IN], **kw))
    if s2:
        feats.append(unet_stream(p["opt"], bn["opt"], x6[..., SAR_IN:], **kw))
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

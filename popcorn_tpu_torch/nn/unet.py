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

Compute dtype. ``dtype=torch.bfloat16`` casts the stream's input to bf16
and keeps the blocks' outputs in bf16: kernels A and B round as the JAX
package's Pallas kernels do, the trainable blocks as its XLA ops do
(nn/ops.py). Parameters stay float32 and are cast per op.

Quantized eval. ``quantize=True`` (``ModelConfig.quantize == 'int8'``)
runs the blocks through the dynamic int8 kernels G (DoubleConv) and H (Up
block, reading and writing the compute dtype), with the JAX engine's
shape rule (popcorn_tpu/nn/packed.py::packed_unet_stream): all five
blocks when H % 4 == W % 4 == 0; when only H % 2 == W % 2 == 0, up2 stays
float (the JAX package runs it through its plain XLA block there);
otherwise every block stays float (its plain engine). ``unet_stream_qs`` is the static int8 stream ('int8s'/'w4a8'),
kernels E and F end to end with int8 block I/O, for calibrated scales and
H % 4 == W % 4 == 0.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .double_conv import double_conv as _double_conv_kernel
from .double_conv import double_conv_ops, double_conv_q, double_conv_qs
from .ops import conv1x1, max_pool_2x2
from .quant import quantize_static
from .up_block import up_block as _up_block_kernel
from .up_block import up_block_ops, up_block_q, up_block_qs

Tree = Dict[str, Any]

SAR_IN = 2  # VV, VH (utils/constants.py:176)
OPT_IN = 4  # B02, B03, B04, B08


def double_conv(p: Tree, bn: Tree, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """(conv3x3 -> frozen BN -> ReLU) x 2 through kernel A."""
    return _double_conv_kernel(p, bn, x.contiguous(), dtype)


def _up_block(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor, dtype=None) -> torch.Tensor:
    """Up = tconv(x1) -> pad to x2 -> concat[x2, up] -> DoubleConv, through
    kernel B."""
    return _up_block_kernel(p, bn, x1.contiguous(), x2.contiguous(), dtype)


def _run(kernel_fn, plain_fn, trainable: bool, remat: bool, *args) -> torch.Tensor:
    """One block: its kernel without a gradient, or its differentiable
    plain composition (recomputed in the backward with ``remat``)."""
    if not trainable:
        with torch.no_grad():
            return kernel_fn(*args)
    if remat:
        return checkpoint(plain_fn, *args, use_reentrant=False)
    return plain_fn(*args)


def _q_double_conv(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    return double_conv_q(p, bn, x.contiguous())


def _q_up_block(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return up_block_q(p, bn, x1.contiguous(), x2.contiguous())


def quantized_blocks(h: int, w: int) -> int:
    """How many of a stream's blocks the dynamic int8 path runs quantized
    for an (h, w) input, in stream order: 5, 4 (all but up2) or 0."""
    if h % 4 == 0 and w % 4 == 0:
        return 5
    if h % 2 == 0 and w % 2 == 0:
        return 4
    return 0


def unet_stream(
    p: Tree,
    bn: Tree,
    x: torch.Tensor,
    *,
    train: bool = False,
    encoder_stop_grad: bool = False,
    remat: bool = False,
    quantize: bool = False,
    dtype=None,
) -> torch.Tensor:
    """One UNet stream, returning the pre-outconv 8ch features (in
    ``dtype``, the compute dtype, or float32).

    ``train`` makes the blocks trainable; ``encoder_stop_grad`` (the
    reference's ``encoder_no_grad``, networks.py:124-133) keeps the
    downward path frozen while up2/up1 still train. ``quantize`` (eval
    only) runs the blocks that ``quantized_blocks`` names through the
    dynamic int8 kernels."""
    if dtype is not None:
        x = x.to(dtype)
    if quantize and not train:
        n = quantized_blocks(x.shape[1], x.shape[2])
        if n:
            with torch.no_grad():
                x1 = _q_double_conv(p["inc"], bn["inc"], x)
                d1 = _q_double_conv(p["down1"], bn["down1"], max_pool_2x2(x1))
                d2 = _q_double_conv(p["down2"], bn["down2"], max_pool_2x2(d1))
                if n == 5:
                    u2 = _q_up_block(p["up2"], bn["up2"], d2, d1)
                else:
                    u2 = _up_block(p["up2"], bn["up2"], d2, d1, dtype)
                return _q_up_block(p["up1"], bn["up1"], u2, x1)
    enc = train and not encoder_stop_grad
    dc = (double_conv, double_conv_ops, enc, remat)
    x1 = _run(*dc, p["inc"], bn["inc"], x, dtype)
    d1 = _run(*dc, p["down1"], bn["down1"], max_pool_2x2(x1), dtype)
    d2 = _run(*dc, p["down2"], bn["down2"], max_pool_2x2(d1), dtype)
    u2 = _run(_up_block, up_block_ops, train, remat, p["up2"], bn["up2"], d2, d1, dtype)
    return _run(_up_block, up_block_ops, train, remat, p["up1"], bn["up1"], u2, x1, dtype)


def unet_stream_qs(
    p: Tree, bn: Tree, x: torch.Tensor, scales: Dict[str, torch.Tensor], wbits: int = 8,
    dtype=None,
) -> torch.Tensor:
    """One UNet stream end to end in static int8 (the counterpart of
    popcorn_tpu/nn/packed.py::packed_unet_stream_qs): the input quantized
    at ``scales['in']`` from its float32 value, every block through kernel
    E or F with int8 block I/O, max-pooling on the int8 codes (the max of
    codes is the code of the max), float features out of up1: float32, or
    in ``dtype`` when given (the JAX kernel writes them in the compute
    dtype; kernel F rounds them to bf16 itself). Needs H % 4 == W % 4 == 0."""
    if x.shape[1] % 4 or x.shape[2] % 4:
        raise ValueError(f"unet_stream_qs: input {tuple(x.shape)} needs H and W divisible by 4")
    s = scales
    with torch.no_grad():
        x1 = double_conv_qs(p["inc"], bn["inc"], quantize_static(x, s["in"]),
                            s["in"], s["inc_y1"], s["inc_out"], wbits)
        d1 = double_conv_qs(p["down1"], bn["down1"], max_pool_2x2(x1),
                            s["inc_out"], s["down1_y1"], s["down1_out"], wbits)
        d2 = double_conv_qs(p["down2"], bn["down2"], max_pool_2x2(d1),
                            s["down1_out"], s["down2_y1"], s["down2_out"], wbits)
        u2 = up_block_qs(p["up2"], bn["up2"], d2, d1, s["down2_out"], s["down1_out"],
                         s["up2_up"], s["up2_y1"], s["up2_out"], wbits)
        u1 = up_block_qs(p["up1"], bn["up1"], u2, x1, s["up2_out"], s["inc_out"],
                         s["up1_up"], s["up1_y1"], None, wbits, dtype)
    return u1


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
    quantize: bool = False,
    dtype=None,
) -> torch.Tensor:
    """Fused features: concat of the active streams' outputs.

    x6 is the 6-channel DDA-ordered input [VV, VH, B02, B03, B04, B08].
    """
    kw = dict(train=train, encoder_stop_grad=encoder_stop_grad, remat=remat, quantize=quantize,
              dtype=dtype)
    feats = []
    if s1:
        feats.append(unet_stream(p["sar"], bn["sar"], x6[..., :SAR_IN], **kw))
    if s2:
        feats.append(unet_stream(p["opt"], bn["opt"], x6[..., SAR_IN:], **kw))
    return torch.cat(feats, dim=-1)


def building_logits(
    p: Tree, bn: Tree, x6: torch.Tensor, *, s1: bool = True, s2: bool = True,
    quantize: bool = False, dtype=None,
) -> torch.Tensor:
    """Built-up logits (networks.py:213-237): fusion_out over the fused
    16ch features with both streams, else that stream's out conv, in
    ``dtype``. ``quantize``: the dynamic int8 blocks, as in
    ``unet_stream``."""
    kw = dict(quantize=quantize, dtype=dtype)
    if s1 and s2:
        return conv1x1(dual_stream_features(p, bn, x6, **kw), p["fusion_out"], dtype)
    if s1:
        feats = unet_stream(p["sar"], bn["sar"], x6[..., :SAR_IN], **kw)
        return conv1x1(feats, p["sar_out"], dtype)
    feats = unet_stream(p["opt"], bn["opt"], x6[..., SAR_IN:], **kw)
    return conv1x1(feats, p["opt_out"], dtype)

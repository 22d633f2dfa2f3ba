"""The fused UNet Up block and its int8 variants.

A 2x2 stride-2 transposed conv of the coarse input x1, zero-padded to the
skip x2's size, then a DoubleConv over [skip | up] (concat order of
networks.py:318), on unpacked NHWC tensors.

Kernel B (csrc/up_block.cu), float32 or bfloat16: counterpart of
popcorn_tpu/nn/pallas_conv.py::fused_up_block (``_up_block_kernel``); its
two convs run on the tensor cores, in the float32-accurate 3xTF32 form,
or in bfloat16 with one TF32 MMA a product (a bf16 value is exact in
TF32). In bfloat16 it rounds where that kernel rounds: x1, the skip and
the weights are bf16, the upsampled tile is rounded to bf16 after its
bias (pallas_conv.py:521), y1 on chip and the output too; sums and
affines are float32. ``up_block_ops`` is the block as nn/ops.py ops (the
JAX package's XLA route, popcorn_tpu/nn/unet.py::_up_block): the route of
a block that trains.

Kernel F (csrc/up_block_qs.cu), static int8: counterpart of
``fused_up_block_qs`` (``_up_block_kernel_qs``). int8 codes in (x1 at
s_x1, the skip at s_x2); the tconv output requantized at s_up, clipped at
-127 (the reference tconv has no ReLU); conv1 as two parts, skip and up,
each with its own weight scales; y1 at s_y1 clipped at 0; int8 out at
s_out, or float features (up1, the stream's last block) in float32 or
rounded to bf16 in the kernel. The tconv's weight scales are per (tap,
channel) (nn/quant.py::quantize_tconv_weight): the kernel picks them by
the tap of the fine pixel.

Kernel H (csrc/up_block_q.cu), dynamic int8: counterpart of
``fused_up_block(quantized=True)`` (``_up_block_kernel_q``). float32 or
bf16 in and out (a bf16 value widens to float32 exactly; the output is
rounded to nearest even); per TILE x TILE output tile, the gathered
coarse input, the up tile, the skip tile and the y1 ring each take one
scale from their own max-abs. F and H run on the int8 tensor cores
(csrc/int8_mma.cuh).

Each public function takes the plain version for a tensor on the CPU and
launches the CUDA kernel for a tensor on the card; there is no fallback
between the two. The int8 plain versions compute what their kernels
compute, code for code.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

import torch.nn.functional as F

from . import cuda_lib
from .double_conv import KERNEL_SYMBOLS, double_conv_ops, double_conv_plain, fold_affine, storage_dtype
from .ops import conv_transpose_2x2, pad_to_match
from .quant import (
    QMAX,
    conv3x3_codes,
    inside_tiles,
    pack_dp4a,
    quantize_conv_weight,
    quantize_tconv_weight,
    quantize_tiles,
    requant,
    tiles,
    untile,
)

Tree = Dict[str, Any]



def up_block_ops(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor, dtype=None) -> torch.Tensor:
    """Up = tconv(x1) -> pad to x2 -> concat[x2, up] -> DoubleConv as
    nn/ops.py ops in ``dtype`` (popcorn_tpu/nn/unet.py::_up_block).
    Differentiable: the route of a block that trains."""
    up = pad_to_match(conv_transpose_2x2(x1, p["tconv"], dtype), x2)
    return double_conv_ops(p["conv"], bn, torch.cat([x2.to(up.dtype), up], dim=-1), dtype)


def up_block_plain(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor, dtype=None) -> torch.Tensor:
    """Kernel B in plain PyTorch, in the compute dtype ``dtype`` or x2's,
    rounded where pallas_conv.py::_up_block_kernel rounds (module
    docstring; every rounding is a no-op in float32)."""
    cdt = dtype or x2.dtype
    b, h, w, _ = x1.shape
    wt = p["tconv"]["w"].to(cdt).float()
    up = torch.einsum("bhwc,cijo->bhiwjo", x1.to(cdt).float(), wt)
    up = up.reshape(b, 2 * h, 2 * w, wt.shape[-1]) + p["tconv"]["b"].float()
    up = pad_to_match(up.to(cdt), x2)
    return double_conv_plain(p["conv"], bn, torch.cat([x2.to(cdt), up], dim=-1), cdt)


def up_block_cuda(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Launch kernel B on contiguous float32 or bfloat16 NHWC CUDA tensors
    (x1 and x2 of one dtype); the weights are rounded to it, the output is
    in it."""
    dt = storage_dtype("up_block", x2)
    wt, w1, w2 = (w.to(dt).contiguous() for w in (
        p["tconv"]["w"], p["conv"]["conv1"]["w"], p["conv"]["conv2"]["w"]))
    bt = p["tconv"]["b"].float().contiguous()
    s1, t1 = fold_affine(p["conv"]["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv"]["conv2"]["b"], bn["bn2"])
    f32 = torch.float32
    cuda_lib.require_cuda("up_block", [
        (x1, dt), (x2, dt), (wt, dt), (bt, f32), (w1, dt), (s1, f32), (t1, f32), (w2, dt),
        (s2, f32), (t2, f32)])
    b, h, w, c1 = x1.shape
    b2, hh, ww, cs = x2.shape
    cu, cm, cout = wt.shape[3], w1.shape[3], w2.shape[3]
    if (
        b2 != b
        or wt.shape != (c1, 2, 2, cu)
        or w1.shape != (3, 3, cs + cu, cm)
        or w2.shape != (3, 3, cm, cout)
    ):
        raise ValueError(
            f"up_block: shapes do not fit: x1 {tuple(x1.shape)}, x2 "
            f"{tuple(x2.shape)}, tconv {tuple(wt.shape)}, conv1 "
            f"{tuple(w1.shape)}, conv2 {tuple(w2.shape)}"
        )
    oy, ox = (hh - 2 * h) // 2, (ww - 2 * w) // 2
    if oy < 0 or ox < 0:
        raise ValueError(f"up_block: coarse {(h, w)} upsamples past the skip {(hh, ww)}")
    out = torch.empty((b, hh, ww, cout), device=x2.device, dtype=dt)
    if out.numel() == 0:
        return out
    if x2.data_ptr() % 16:  # the kernel stages the skip by 16-byte loads
        x2 = x2.clone()
    cuda_lib.launch("up_block", f"popcorn_up_block_{KERNEL_SYMBOLS[dt]}",
                    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12,
                    x1, x2, wt, bt, w1, s1, t1, w2, s2, t2, out,
                    b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout)
    return out


def up_block(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor, dtype=None) -> torch.Tensor:
    """The Up block in the compute dtype ``dtype`` (default x2's; both
    inputs are cast to it): plain PyTorch on the CPU, kernel B on CUDA."""
    cdt = dtype or x2.dtype
    x1, x2 = x1.to(cdt), x2.to(cdt)
    if x2.device.type == "cpu":
        return up_block_plain(p, bn, x1, x2)
    return up_block_cuda(p, bn, x1, x2)


def _check_up(name, x1, x2, wtq, waq, wbq, w2q):
    b, h, w, c1 = x1.shape
    b2, hh, ww, cs = x2.shape
    cu, cm, cout = wtq.shape[3], waq.shape[3], w2q.shape[3]
    if (
        b2 != b
        or wtq.shape != (c1, 2, 2, cu)
        or waq.shape != (3, 3, cs, cm)
        or wbq.shape != (3, 3, cu, cm)
        or w2q.shape != (3, 3, cm, cout)
    ):
        raise ValueError(
            f"{name}: shapes do not fit: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
            f"tconv {tuple(wtq.shape)}, conv1 {tuple(waq.shape)} + {tuple(wbq.shape)}, "
            f"conv2 {tuple(w2q.shape)}"
        )
    oy, ox = (hh - 2 * h) // 2, (ww - 2 * w) // 2
    if oy < 0 or ox < 0:
        raise ValueError(f"{name}: coarse {(h, w)} upsamples past the skip {(hh, ww)}")
    return b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout


def _split_conv1(p: Tree, wbits: int):
    """conv1's weight as its skip and up parts, each quantized with its own
    per-channel scales (the JAX package's two-part lifted conv1)."""
    w1 = p["conv"]["conv1"]["w"]
    cs = w1.shape[2] - p["tconv"]["w"].shape[3]
    waq, swa = quantize_conv_weight(w1[:, :, :cs], wbits)
    wbq, swb = quantize_conv_weight(w1[:, :, cs:], wbits)
    return waq, swa, wbq, swb


# ----------------------------------------------------------- kernel F (int8s)


def qs_args(p: Tree, bn: Tree, s_x1, s_x2, s_up, s_y1, s_out=None, wbits: int = 8):
    """Kernel F's operands, folded in the JAX package's order
    (pallas_conv.py::fused_up_block_qs): et = swt*(s_x1/s_up) per (tap,
    channel), gt = bt/s_up; ea = swa*s1*(s_x2/s_y1), eb = swb*s1*(s_up/s_y1),
    g1 = t1/s_y1; e2, g2 as kernel E's."""
    s1, t1 = fold_affine(p["conv"]["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv"]["conv2"]["b"], bn["bn2"])
    wtq, swt = quantize_tconv_weight(p["tconv"]["w"], wbits)
    waq, swa, wbq, swb = _split_conv1(p, wbits)
    w2q, sw2 = quantize_conv_weight(p["conv"]["conv2"]["w"], wbits)
    et, gt = swt * (s_x1 / s_up), p["tconv"]["b"].float() / s_up
    ea, eb = (swa * s1) * (s_x2 / s_y1), (swb * s1) * (s_up / s_y1)
    g1 = t1 / s_y1
    d2 = sw2 * s2
    if s_out is None:
        e2, g2 = d2 * s_y1, t2
    else:
        e2, g2 = d2 * (s_y1 / s_out), t2 / s_out
    return wtq, et, gt, waq, ea, wbq, eb, g1, w2q, e2, g2


def up_block_qs_plain(wtq, et, gt, waq, ea, wbq, eb, g1, w2q, e2, g2,
                      x1q: torch.Tensor, x2q: torch.Tensor, float_out: bool) -> torch.Tensor:
    """Kernel F in plain PyTorch: the tconv's integer sums requantized with
    the tap's scales (clip at -127), zero-padded to the skip; the two-part
    conv1 requantized at 0; conv2 requantized or float."""
    b, h, w, _ = x1q.shape
    acc = torch.einsum("bhwc,cijo->bhiwjo", x1q.float(), wtq.float())
    up = requant(acc, et[:, None], gt, -QMAX).reshape(b, 2 * h, 2 * w, wtq.shape[3])
    upq = pad_to_match(up, x2q)
    y1 = conv3x3_codes(x2q, waq) * ea + conv3x3_codes(upq, wbq) * eb
    y1q = torch.clamp(torch.round(y1 + g1), 0.0, QMAX).to(torch.int8)
    acc2 = conv3x3_codes(y1q, w2q)
    if float_out:
        return torch.relu(acc2 * e2 + g2)
    return requant(acc2, e2, g2, 0.0)


def qs_out_dtype(float_out: bool, dtype=None) -> torch.dtype:
    """Kernel F's output dtype: int8 codes, or the float features in
    ``dtype`` (float32 when None; bf16 is rounded in the kernel)."""
    if not float_out:
        return torch.int8
    dt = dtype or torch.float32
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"up_block_qs: float features in {dt}; the kernel writes float32 or bfloat16")
    return dt


def up_block_qs_cuda(wtq, et, gt, waq, ea, wbq, eb, g1, w2q, e2, g2,
                     x1q: torch.Tensor, x2q: torch.Tensor, float_out: bool,
                     out_dtype=None) -> torch.Tensor:
    """Launch kernel F on contiguous int8 NHWC CUDA tensors; float
    features in ``out_dtype`` (float32 or bfloat16; float32 when None)."""
    odt = qs_out_dtype(float_out, out_dtype)
    # tconv codes (C1, 2, 2, Cu) -> (4 taps, C1/4, Cu) words
    wtp = pack_dp4a(wtq.permute(1, 2, 0, 3))
    wap, wbp, w2p = pack_dp4a(waq), pack_dp4a(wbq), pack_dp4a(w2q)
    i8, f32 = torch.int8, torch.float32
    cuda_lib.require_cuda("up_block_qs", [
        (x1q, i8), (x2q, i8), (wtp, i8), (et, f32), (gt, f32), (wap, i8), (ea, f32),
        (wbp, i8), (eb, f32), (g1, f32), (w2p, i8), (e2, f32), (g2, f32)])
    b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout = _check_up(
        "up_block_qs", x1q, x2q, wtq, waq, wbq, w2q)
    out = torch.empty((b, hh, ww, cout), device=x2q.device, dtype=odt)
    if out.numel() == 0:
        return out
    args = [x1q, x2q, wtp, et, gt, wap, ea, wbp, eb, g1, w2p, e2, g2, out,
            b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout]
    # the bf16 entry always writes features; the other takes float_out
    bf16 = odt == torch.bfloat16
    cuda_lib.launch("up_block_qs", "popcorn_up_block_qs_bf16" if bf16 else "popcorn_up_block_qs",
                    [ctypes.c_void_p] * 14 + [ctypes.c_int] * (12 if bf16 else 13),
                    *args, *(() if bf16 else (int(float_out),)))
    return out


def up_block_qs(
    p: Tree, bn: Tree, x1q: torch.Tensor, x2q: torch.Tensor,
    s_x1, s_x2, s_up, s_y1, s_out=None, wbits: int = 8, dtype=None,
) -> torch.Tensor:
    """Static int8 Up block: coarse int8 ``x1q`` at ``s_x1`` and skip
    ``x2q`` at ``s_x2`` -> int8 at ``s_out``, or float features when
    ``s_out`` is None, in ``dtype`` (float32 when None; bf16 rounded to
    nearest even). Plain PyTorch on the CPU (float32, then rounded),
    kernel F on CUDA (which rounds itself)."""
    float_out = s_out is None
    odt = qs_out_dtype(float_out, dtype)
    args = qs_args(p, bn, s_x1, s_x2, s_up, s_y1, s_out, wbits)
    if x2q.device.type == "cpu":
        return up_block_qs_plain(*args, x1q, x2q, float_out).to(odt)
    return up_block_qs_cuda(*args, x1q, x2q, float_out, odt)


# ------------------------------------------------------------ kernel H (int8)


def q_args(p: Tree, bn: Tree):
    """Kernel H's operands (pallas_conv.py::fused_up_block, quantized):
    int8 weights, the tconv's scales dt per (tap, channel) and bias tt, the
    two conv1 parts' dequant vectors da = swa*s1, db = swb*s1 and shift t1,
    conv2's d2 = sw2*s2 and t2."""
    s1, t1 = fold_affine(p["conv"]["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv"]["conv2"]["b"], bn["bn2"])
    wtq, dt = quantize_tconv_weight(p["tconv"]["w"])
    waq, swa, wbq, swb = _split_conv1(p, 8)
    w2q, sw2 = quantize_conv_weight(p["conv"]["conv2"]["w"])
    tt = p["tconv"]["b"].float().contiguous()
    return wtq, dt, tt, waq, swa * s1, wbq, swb * s1, t1, w2q, sw2 * s2, t2


def up_block_q_plain(wtq, dt, tt, waq, da, wbq, db, t1, w2q, d2, t2,
                     x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Kernel H in plain PyTorch, tile by tile (each tile with a 2-pixel
    halo, zero outside the image): the skip at its scale s2x; the coarse
    input gathered at every fine pixel of the upsampled region (0
    elsewhere) at its scale s1x; up = acc * (dt[tap]*s1x) + tt there, 0
    elsewhere, at its scale su; y1 = relu(acc_a*(da*s2x) + acc_b*(db*su) +
    t1) on the ring, 0 outside the image, at sy; out = relu(acc2*(d2*sy) + t2)."""
    b, hh, ww, _ = x2.shape
    _, h, w, _ = x1.shape
    oy, ox = (hh - 2 * h) // 2, (ww - 2 * w) // 2
    dev = x2.device
    x2q, s2x = quantize_tiles(tiles(x2.float(), 2))
    pad = (0, 0, ox, ww - 2 * w - ox, oy, hh - 2 * h - oy)
    src = x1.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    x1q, s1x = quantize_tiles(tiles(F.pad(src, pad), 2))
    # each fine pixel's tap (dy*2 + dx) and whether it lies in the
    # upsampled region, as tiles
    tap = (torch.arange(2, device=dev)[:, None] * 2 + torch.arange(2, device=dev)[None, :]).float()
    tap = tap.repeat(h, w)[None, :, :, None]
    region = F.pad(torch.cat([tap + 1.0, torch.ones_like(tap)], dim=-1), pad)
    region = tiles(region, 2).repeat(b, 1, 1, 1)
    inside, tap = region[..., 1:] > 0, (region[..., 0] - 1.0).clamp_min(0).long()
    x1f = x1q.float()
    up_acc = torch.stack([x1f @ wtq[:, k // 2, k % 2, :].float() for k in range(4)], dim=-2)
    up_acc = up_acc.gather(-2, tap[..., None, None].expand(*tap.shape, 1, up_acc.shape[-1]))[..., 0, :]
    up = up_acc * (dt.reshape(4, -1)[tap] * s1x) + tt
    upq, su = quantize_tiles(torch.where(inside, up, 0.0))
    acc_a = conv3x3_codes(x2q, waq, same=False)
    acc_b = conv3x3_codes(upq, wbq, same=False)
    y1 = torch.relu(acc_a * (da * s2x) + acc_b * (db * su) + t1)
    y1 = torch.where(inside_tiles(b, hh, ww, 1, dev), y1, 0.0)
    y1q, sy = quantize_tiles(y1)
    out = torch.relu(conv3x3_codes(y1q, w2q, same=False) * (d2 * sy) + t2)
    return untile(out, b, hh, ww)


def q_io_dtype(x1: torch.Tensor, x2: torch.Tensor) -> torch.dtype:
    """The I/O dtype kernel H runs for these inputs: bfloat16 when both
    are bf16 (its bf16 mode, no conversion), else float32 (inputs widened,
    which is exact from bf16 and float16)."""
    if x1.dtype == x2.dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def up_block_q_cuda(wtq, dt, tt, waq, da, wbq, db, t1, w2q, d2, t2,
                    x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Launch kernel H on contiguous NHWC CUDA tensors, both float32 or
    both bfloat16; the output is in their dtype."""
    wtp = pack_dp4a(wtq.permute(1, 2, 0, 3))
    wap, wbp, w2p = pack_dp4a(waq), pack_dp4a(wbq), pack_dp4a(w2q)
    i8, f32 = torch.int8, torch.float32
    io = storage_dtype("up_block_q", x2)
    cuda_lib.require_cuda("up_block_q", [
        (x1, io), (x2, io), (wtp, i8), (dt, f32), (tt, f32), (wap, i8), (da, f32),
        (wbp, i8), (db, f32), (t1, f32), (w2p, i8), (d2, f32), (t2, f32)])
    b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout = _check_up(
        "up_block_q", x1, x2, wtq, waq, wbq, w2q)
    out = torch.empty((b, hh, ww, cout), device=x2.device, dtype=io)
    if out.numel() == 0:
        return out
    cuda_lib.launch("up_block_q", f"popcorn_up_block_q{'_bf16' if io == torch.bfloat16 else ''}",
                    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 12,
                    x1, x2, wtp, dt, tt, wap, da, wbp, db, t1, w2p, d2, t2, out,
                    b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout)
    return out


def up_block_q(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Dynamic int8 Up block, out in x2's dtype, the JAX kernel's rounding
    (nn/double_conv.py::double_conv_q): the inputs widened (exactly) to
    float32, the output rounded to x2's dtype. Plain PyTorch on the CPU;
    on CUDA kernel H, which takes two bfloat16 inputs as they are
    (``q_io_dtype``) and rounds its output itself."""
    args = q_args(p, bn)
    if x2.device.type == "cpu":
        return up_block_q_plain(*args, x1.float(), x2.float()).to(x2.dtype)
    io = q_io_dtype(x1, x2)
    return up_block_q_cuda(*args, x1.to(io), x2.to(io)).to(x2.dtype)

"""The fused UNet DoubleConv block and its int8 variants.

    relu(bn2(conv3x3(relu(bn1(conv3x3(x) + b1))) + b2))

Kernel A (csrc/double_conv.cu), float32 or bfloat16: counterpart of
popcorn_tpu/nn/pallas_conv.py::fused_double_conv (Pallas kernel
``_double_conv_kernel``) on plain NHWC tensors, both convs on the tensor
cores (float32 at float32 accuracy in the 3xTF32 form). In bfloat16 it rounds
where that kernel rounds: the input and the weights are bf16, the sums
and the folded affine float32, y1 is rounded to bf16 on chip and the
output is bf16. ``double_conv_ops`` is the same block as a composition of
nn/ops.py ops, which round after every op in bf16 as the JAX package's
XLA route (popcorn_tpu/nn/unet.py::double_conv) does: the route of the
blocks that train.

Kernel E (csrc/double_conv_qs.cu), static int8 (``quantize`` int8s and
w4a8): counterpart of ``fused_double_conv_qs`` (``_double_conv_kernel_qs``).
int8 codes in at the calibrated scale s_x, int8 weights per output channel,
int32 sums, one requant pass per conv (nn/quant.py::requant), int8 codes
out at s_out, or float32 with ``s_out=None`` (the stream's last block).

Kernel G (csrc/double_conv_q.cu), dynamic int8 (``quantize`` int8):
counterpart of ``fused_double_conv(quantized=True)``
(``_double_conv_kernel_q``). float32 in and out; the input tile and the y1
ring each take one scale from their own max-abs, per TILE x TILE output
tile (nn/quant.py::quantize_tiles).

Each public function takes the plain version for a tensor on the CPU and
launches the CUDA kernel for a tensor on the card; there is no fallback
between the two. The int8 plain versions compute what their kernels
compute, code for code.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .ops import conv3x3, frozen_bn, to_nchw, to_nhwc
from .quant import (
    conv3x3_codes,
    inside_tiles,
    pack_dp4a,
    quantize_conv_weight,
    quantize_tiles,
    requant,
    tiles,
    untile,
)

Tree = Dict[str, Any]

# launches of kernels A (float32 and bf16 modes apart), E and G, each
# counted where its wrapper launches it
launches = 0
launches_bf16 = 0
launches_qs = 0
launches_q = 0


def fold_affine(b: torch.Tensor, bn: Tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv + b) * scale + shift  ->  conv * s + t
    (popcorn_tpu/nn/pallas_conv.py::_fold_affine)."""
    s = bn["scale"].float()
    t = b.float() * s + bn["shift"].float()
    return s.contiguous(), t.contiguous()


def double_conv_ops(p: Tree, bn: Tree, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """(conv3x3 -> frozen BN -> ReLU) x 2 as nn/ops.py ops in ``dtype``
    (reference: networks.py:253-271; popcorn_tpu/nn/unet.py::double_conv).
    Differentiable: the route of a block that trains."""
    x = torch.relu(frozen_bn(conv3x3(x, p["conv1"], dtype), bn["bn1"]))
    return torch.relu(frozen_bn(conv3x3(x, p["conv2"], dtype), bn["bn2"]))


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 convolution of NHWC ``x`` by HWIO ``w``, both already
    rounded to the compute dtype, summed in float32: a bf16 x bf16 product
    is exact in float32, as in the Pallas kernels' _conv_rows."""
    return to_nhwc(F.conv2d(to_nchw(x.float()), w.float().permute(3, 2, 0, 1), padding=1))


def double_conv_plain(p: Tree, bn: Tree, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Kernel A in plain PyTorch, in the compute dtype ``dtype`` or x's,
    rounded where pallas_conv.py::_double_conv_kernel rounds (module
    docstring; every rounding is a no-op in float32). The zero padding of
    y1's conv stands in for the kernel's zeroed ring."""
    cdt = dtype or x.dtype
    s1, t1 = fold_affine(p["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv2"]["b"], bn["bn2"])
    y1 = torch.relu(conv3x3_f32(x.to(cdt), p["conv1"]["w"].to(cdt)) * s1 + t1).to(cdt)
    return torch.relu(conv3x3_f32(y1, p["conv2"]["w"].to(cdt)) * s2 + t2).to(cdt)


# each float kernel's C entry by storage dtype
KERNEL_SYMBOLS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def storage_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    """The float kernels' storage dtype, x's: float32 or bfloat16."""
    if x.dtype not in KERNEL_SYMBOLS:
        raise TypeError(f"{name}: input is {x.dtype}; the kernel takes float32 or bfloat16")
    return x.dtype


def double_conv_cuda(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel A on a contiguous float32 or bfloat16 NHWC CUDA
    tensor; the weights are rounded to x's dtype, the output is in it."""
    global launches, launches_bf16
    dt = storage_dtype("double_conv", x)
    w1, w2 = (p[k]["w"].to(dt).contiguous() for k in ("conv1", "conv2"))
    s1, t1 = fold_affine(p["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv2"]["b"], bn["bn2"])
    f32 = torch.float32
    cuda_lib.require_cuda("double_conv", [
        (x, dt), (w1, dt), (w2, dt), (s1, f32), (t1, f32), (s2, f32), (t2, f32)])
    b, h, w, cin = x.shape
    cm, cout = w1.shape[3], w2.shape[3]
    if w1.shape != (3, 3, cin, cm) or w2.shape != (3, 3, cm, cout):
        raise ValueError(
            f"double_conv: weights {tuple(w1.shape)}, {tuple(w2.shape)} do not "
            f"fit input channels {cin}"
        )
    out = torch.empty((b, h, w, cout), device=x.device, dtype=dt)
    if out.numel() == 0:
        return out
    fn = cuda_lib.function(
        "double_conv", f"popcorn_double_conv_{KERNEL_SYMBOLS[dt]}",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    P = cuda_lib.ptr
    rc = fn(
        P(x), P(w1), P(s1), P(t1), P(w2), P(s2), P(t2), P(out),
        b, h, w, cin, cm, cout, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(rc, "double_conv")
    if dt == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def double_conv(p: Tree, bn: Tree, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The DoubleConv block in the compute dtype ``dtype`` (default x's;
    x is cast to it): plain PyTorch on the CPU, kernel A on CUDA."""
    x = x.to(dtype or x.dtype)
    if x.device.type == "cpu":
        return double_conv_plain(p, bn, x)
    return double_conv_cuda(p, bn, x)


# ----------------------------------------------------------- kernel E (int8s)


def qs_args(p: Tree, bn: Tree, s_x, s_y1, s_out=None, wbits: int = 8):
    """Kernel E's operands: the int8 weights and the requant vectors, folded
    in the JAX package's order (pallas_conv.py::fused_double_conv_qs):
    e1 = sw1*s1*(s_x/s_y1), g1 = t1/s_y1; e2 = sw2*s2*(s_y1/s_out),
    g2 = t2/s_out, or e2 = sw2*s2*s_y1, g2 = t2 for a float output. The
    scales are float32 0-d tensors."""
    s1, t1 = fold_affine(p["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv2"]["b"], bn["bn2"])
    w1q, sw1 = quantize_conv_weight(p["conv1"]["w"], wbits)
    w2q, sw2 = quantize_conv_weight(p["conv2"]["w"], wbits)
    d1, d2 = sw1 * s1, sw2 * s2
    e1, g1 = d1 * (s_x / s_y1), t1 / s_y1
    if s_out is None:
        e2, g2 = d2 * s_y1, t2
    else:
        e2, g2 = d2 * (s_y1 / s_out), t2 / s_out
    return w1q, e1, g1, w2q, e2, g2


def double_conv_qs_plain(w1q, e1, g1, w2q, e2, g2, xq: torch.Tensor, float_out: bool) -> torch.Tensor:
    """Kernel E in plain PyTorch: exact integer convs, SAME zero padding of
    the y1 codes, requant clipped at 0 (the ReLU)."""
    y1q = requant(conv3x3_codes(xq, w1q), e1, g1, 0.0)
    acc2 = conv3x3_codes(y1q, w2q)
    if float_out:
        return torch.relu(acc2 * e2 + g2)
    return requant(acc2, e2, g2, 0.0)


def double_conv_qs_cuda(w1q, e1, g1, w2q, e2, g2, xq: torch.Tensor, float_out: bool) -> torch.Tensor:
    """Launch kernel E on a contiguous int8 NHWC CUDA tensor."""
    global launches_qs
    w1p, w2p = pack_dp4a(w1q), pack_dp4a(w2q)
    i8, f32 = torch.int8, torch.float32
    cuda_lib.require_cuda("double_conv_qs", [
        (xq, i8), (w1p, i8), (e1, f32), (g1, f32), (w2p, i8), (e2, f32), (g2, f32)])
    b, h, w, cin = xq.shape
    cm, cout = w1q.shape[3], w2q.shape[3]
    if w1q.shape != (3, 3, cin, cm) or w2q.shape != (3, 3, cm, cout):
        raise ValueError(
            f"double_conv_qs: weights {tuple(w1q.shape)}, {tuple(w2q.shape)} do not "
            f"fit input channels {cin}"
        )
    out = torch.empty((b, h, w, cout), device=xq.device, dtype=f32 if float_out else i8)
    if out.numel() == 0:
        return out
    fn = cuda_lib.function(
        "double_conv_qs", "popcorn_double_conv_qs",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    P = cuda_lib.ptr
    rc = fn(
        P(xq), P(w1p), P(e1), P(g1), P(w2p), P(e2), P(g2), P(out),
        b, h, w, cin, cm, cout, int(float_out), cuda_lib.stream_ptr(xq.device),
    )
    cuda_lib.check(rc, "double_conv_qs")
    launches_qs += 1
    return out


def double_conv_qs(
    p: Tree, bn: Tree, xq: torch.Tensor, s_x, s_y1, s_out=None, wbits: int = 8
) -> torch.Tensor:
    """Static int8 DoubleConv: int8 ``xq`` at scale ``s_x`` -> int8 at
    ``s_out``, or float32 when ``s_out`` is None. Plain PyTorch on the CPU,
    kernel E on CUDA."""
    args = qs_args(p, bn, s_x, s_y1, s_out, wbits)
    if xq.device.type == "cpu":
        return double_conv_qs_plain(*args, xq, s_out is None)
    return double_conv_qs_cuda(*args, xq, s_out is None)


# ------------------------------------------------------------ kernel G (int8)


def q_args(p: Tree, bn: Tree):
    """Kernel G's operands: int8 weights and the dequant vectors d = sw * s
    with the shifts t (pallas_conv.py::fused_double_conv, quantized)."""
    s1, t1 = fold_affine(p["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv2"]["b"], bn["bn2"])
    w1q, sw1 = quantize_conv_weight(p["conv1"]["w"])
    w2q, sw2 = quantize_conv_weight(p["conv2"]["w"])
    return w1q, sw1 * s1, t1, w2q, sw2 * s2, t2


def double_conv_q_plain(w1q, d1, t1, w2q, d2, t2, x: torch.Tensor) -> torch.Tensor:
    """Kernel G in plain PyTorch, tile by tile: the staged input (the tile
    and its 2-pixel halo, zero outside the image) quantized at its own
    scale sx; y1 = relu(acc * (d1*sx) + t1) on the 1-pixel ring, 0 outside
    the image, quantized at its own scale sy; out = relu(acc2 * (d2*sy) + t2)."""
    b, h, w, _ = x.shape
    xq, sx = quantize_tiles(tiles(x.float(), 2))
    y1 = torch.relu(conv3x3_codes(xq, w1q, same=False) * (d1 * sx) + t1)
    y1 = torch.where(inside_tiles(b, h, w, 1, x.device), y1, 0.0)
    y1q, sy = quantize_tiles(y1)
    out = torch.relu(conv3x3_codes(y1q, w2q, same=False) * (d2 * sy) + t2)
    return untile(out, b, h, w)


def double_conv_q_cuda(w1q, d1, t1, w2q, d2, t2, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel G on a contiguous float32 NHWC CUDA tensor."""
    global launches_q
    w1p, w2p = pack_dp4a(w1q), pack_dp4a(w2q)
    i8, f32 = torch.int8, torch.float32
    cuda_lib.require_cuda("double_conv_q", [
        (x, f32), (w1p, i8), (d1, f32), (t1, f32), (w2p, i8), (d2, f32), (t2, f32)])
    b, h, w, cin = x.shape
    cm, cout = w1q.shape[3], w2q.shape[3]
    if w1q.shape != (3, 3, cin, cm) or w2q.shape != (3, 3, cm, cout):
        raise ValueError(
            f"double_conv_q: weights {tuple(w1q.shape)}, {tuple(w2q.shape)} do not "
            f"fit input channels {cin}"
        )
    out = torch.empty((b, h, w, cout), device=x.device, dtype=f32)
    if out.numel() == 0:
        return out
    fn = cuda_lib.function(
        "double_conv_q", "popcorn_double_conv_q",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    P = cuda_lib.ptr
    rc = fn(
        P(x), P(w1p), P(d1), P(t1), P(w2p), P(d2), P(t2), P(out),
        b, h, w, cin, cm, cout, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(rc, "double_conv_q")
    launches_q += 1
    return out


def double_conv_q(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """Dynamic int8 DoubleConv, out in x's dtype: plain PyTorch on the CPU,
    kernel G on CUDA. Kernel G reads and writes float32: a bfloat16 input
    is widened (exactly; the JAX kernel quantizes its bf16 slab from its
    float32 value too) and the output rounded to bf16, as the JAX kernel
    writes it in the compute dtype."""
    args = q_args(p, bn)
    xf = x.float()
    out = double_conv_q_plain(*args, xf) if x.device.type == "cpu" else double_conv_q_cuda(*args, xf)
    return out.to(x.dtype)

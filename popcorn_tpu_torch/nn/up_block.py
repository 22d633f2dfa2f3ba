"""Kernel B: the fused UNet Up block (csrc/up_block.cu).

Counterpart of popcorn_tpu/nn/pallas_conv.py::fused_up_block (Pallas
kernel ``_up_block_kernel``) on unpacked NHWC tensors: a 2x2 stride-2
transposed conv of the coarse input x1, zero-padded to the skip x2's size,
then a DoubleConv over [skip | up] (concat order of networks.py:318).

``up_block`` takes the plain version for a tensor on the CPU and launches
the CUDA kernel for a tensor on the card; there is no fallback between the
two.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from . import cuda_lib
from .double_conv import double_conv_plain, fold_affine
from .ops import conv_transpose_2x2, pad_to_match

Tree = Dict[str, Any]

# launches of the CUDA kernel, counted where the wrapper launches it
launches = 0


def up_block_plain(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Up = tconv(x1) -> pad to x2 -> concat[x2, up] -> DoubleConv, in plain
    PyTorch (popcorn_tpu/nn/unet.py::_up_block)."""
    up = pad_to_match(conv_transpose_2x2(x1, p["tconv"]), x2)
    return double_conv_plain(p["conv"], bn, torch.cat([x2, up], dim=-1))


def up_block_cuda(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Launch kernel B on contiguous float32 NHWC CUDA tensors."""
    global launches
    wt, bt = p["tconv"]["w"], p["tconv"]["b"]
    w1, w2 = p["conv"]["conv1"]["w"], p["conv"]["conv2"]["w"]
    s1, t1 = fold_affine(p["conv"]["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv"]["conv2"]["b"], bn["bn2"])
    cuda_lib.require_cuda_f32("up_block", x1, x2, wt, bt, w1, s1, t1, w2, s2, t2)
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
    out = torch.empty((b, hh, ww, cout), device=x2.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = cuda_lib.function(
        "up_block", "popcorn_up_block_f32",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    )
    P = cuda_lib.ptr
    rc = fn(
        P(x1), P(x2), P(wt), P(bt), P(w1), P(s1), P(t1), P(w2), P(s2), P(t2), P(out),
        b, hh, ww, h, w, oy, ox, c1, cs, cu, cm, cout,
        cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(rc, "up_block")
    launches += 1
    return out


def up_block(p: Tree, bn: Tree, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The Up block: plain PyTorch on the CPU, kernel B on CUDA."""
    if x2.device.type == "cpu":
        return up_block_plain(p, bn, x1, x2)
    return up_block_cuda(p, bn, x1, x2)

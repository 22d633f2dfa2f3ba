"""Kernel A: the fused UNet DoubleConv block (csrc/double_conv.cu).

Counterpart of popcorn_tpu/nn/pallas_conv.py::fused_double_conv (Pallas
kernel ``_double_conv_kernel``) on plain NHWC tensors:

    relu(bn2(conv3x3(relu(bn1(conv3x3(x) + b1))) + b2))

``double_conv`` takes the plain version for a tensor on the CPU and
launches the CUDA kernel for a tensor on the card; there is no fallback
between the two.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from . import cuda_lib
from .ops import conv3x3, frozen_bn

Tree = Dict[str, Any]

# launches of the CUDA kernel, counted where the wrapper launches it
launches = 0


def fold_affine(b: torch.Tensor, bn: Tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv + b) * scale + shift  ->  conv * s + t
    (popcorn_tpu/nn/pallas_conv.py::_fold_affine)."""
    s = bn["scale"].float()
    t = b.float() * s + bn["shift"].float()
    return s.contiguous(), t.contiguous()


def double_conv_plain(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """(conv3x3 -> frozen BN -> ReLU) x 2 in plain PyTorch
    (reference: networks.py:253-271)."""
    x = torch.relu(frozen_bn(conv3x3(x, p["conv1"]), bn["bn1"]))
    return torch.relu(frozen_bn(conv3x3(x, p["conv2"]), bn["bn2"]))


def double_conv_cuda(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel A on a contiguous float32 NHWC CUDA tensor."""
    global launches
    w1, w2 = p["conv1"]["w"], p["conv2"]["w"]
    s1, t1 = fold_affine(p["conv1"]["b"], bn["bn1"])
    s2, t2 = fold_affine(p["conv2"]["b"], bn["bn2"])
    cuda_lib.require_cuda_f32("double_conv", x, w1, w2, s1, t1, s2, t2)
    b, h, w, cin = x.shape
    cm, cout = w1.shape[3], w2.shape[3]
    if w1.shape != (3, 3, cin, cm) or w2.shape != (3, 3, cm, cout):
        raise ValueError(
            f"double_conv: weights {tuple(w1.shape)}, {tuple(w2.shape)} do not "
            f"fit input channels {cin}"
        )
    out = torch.empty((b, h, w, cout), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = cuda_lib.function(
        "double_conv", "popcorn_double_conv_f32",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    P = cuda_lib.ptr
    rc = fn(
        P(x), P(w1), P(s1), P(t1), P(w2), P(s2), P(t2), P(out),
        b, h, w, cin, cm, cout, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(rc, "double_conv")
    launches += 1
    return out


def double_conv(p: Tree, bn: Tree, x: torch.Tensor) -> torch.Tensor:
    """The DoubleConv block: plain PyTorch on the CPU, kernel A on CUDA."""
    if x.device.type == "cpu":
        return double_conv_plain(p, bn, x)
    return double_conv_cuda(p, bn, x)

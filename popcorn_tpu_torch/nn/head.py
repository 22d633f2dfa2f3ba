"""Kernel C: the fused POPCORN head (csrc/head.cu).

The head is a per-pixel MLP 16 -> 64 -> 64 -> 64 -> 2 with ReLUs
(model/popcorn.py:80-85). Counterpart of popcorn_tpu/nn/pallas_head.py::
fused_head (``n_out=2``) and of popcorn_tpu/nn/pallas_packed_head.py::
fused_packed_head (``n_out=1``: channel 0 only, which is all the member
fold uses; the packed kernels are TPU lane layouts of that same function).

``head_apply`` takes the plain version for a tensor on the CPU and
launches the CUDA kernel for a tensor on the card; there is no fallback
between the two. Forward only: the head's backward belongs to training.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from . import cuda_lib

Tree = Dict[str, Any]

HEAD_LAYERS = ("l1", "l2", "l3", "l4")
DIMS = (16, 64, 64, 64, 2)

# launches of the CUDA kernel, counted where the wrapper launches it
launches = 0


def head_plain(p: Tree, feats: torch.Tensor, n_out: int = 2) -> torch.Tensor:
    """Four channel matmuls with ReLUs between them; the last layer keeps
    its first ``n_out`` output channels."""
    x = feats
    for name in HEAD_LAYERS[:-1]:
        x = torch.relu(torch.matmul(x, p[name]["w"]) + p[name]["b"])
    return torch.matmul(x, p["l4"]["w"][:, :n_out]) + p["l4"]["b"][:n_out]


def head_cuda(p: Tree, feats: torch.Tensor, n_out: int = 2) -> torch.Tensor:
    """Launch kernel C on (..., 16) contiguous float32 CUDA features."""
    global launches
    if n_out not in (1, 2):
        raise ValueError(f"head: n_out must be 1 or 2, got {n_out}")
    wts = []
    for name, (ci, co) in zip(HEAD_LAYERS, zip(DIMS[:-1], DIMS[1:])):
        w, b = p[name]["w"], p[name]["b"]
        if w.shape != (ci, co) or b.shape != (co,):
            raise ValueError(f"head: {name} is {tuple(w.shape)}/{tuple(b.shape)}, expected {(ci, co)}")
        wts += [w, b]
    cuda_lib.require_cuda_f32("head", feats, *wts)
    if feats.shape[-1] != DIMS[0]:
        raise ValueError(f"head: expected {DIMS[0]} input channels, got {feats.shape[-1]}")
    lead = feats.shape[:-1]
    n = feats.numel() // DIMS[0]
    out = torch.empty((*lead, n_out), device=feats.device, dtype=torch.float32)
    if n == 0:
        return out
    fn = cuda_lib.function(
        "head", "popcorn_head_f32",
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    )
    P = cuda_lib.ptr
    rc = fn(
        P(feats), *(P(t) for t in wts), P(out), n, n_out,
        cuda_lib.stream_ptr(feats.device),
    )
    cuda_lib.check(rc, "head")
    launches += 1
    return out


def head_apply(p: Tree, feats: torch.Tensor, n_out: int = 2) -> torch.Tensor:
    """(..., 16) features -> (..., n_out): plain PyTorch on the CPU,
    kernel C on CUDA."""
    if feats.device.type == "cpu":
        return head_plain(p, feats, n_out)
    return head_cuda(p, feats, n_out)

"""Kernels C and D: the fused POPCORN head (csrc/head.cu) and its
backward (csrc/head_bwd.cu).

The head is a per-pixel MLP 16 -> 64 -> 64 -> 64 -> 2 with ReLUs
(model/popcorn.py:80-85). Kernel C is the counterpart of
popcorn_tpu/nn/pallas_head.py::fused_head (``n_out=2``) and of
popcorn_tpu/nn/pallas_packed_head.py::fused_packed_head (``n_out=1``:
channel 0 only, which is all the member fold uses; the packed kernels are
TPU lane layouts of that same function). Kernel D is the backward of
fused_head's custom VJP (pallas_head.py::_bwd_kernel), and ``head_train``
is the ``torch.autograd.Function`` that pairs the two, as ``_head_flat``
does: its forward is kernel C with two channels and saves only the input
and the weights; its backward recomputes the activations in kernel D.
Both run their products on the tensor cores in the float32-accurate
3xTF32 form.

Compute dtype. float32 features run the head in float32. bfloat16
features, with one output channel, run it as
pallas_packed_head.py::_blockdiag_kernel_cdt does: bf16 features and
weights, float32 biases and sums, h1..h3 rounded to bf16, a bf16 output.
The training head (``head_train``) is fused_head, float32 whatever the
features' dtype (pallas_head.py:43): it widens bf16 features and returns
their gradient in bf16.

Each wrapper takes the plain version for a tensor on the CPU and launches
its CUDA kernel for a tensor on the card; there is no fallback between
the two. ``head_unfused`` is the head the user selects with
``--no_fused_head``: plain ops on every device, no kernel.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import cuda_lib
from .ops import conv1x1

Tree = Dict[str, Any]

HEAD_LAYERS = ("l1", "l2", "l3", "l4")
DIMS = (16, 64, 64, 64, 2)



def head_plain(p: Tree, feats: torch.Tensor, n_out: int = 2) -> torch.Tensor:
    """Four channel matmuls with ReLUs between them; the last layer keeps
    its first ``n_out`` output channels. In the features' dtype, float32
    or bfloat16, rounded as kernel C rounds (module docstring; every
    rounding is a no-op in float32)."""
    cdt = feats.dtype
    x = feats
    for name in HEAD_LAYERS[:-1]:
        w = p[name]["w"].to(cdt).float()
        x = torch.relu(torch.matmul(x.float(), w) + p[name]["b"].float()).to(cdt)
    w4 = p["l4"]["w"][:, :n_out].to(cdt).float()
    return (torch.matmul(x.float(), w4) + p["l4"]["b"][:n_out].float()).to(cdt)


def head_cuda(p: Tree, feats: torch.Tensor, n_out: int = 2) -> torch.Tensor:
    """Launch kernel C on (..., 16) contiguous CUDA features: float32 with
    one or two output channels, or bfloat16 with one; the output is in the
    features' dtype."""
    if n_out not in (1, 2):
        raise ValueError(f"head: n_out must be 1 or 2, got {n_out}")
    bf16 = feats.dtype == torch.bfloat16
    if bf16 and n_out != 1:
        raise ValueError("head: the bfloat16 kernel emits channel 0 only (n_out=1)")
    wdt = feats.dtype if bf16 else torch.float32
    typed = [(feats, wdt)]
    wts = []
    for name, (ci, co) in zip(HEAD_LAYERS, zip(DIMS[:-1], DIMS[1:])):
        w, b = p[name]["w"], p[name]["b"]
        if w.shape != (ci, co) or b.shape != (co,):
            raise ValueError(f"head: {name} is {tuple(w.shape)}/{tuple(b.shape)}, expected {(ci, co)}")
        w = w.to(wdt).contiguous()
        typed += [(w, wdt), (b, torch.float32)]
        wts += [w, b]
    cuda_lib.require_cuda("head", typed)
    if feats.shape[-1] != DIMS[0]:
        raise ValueError(f"head: expected {DIMS[0]} input channels, got {feats.shape[-1]}")
    # the kernel reads a pixel's features as one 16-byte (bf16: 8-byte) load
    if feats.data_ptr() % 16:
        feats = feats.clone()
    lead = feats.shape[:-1]
    n = feats.numel() // DIMS[0]
    out = torch.empty((*lead, n_out), device=feats.device, dtype=wdt)
    if n == 0:
        return out
    cuda_lib.launch("head", "popcorn_head_bf16" if bf16 else "popcorn_head_f32",
                    [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int],
                    feats, *wts, out, n, n_out)
    return out


def head_unfused(p: Tree, feats: torch.Tensor, dtype=None) -> torch.Tensor:
    """The head as four nn/ops.py 1x1 convs with ReLUs between them, in the
    compute dtype ``dtype`` (None: float32), under autograd: JAX's
    ``head_apply(..., fused=False)`` (popcorn_tpu/nn/popcorn.py:73-91),
    the route ``ModelConfig(fused_head=False)`` selects. It launches
    neither kernel C nor kernel D. (..., 16) -> (..., 2) in ``dtype``."""
    x = feats
    for name in HEAD_LAYERS[:-1]:
        x = torch.relu(conv1x1(x, p[name], dtype))
    return conv1x1(x, p["l4"], dtype)


def head_apply(p: Tree, feats: torch.Tensor, n_out: int = 2) -> torch.Tensor:
    """(..., 16) features -> (..., n_out) in their dtype (float32, or
    bfloat16 with ``n_out=1``): plain PyTorch on the CPU, kernel C on
    CUDA."""
    if feats.device.type == "cpu":
        return head_plain(p, feats, n_out)
    return head_cuda(p, feats, n_out)


# -- backward: kernel D -------------------------------------------------------

# kernel D's sizes, as csrc/head_bwd.cu fixes them: the flat gradient
# vector [dW1 db1 ... dW4 db4], the pixels of a tile, and the most blocks
# of its persistent grid (two on each of the H100's 132 SMs), each writing
# one partial row
BWD_NPART = sum(ci * co + co for ci, co in zip(DIMS[:-1], DIMS[1:]))  # 9538
BWD_TILE = 64
BWD_MAX_BLOCKS = 132 * 2


def _weights(p: Tree) -> List[torch.Tensor]:
    return [p[name][k] for name in HEAD_LAYERS for k in ("w", "b")]


def _tree(wts) -> Tree:
    return {name: {"w": wts[2 * i], "b": wts[2 * i + 1]} for i, name in enumerate(HEAD_LAYERS)}


def head_bwd_plain(
    p: Tree, feats: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The head's backward in plain PyTorch: autograd through head_plain
    (two channels) for the cotangent ``g`` (..., 2). Returns dx and the
    gradients of [w1, b1, ..., w4, b4]."""
    with torch.enable_grad():
        x = feats.detach().requires_grad_(True)
        wts = [w.detach().requires_grad_(True) for w in _weights(p)]
        out = head_plain(_tree(wts), x, 2)
        grads = torch.autograd.grad(out, [x, *wts], g)
    return grads[0], list(grads[1:])


def head_bwd_cuda(
    p: Tree, feats: torch.Tensor, g: torch.Tensor, need_dx: bool = True
) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Launch kernel D on contiguous float32 CUDA tensors: features
    (..., 16) and cotangent (..., 2). Returns dx (None unless ``need_dx``)
    and the gradients of [w1, b1, ..., w4, b4], summed over all pixels."""
    wts = _weights(p)
    shapes = [s for ci, co in zip(DIMS[:-1], DIMS[1:]) for s in ((ci, co), (co,))]
    for w, s in zip(wts, shapes):
        if tuple(w.shape) != s:
            raise ValueError(f"head_bwd: a weight is {tuple(w.shape)}, expected {s}")
    cuda_lib.require_cuda_f32("head_bwd", feats, g, *wts)
    if feats.shape[-1] != DIMS[0] or g.shape != (*feats.shape[:-1], DIMS[-1]):
        raise ValueError(
            f"head_bwd: features {tuple(feats.shape)} and cotangent {tuple(g.shape)} "
            f"do not fit a {DIMS[0]} -> {DIMS[-1]} head"
        )
    n = feats.numel() // DIMS[0]
    dev = feats.device
    # the kernel stages x and g by 16-byte cp.async: a view that starts
    # off that alignment is copied to a fresh (aligned) allocation
    feats, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (feats, g))
    dx = torch.empty_like(feats) if need_dx else None
    if n == 0:
        return dx, [torch.zeros_like(w) for w in wts]
    nblocks = min(-(-n // BWD_TILE), BWD_MAX_BLOCKS)
    part = torch.empty((nblocks, BWD_NPART), device=dev, dtype=torch.float32)
    flat = torch.empty((BWD_NPART,), device=dev, dtype=torch.float32)
    cuda_lib.launch("head_bwd", "popcorn_head_bwd_f32",
                    [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_int],
                    feats, g, *wts[:-1], dx, part, flat, n, nblocks)
    grads, off = [], 0
    for w in wts:  # the flat order is [dW1 db1 dW2 db2 dW3 db3 dW4 db4]
        grads.append(flat[off : off + w.numel()].view(w.shape))
        off += w.numel()
    return dx, grads


class _HeadTrain(torch.autograd.Function):
    """Two-channel head with a recomputing backward (the ``_head_flat``
    custom VJP): kernels C and D on CUDA, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, feats, *wts):
        ctx.save_for_backward(feats, *wts)
        return head_apply(_tree(wts), feats.float(), n_out=2)

    @staticmethod
    def backward(ctx, g):
        feats, *wts = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        g, x = g.contiguous(), feats.float()
        if feats.device.type == "cpu":
            dx, grads = head_bwd_plain(_tree(wts), x, g)
        else:
            dx, grads = head_bwd_cuda(_tree(wts), x, g, need_dx)
        # dx in the features' dtype (pallas_head.py:143)
        return (dx.to(feats.dtype) if need_dx else None, *grads)


def head_train(p: Tree, feats: torch.Tensor) -> torch.Tensor:
    """(..., 16) features -> (..., 2) float32, differentiable in the
    features and every head parameter; the training head (nn/popcorn.py).
    float32 whatever the features' dtype, as fused_head."""
    return _HeadTrain.apply(feats.contiguous(), *_weights(p))

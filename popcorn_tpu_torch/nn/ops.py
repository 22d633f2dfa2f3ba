"""Plain PyTorch NN ops of the POPCORN model, NHWC.

The port keeps the JAX package's NHWC layout and HWIO weights at its
public functions (popcorn_tpu/nn/ops.py), so the two packages compare like
with like; torch's NCHW convolutions are reached through permutes. These
are the plain versions: the fused UNet blocks (nn/double_conv.py,
nn/up_block.py) use them on the CPU and launch CUDA kernels on the card.

``dtype`` (None or torch.bfloat16) is the compute dtype of the JAX
package's XLA ops: the input and the float32 parameters are cast to it,
the products accumulate in float32 and the output is rounded to it; the
bias and the frozen BN are then applied in that dtype. This is the route
of the trainable UNet blocks (and of the 1x1 output convs); the fused
kernels round in fewer places, as the JAX package's Pallas kernels do.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _cast(x: torch.Tensor, w: torch.Tensor, dtype):
    if dtype is None:
        return x, w
    return x.to(dtype), w.to(dtype)


def conv3x3(x: torch.Tensor, p: Params, dtype=None) -> torch.Tensor:
    """3x3 same-padding convolution (+bias). p['w']: (3,3,Cin,Cout) HWIO."""
    x, w = _cast(x, p["w"], dtype)
    y = F.conv2d(to_nchw(x), w.permute(3, 2, 0, 1), padding=1)  # HWIO -> OIHW
    return to_nhwc(y) + p["b"].to(y.dtype)


def conv1x1(x: torch.Tensor, p: Params, dtype=None) -> torch.Tensor:
    """1x1 convolution as a channel matmul. p['w']: (Cin, Cout)."""
    x, w = _cast(x, p["w"], dtype)
    y = torch.matmul(x, w)
    return y + p["b"].to(y.dtype)


def frozen_bn(x: torch.Tensor, bn: Params) -> torch.Tensor:
    """Frozen BatchNorm as a per-channel affine (scale, shift folded from
    the running stats when the weights are loaded, compat/weights.py), in
    the input's dtype."""
    return x * bn["scale"].to(x.dtype) + bn["shift"].to(x.dtype)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, floor semantics (torch MaxPool2d(2))."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : 2 * h2, : 2 * w2, :].reshape(b, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4))


def conv_transpose_2x2(x: torch.Tensor, p: Params, dtype=None) -> torch.Tensor:
    """2x2 stride-2 transposed convolution (torch ConvTranspose2d(C, C, 2,
    stride=2)): y[2i+di, 2j+dj, o] = sum_c x[i,j,c] * W[c,di,dj,o] + b[o].
    p['w']: (Cin, 2, 2, Cout)."""
    b, h, w, _ = x.shape
    x, wt = _cast(x, p["w"], dtype)
    y = torch.einsum("bhwc,cijo->bhiwjo", x, wt).reshape(b, 2 * h, 2 * w, wt.shape[-1])
    return y + p["b"].to(y.dtype)


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially to x2's H/W, dy//2 on top and dx//2 on the
    left (torch F.pad in the reference Up block, networks.py:309-312)."""
    dy = x2.shape[1] - x1.shape[1]
    dx = x2.shape[2] - x1.shape[2]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad H and W by p pixels on each side (torch 'reflect')."""
    return to_nhwc(F.pad(to_nchw(x), (p, p, p, p), mode="reflect"))


@contextlib.contextmanager
def float32_exact():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls inside the
    block (TF32 off), whatever the process-wide settings are; they are
    restored on exit. The training step runs under it so that its
    gradients do not depend on a global set elsewhere."""
    cudnn, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, mm


PadSpec = Tuple[Optional[int], Optional[int], Optional[int], Optional[int]]


def add_padding(x: torch.Tensor, force: bool = True) -> Tuple[torch.Tensor, PadSpec]:
    """Input padding before the UNet (reference: model/popcorn.py:231-258).

    force=True: reflect-pad 14 px on every side.
    force=False: pad H (then W) up to a multiple of 64 with reflect padding,
    but only when the dim is not already a multiple of 32 — the reference's
    exact rule. Returns the padded tensor and (px1, px2, py1, py2) for
    revert_padding.
    """
    px1 = px2 = py1 = py2 = None
    if force:
        p = 14
        return reflect_pad(x, p), (p, p, p, p)
    h, w = x.shape[1], x.shape[2]
    if h % 32 != 0:
        px1 = (64 - h % 64) // 2
        px2 = (64 - h % 64) - px1
        x = to_nhwc(F.pad(to_nchw(x), (0, 0, px1, px2), mode="reflect"))
    if w % 32 != 0:
        py1 = (64 - w % 64) // 2
        py2 = (64 - w % 64) - py1
        x = to_nhwc(F.pad(to_nchw(x), (py1, py2, 0, 0), mode="reflect"))
    return x, (px1, px2, py1, py2)


def revert_padding(x: torch.Tensor, pad: PadSpec) -> torch.Tensor:
    """Undo add_padding (reference: model/popcorn.py:261-276)."""
    px1, px2, py1, py2 = pad
    if px1 is not None or px2 is not None:
        x = x[:, px1 : x.shape[1] - px2, :, :]
    if py1 is not None or py2 is not None:
        x = x[:, :, py1 : x.shape[2] - py2, :]
    return x

"""Int8 quantization of the quantized eval (``ModelConfig.quantize``).

Counterparts, on unpacked NHWC tensors, of the helpers around the JAX
package's int8 kernels (popcorn_tpu/nn/pallas_conv.py) and of its
calibration pass (popcorn_tpu/nn/packed.py::calibrate_packed_stream):

  quantize_conv_weight, quantize_tconv_weight   _quantize_weight
  quantize_static                               quantize_static
  requant                                       _requant
  quantize_tiles                                _quantize_slab
  calibrate_stream                              calibrate_packed_stream

and the exact integer convolution that the int8 kernels' plain versions
compute. Codes are symmetric, in [-127, 127]; rounding is half to even
(``torch.round``, as ``jnp.round`` and the kernels' ``rintf``).

Every division here has a tensor divisor: on CUDA, PyTorch divides by a
Python scalar as a multiplication by its reciprocal, which can round
differently from the kernels' (and XLA's) true division.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .cuda_lib import TILE
from .ops import conv3x3, conv_transpose_2x2, float32_exact, frozen_bn, max_pool_2x2, pad_to_match

Tree = Dict[str, Any]

QMAX = 127.0
# the keys of one stream's static scales (calibrate_stream), in the order
# the JAX package records them
SCALE_KEYS = (
    "in", "inc_y1", "inc_out", "down1_y1", "down1_out", "down2_y1",
    "down2_out", "up2_up", "up2_y1", "up2_out", "up1_up", "up1_y1",
)


def const(like: torch.Tensor, v: float) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device: a divisor that divides."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _qmax(wbits: int) -> float:
    if wbits not in (4, 8):
        raise ValueError(f"wbits={wbits}: weights are quantized to 8 or 4 bits")
    return QMAX if wbits == 8 else float(2 ** (wbits - 1) - 1)


def _quantize_weight(w: torch.Tensor, dims, wbits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = _qmax(wbits)
    amax = torch.clamp_min(w.float().abs().amax(dim=dims), 1e-12)
    sw = amax / const(amax, qmax)
    wq = torch.clamp(torch.round(w.float() / sw), -qmax, qmax).to(torch.int8)
    return wq, sw


def quantize_conv_weight(w: torch.Tensor, wbits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (3, 3, Cin, Cout) weight as int8 codes and (Cout,) scales, one per
    output channel. ``wbits=4`` puts the codes on the int4 grid [-7, 7] in
    int8 carriers (the w4a8 mode)."""
    return _quantize_weight(w, (0, 1, 2), wbits)


def quantize_tconv_weight(w: torch.Tensor, wbits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (Cin, 2, 2, Cout) transposed-conv weight as int8 codes and (2, 2,
    Cout) scales, one per output channel and tap. In the JAX package's
    packed layout a lifted tconv column holds one tap of one output channel
    (popcorn_tpu/nn/packed.py::lift_tconv), so its per-column scale is a
    per-(tap, channel) scale here, and the kernels pick it by the fine
    pixel's parity."""
    return _quantize_weight(w, (0,), wbits)


def quantize_static(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``x`` at the static scale ``s``."""
    return torch.clamp(torch.round(x.float() * (const(s, 1.0) / s)), -QMAX, QMAX).to(torch.int8)


def requant(acc: torch.Tensor, e: torch.Tensor, g: torch.Tensor, lo: float) -> torch.Tensor:
    """int8(clip(round(acc * e + g), lo, 127)): dequantize, affine, ReLU
    (lo=0) and requantize in one pass."""
    return torch.clamp(torch.round(acc.float() * e + g), lo, QMAX).to(torch.int8)


def conv3x3_codes(xq: torch.Tensor, wq: torch.Tensor, same: bool = True) -> torch.Tensor:
    """The 3x3 convolution of int8 codes (N, H, W, Cin) with int8 weight
    codes (3, 3, Cin, Cout) as float32 integer sums: SAME zero padding, or
    VALID with ``same=False``. Every partial sum is an integer below 2**24
    (at most 9 * 32 * 127**2 = 4.6M), so the nine float32 matmuls give the
    exact int32 result in any summation order. cuDNN's convolutions are not
    used: their Winograd and FFT algorithms are not exact."""
    x, w = xq.float(), wq.float()
    if same:
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
    h, wd = x.shape[1] - 2, x.shape[2] - 2
    acc = None
    for ky in range(3):
        for kx in range(3):
            y = x[:, ky : ky + h, kx : kx + wd, :] @ w[ky, kx]
            acc = y if acc is None else acc + y
    return acc


def tiles(x: torch.Tensor, halo: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nty * ntx, TILE + 2*halo, TILE + 2*halo, C):
    the kernels' TILE x TILE output tiles (row-major per image), each with
    ``halo`` pixels around it, zero outside the image."""
    b, h, w, c = x.shape
    nty, ntx = -(-h // TILE), -(-w // TILE)
    n = TILE + 2 * halo
    xp = F.pad(x, (0, 0, halo, ntx * TILE - w + halo, halo, nty * TILE - h + halo))
    win = xp.unfold(1, n, TILE).unfold(2, n, TILE)  # (B, nty, ntx, C, n, n)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b * nty * ntx, n, n, c)


def untile(t: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``tiles(x, 0)``: (B * nty * ntx, TILE, TILE, C) -> (B, H, W, C)."""
    nty, ntx = -(-h // TILE), -(-w // TILE)
    c = t.shape[-1]
    t = t.reshape(b, nty, ntx, TILE, TILE, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, nty * TILE, ntx * TILE, c)[:, :h, :w]


def inside_tiles(b: int, h: int, w: int, halo: int, device) -> torch.Tensor:
    """(B * nty * ntx, TILE + 2*halo, TILE + 2*halo, 1) bool: where a tile
    position lies inside the (h, w) image."""
    ones = torch.ones((1, h, w, 1), dtype=torch.float32, device=device)
    return (tiles(ones, halo) > 0).repeat(b, 1, 1, 1)


def quantize_tiles(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 quantization with one scale a tile (dim 0):
    the codes and the (T, 1, 1, 1) scales amax / 127. The JAX package's
    slab is a TPU row tile; the port's is the CUDA kernels' tile (its
    docstring: any slab is a valid quantization)."""
    amax = torch.clamp_min(t.abs().amax(dim=(1, 2, 3), keepdim=True), 1e-12)
    q = torch.clamp(torch.round(t * (const(amax, QMAX) / amax)), -QMAX, QMAX).to(torch.int8)
    return q, amax / const(amax, QMAX)


def pack_dp4a(wq: torch.Tensor) -> torch.Tensor:
    """int8 weight codes (..., Cin, Cout) in the kernels' layout (..., G,
    Cout, 4), G = ceil(Cin / 4): each int32 word holds the codes of four
    input channels for one output channel (a ``__dp4a`` operand), channels
    past Cin zero."""
    cin = wq.shape[-2]
    g = -(-cin // 4)
    w = F.pad(wq, (0, 0, 0, 4 * g - cin))
    return w.reshape(*wq.shape[:-2], g, 4, wq.shape[-1]).transpose(-1, -2).contiguous()


@torch.no_grad()
def calibrate_stream(p: Tree, bn: Tree, x: torch.Tensor, margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Static activation scales of one UNet stream: amax / 127 * margin of
    every tensor the static int8 path quantizes (the stream input, each
    DoubleConv's y1 and output, each Up block's tconv output and y1; not
    up1's float output), from a plain float32 forward of the stream on
    ``x``. Keys as SCALE_KEYS; each a float32 0-d tensor on x's device.

    This is the JAX package's own plain XLA pass (float32, precision
    HIGHEST), not a kernel's plain version: it runs on the card, once per
    member and region, with TF32 off (``float32_exact``; cuDNN's
    convolutions default to TF32)."""
    sc: Dict[str, torch.Tensor] = {}

    def amax(v, k):
        m = torch.clamp_min(v.abs().amax(), 1e-6)
        sc[k] = m / const(m, QMAX) * margin

    def dc(pp, bb, xx, k):
        y1 = torch.relu(frozen_bn(conv3x3(xx, pp["conv1"]), bb["bn1"]))
        amax(y1, f"{k}_y1")
        y2 = torch.relu(frozen_bn(conv3x3(y1, pp["conv2"]), bb["bn2"]))
        amax(y2, f"{k}_out")
        return y2

    def up(pu, bu, x1, x2, k, last):
        u = conv_transpose_2x2(x1, pu["tconv"])
        amax(u, f"{k}_up")
        y = torch.cat([x2, pad_to_match(u, x2)], dim=-1)
        y1 = torch.relu(frozen_bn(conv3x3(y, pu["conv"]["conv1"]), bu["bn1"]))
        amax(y1, f"{k}_y1")
        y2 = torch.relu(frozen_bn(conv3x3(y1, pu["conv"]["conv2"]), bu["bn2"]))
        if not last:
            amax(y2, f"{k}_out")
        return y2

    with float32_exact():
        x = x.float()
        amax(x, "in")
        x1 = dc(p["inc"], bn["inc"], x, "inc")
        d1 = dc(p["down1"], bn["down1"], max_pool_2x2(x1), "down1")
        d2 = dc(p["down2"], bn["down2"], max_pool_2x2(d1), "down2")
        u2 = up(p["up2"], bn["up2"], d2, d1, "up2", last=False)
        up(p["up1"], bn["up1"], u2, x1, "up1", last=True)
    return sc

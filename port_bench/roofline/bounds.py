"""Least device times of the model's functions, from the shapes of the
launches the timed path makes.

A launch's bound is max(operations / peak FLOP/s, bytes / peak bytes/s):
each input byte read once and each output byte written once, whatever a
kernel reads again. Operations are the useful ones of flops.py, split by
block. bf16 launches are held to the bf16 tensor-core peak; float32
launches (the training head and its backward) to the TF32 peak, the
fastest rate any float32 product on the card can take, so the bound is
never above what an implementation could reach. The functions are the
keys of kernels.json.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from .flops import SAR_IN, OPT_IN, _c33, head_flops_per_px, peak_bytes, peak_flops

Launch = Tuple[str, float, float, str]  # (function, flops, bytes, peak dtype)
T0, T1 = 8, 16


def _double_conv(h, w, cin, cm, cout, esize) -> Launch:
    px = float(h) * w
    return ("double_conv", px * (_c33(cin, cm) + _c33(cm, cout)), px * (cin + cout) * esize, "bf16")


def _up_block(h, w, c1, c2, c0, esize) -> Launch:
    """Up block to (h, w): a 2x2 transposed conv of x1 (c1 channels at half
    resolution), concatenated after x2 (c2 channels), then two 3x3 convs
    to c0 channels."""
    px = float(h) * w
    flops = px * (2.0 * c1 * c1 + _c33(c1 + c2, c0) + _c33(c0, c0))
    return ("up_block", flops, (px / 4 * c1 + px * c2 + px * c0) * esize, "bf16")


def stream_launches(b: int, h: int, w: int, cin: int, esize: int = 2) -> List[Launch]:
    """One UNet stream over b images of h x w: three DoubleConvs, two Ups."""
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    out = [_double_conv(h, w, cin, T0, T0, esize), _double_conv(h2, w2, T0, T1, T1, esize),
           _double_conv(h4, w4, T1, T1, T1, esize), _up_block(h2, w2, T1, T1, T0, esize),
           _up_block(h, w, T0, T0, T0, esize)]
    return [(f, fl * b, by * b, dt) for f, fl, by, dt in out]


def unet_launches(b: int, h: int, w: int, esize: int = 2) -> List[Launch]:
    return stream_launches(b, h, w, SAR_IN, esize) + stream_launches(b, h, w, OPT_IN, esize)


def eval_patch_launches(patch: int, n_members: int) -> List[Launch]:
    """One bf16 eval patch: the building extractor on the patch
    reflect-padded by 14, every member's UNet, every member's head
    (channel 0 only, bf16 features in, bf16 out)."""
    out = unet_launches(1, patch + 28, patch + 28)
    for _ in range(n_members):
        out += unet_launches(1, patch, patch)
    px = float(patch) * patch
    hf = 2.0 * (16 * 64 + 64 * 64 * 2 + 64 * 1)
    out += [("head", px * hf, px * (16 * 2 + 2), "bf16")] * n_members
    return out


def train_step_launches(b: int, h: int, w: int, unet_frozen: bool) -> List[Launch]:
    """One bf16 training step over b x h x w: the frozen building extractor
    (padded by 14) on the fused kernels, the member's UNet on them too
    only when a memory tier freezes it (it trains through the library's
    convolutions otherwise), the float32 head forward with two channels
    and its backward (both gradients: twice the forward's operations;
    features, output gradient and feature gradient each moved once)."""
    out = unet_launches(b, h + 28, w + 28)
    if unet_frozen:
        out += unet_launches(b, h, w)
    px = float(b) * h * w
    out.append(("head", px * head_flops_per_px(), px * (16 + 2) * 4, "tf32"))
    out.append(("head_bwd", 2 * px * head_flops_per_px(), px * (16 * 4 + 2 * 4 + 16 * 2), "tf32"))
    return out


def bounds_by_function(launches: List[Launch], device_name: str) -> Dict[str, float]:
    """Seconds: the sum of the launches' bounds, by function."""
    bw = peak_bytes(device_name)
    out: Dict[str, float] = defaultdict(float)
    for f, fl, by, dt in launches:
        out[f] += max(fl / peak_flops(device_name, dt), by / bw)
    return dict(out)

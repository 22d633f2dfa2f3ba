"""Prithvi-EO-2.0 as POPCORN's feature extractor (``-fe prithvi_eo2_300m``).

The encoder of the NASA/IBM geospatial foundation model (Szwarcman et
al., arXiv:2412.02732; huggingface.co/ibm-nasa-geospatial/
Prithvi-EO-2.0-300M, ``prithvi_mae.py``): a ViT-L/16 of 24 pre-norm
blocks (hidden 1024, 16 heads of 64, MLP 4096 with exact GELU, LayerNorm
eps 1e-6, qkv and proj with bias), a Conv3d patch embedding of kernel and
stride (1, 16, 16) over 6 bands, a fixed 3D sin-cos position table, a
cls token and a final LayerNorm. One season a sample is one frame.

The member feeds it the bands [B, G, R, NIR, VV, VH] after POPCORN's
normalisation (Prithvi's two SWIR slots take the SAR bands) and maps its
tokens back to 10 m with a neck of our own, one ConvTranspose2d(1024 ->
16, kernel 16, stride 16) over the frame's tokens without the cls token:
the 16 channels at full resolution that POPCORN's head takes from the
UNet otherwise.

Each sample runs alone on its extent in the batch's bucket (the feed's
'extent', after the batch's flips and rotations): its 16 x 16 patches,
the extent zero-padded on the far sides to a multiple of 16, so no token
of the bucket's padding is attended. The neck's output is cropped to the
extent and is zero outside it.

Layout of the parameters (torch's own, so the published names map one to
one, compat/weights.py): linear weights (out, in), the patch embedding
(1024, 6, 16, 16) (the Conv3d weight without its time axis of 1), the
neck's (1024, 16, 16, 16) (in, out, kh, kw), the cls token (1, 1, 1024).

Compute dtype: in bfloat16 the products (patch embedding, qkv, attention,
proj, the MLP, the neck) take bf16 operands; the residual stream, the
LayerNorms and the neck's output stay float32. On a card, attention runs
a fused kernel of PyTorch's dispatcher's choosing (cuDNN's on the H100,
flash or memory-efficient where it does not apply), never the math
backend, whose score matrix would not fit at 14,500 tokens.

The program's spans ``prithvi.embed``, ``prithvi.encoder`` (the blocks
and the final norm) and ``prithvi.neck`` time it, and its counters
``tokens/encoder`` (tokens attended, cls included) and ``tokens/bucket``
(tokens the padded batch would have held) count it
(utils/profiling.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import count, span

Tree = Dict[str, Any]
NECK_OUT = 16  # the head's input channels
# the fused attention backends a card may take (torch.nn.attention's
# SDPBackend names; the dispatcher picks among them in its own order):
# every one but the math backend, whose score matrix would not fit at
# 14,500 tokens
ATTENTION_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")
# the member's input channels in Prithvi's band order, as indices into
# nn/popcorn.py::reorder_to_dda's [VV, VH, B, G, R, NIR]
BANDS_FROM_DDA = (2, 3, 4, 5, 0, 1)


@dataclasses.dataclass(frozen=True)
class PrithviSpec:
    depth: int
    dim: int
    heads: int
    patch: int
    mlp: int
    in_chans: int = 6
    eps: float = 1e-6


# the feature extractors of this module by name (ModelConfig.feature_extractor)
PRESETS: Dict[str, PrithviSpec] = {
    "prithvi_eo2_300m": PrithviSpec(depth=24, dim=1024, heads=16, patch=16, mlp=4096),
}


# ---------------------------------------------------------------- position table


@functools.lru_cache(maxsize=None)
def _sincos_1d(dim: int, n: int) -> np.ndarray:
    """MAE's 1D sin-cos table of positions 0..n-1: (n, dim), the sines of
    pos * omega then the cosines, omega = 1 / 10000 ** (i / (dim / 2))."""
    omega = np.arange(dim // 2, dtype=np.float32)
    omega /= dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.arange(n, dtype=np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


_TABLES: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _table_1d(dim: int, n: int, device) -> torch.Tensor:
    key = (dim, n, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.from_numpy(_sincos_1d(dim, n).astype(np.float32)).to(device)
    return t


def pos_table(dim: int, t: int, h: int, w: int, device="cpu") -> torch.Tensor:
    """The fixed 3D sin-cos table of a (t, h, w) token grid, tokens in
    (t, h, w) order: (t*h*w, dim) float32 on ``device``. Channels: 6/16 the
    w position, 6/16 the h position, 4/16 the t position, each MAE's 1D
    table (computed in float64, rounded to float32, as prithvi_mae.py's
    ``get_3d_sincos_pos_embed``). The cls token's entry is zero and is left
    out here. The 1D tables are cached by side length and device; a grid's
    table is their broadcast."""
    dw, dh, dt = dim // 16 * 6, dim // 16 * 6, dim // 16 * 4
    parts = (_table_1d(dw, w, device)[None, None, :, :].expand(t, h, w, dw),
             _table_1d(dh, h, device)[None, :, None, :].expand(t, h, w, dh),
             _table_1d(dt, t, device)[:, None, None, :].expand(t, h, w, dt))
    return torch.cat(parts, dim=-1).reshape(t * h * w, dim)


# ---------------------------------------------------------------------- blocks


def _linear(x: torch.Tensor, p: Tree, dtype) -> torch.Tensor:
    w, b = p["w"], p["b"]
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.linear(x, w, b)


def _norm(x: torch.Tensor, p: Tree, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["w"], p["b"], eps)


def _fused_attention(device: torch.device):
    """On a card, a context that keeps attention on ATTENTION_BACKENDS."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([getattr(SDPBackend, b) for b in ATTENTION_BACKENDS])


def attention(x: torch.Tensor, p: Tree, heads: int, dtype) -> torch.Tensor:
    """Global multi-head self-attention over the (N, D) tokens."""
    n, d = x.shape
    qkv = _linear(x, p["qkv"], dtype).view(n, 3, heads, d // heads).permute(1, 2, 0, 3)
    o = F.scaled_dot_product_attention(qkv[0][None], qkv[1][None], qkv[2][None])[0]
    return _linear(o.transpose(0, 1).reshape(n, d), p["proj"], dtype)


def block(x: torch.Tensor, p: Tree, spec: PrithviSpec, dtype) -> torch.Tensor:
    """One pre-norm block on the float32 residual stream."""
    x = x + attention(_norm(x, p["norm1"], spec.eps), p, spec.heads, dtype)
    h = F.gelu(_linear(_norm(x, p["norm2"], spec.eps), p["fc1"], dtype))
    return x + _linear(h, p["fc2"], dtype)


def grid(h: int, w: int, patch: int) -> Tuple[int, int]:
    """The token grid of an h x w extent: its sides over the patch,
    rounded up."""
    return -(-h // patch), -(-w // patch)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(h, w, C) -> (Hp*Wp, C*patch*patch): the extent zero-padded on the
    far sides to multiples of ``patch``, each patch's values in the Conv
    weight's (C, kh, kw) order."""
    h, w, c = x.shape
    hp, wp = grid(h, w, patch)
    x = F.pad(x, (0, 0, 0, wp * patch - w, 0, hp * patch - h))
    x = x.view(hp, patch, wp, patch, c).permute(0, 2, 4, 1, 3)
    return x.reshape(hp * wp, c * patch * patch)


def encode(enc: Tree, x: torch.Tensor, spec: PrithviSpec, dtype) -> torch.Tensor:
    """One sample's (h, w, 6) input in Prithvi's band order -> its frame's
    (Hp*Wp, D) tokens after the final norm, cls token dropped."""
    hp, wp = grid(x.shape[0], x.shape[1], spec.patch)
    with span("prithvi.embed"):
        pe = enc["patch_embed"]
        tok = _linear(patchify(x, spec.patch), {"w": pe["w"].reshape(pe["w"].shape[0], -1),
                                                "b": pe["b"]}, dtype)
        tok = tok + pos_table(spec.dim, 1, hp, wp, tok.device)
        h = torch.cat([enc["cls_token"].reshape(1, spec.dim), tok])
    with span("prithvi.encoder"), _fused_attention(h.device):
        for i in range(spec.depth):
            h = block(h, enc["blocks"][str(i)], spec, dtype)
        h = _norm(h, enc["norm"], spec.eps)
    return h[1:]


def neck(p: Tree, tokens: torch.Tensor, hw: Tuple[int, int], spec: PrithviSpec,
         dtype) -> torch.Tensor:
    """ConvTranspose2d(D -> 16, kernel = stride = patch) over the frame's
    tokens, cropped to the extent: (h, w, 16) float32."""
    h, w = hw
    hp, wp = grid(h, w, spec.patch)
    P, wt = spec.patch, p["w"]
    w2 = wt.reshape(wt.shape[0], -1)
    if dtype is not None:
        tokens, w2 = tokens.to(dtype), w2.to(dtype)
    y = tokens @ w2
    y = y.view(hp, wp, wt.shape[1], P, P).permute(0, 3, 1, 4, 2).reshape(hp * P, wp * P, -1)
    return y[:h, :w].float() + p["b"]


def features(params: Tree, x6: torch.Tensor, extents: Optional[Sequence], spec: PrithviSpec,
             dtype, *, encoder_no_grad: bool = False, neck_no_grad: bool = False) -> torch.Tensor:
    """The member's (B, H, W, 16) float32 features of the batch ``x6``
    (B, H, W, 6) in nn/popcorn.py::reorder_to_dda's order: each sample's
    encoder and neck on its extent (r0, r1, c0, c1) (the whole image where
    ``extents`` is None), zero outside. The memory tiers:
    ``encoder_no_grad`` runs the patch embedding, the blocks and the final
    norm without a gradient, ``neck_no_grad`` the neck too."""
    b, H, W, _ = x6.shape
    x = x6[..., list(BANDS_FROM_DDA)]
    tok_grid = grid(H, W, spec.patch)
    count("tokens/bucket", b * (tok_grid[0] * tok_grid[1] + 1))
    grad = torch.is_grad_enabled()
    out = []
    for i in range(b):
        r0, r1, c0, c1 = ((0, H, 0, W) if extents is None
                          else (int(v) for v in extents[i]))
        hp, wp = grid(r1 - r0, c1 - c0, spec.patch)
        count("tokens/encoder", hp * wp + 1)
        with torch.set_grad_enabled(grad and not encoder_no_grad):
            tokens = encode(params["encoder"], x[i, r0:r1, c0:c1], spec, dtype)
        with torch.set_grad_enabled(grad and not neck_no_grad), span("prithvi.neck"):
            f = neck(params["neck"], tokens, (r1 - r0, c1 - c0), spec, dtype)
            out.append(F.pad(f, (0, 0, c0, W - c1, r0, H - r1)))
    return torch.stack(out)


# ------------------------------------------------------------------------ init


def init_prithvi(spec: PrithviSpec, seed: int, device="cpu") -> Tree:
    """Seeded encoder and neck ({'encoder', 'neck'}) as prithvi_mae.py
    initialises the encoder (timm's ViT: linear weights xavier-uniform,
    biases 0, LayerNorms 1 and 0, the patch embedding xavier-uniform over
    its flattened weight, the cls token normal with std 0.02) and the neck
    as torch's ConvTranspose2d default (uniform +-1/sqrt(fan_in), fan_in
    = out channels x kernel area), drawn on ``device`` from one generator."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    d, m, P = spec.dim, spec.mlp, spec.patch

    def xavier(o, i):
        a = math.sqrt(6.0 / (i + o))
        return (torch.rand(o, i, generator=g, device=device) * 2 - 1) * a

    def lin(o, i):
        return {"w": xavier(o, i), "b": torch.zeros(o, device=device)}

    def ln():
        return {"w": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    blocks = {str(i): {"norm1": ln(), "qkv": lin(3 * d, d), "proj": lin(d, d), "norm2": ln(),
                       "fc1": lin(m, d), "fc2": lin(d, m)} for i in range(spec.depth)}
    enc = {
        "patch_embed": {"w": xavier(d, spec.in_chans * P * P).view(d, spec.in_chans, P, P),
                        "b": torch.zeros(d, device=device)},
        "cls_token": torch.randn(1, 1, d, generator=g, device=device) * 0.02,
        "blocks": blocks,
        "norm": ln(),
    }
    bound = 1.0 / math.sqrt(NECK_OUT * P * P)
    neck_p = {"w": (torch.rand(d, NECK_OUT, P, P, generator=g, device=device) * 2 - 1) * bound,
              "b": (torch.rand(NECK_OUT, generator=g, device=device) * 2 - 1) * bound}
    return {"encoder": enc, "neck": neck_p}

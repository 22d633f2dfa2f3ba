"""Analytic counts of the Prithvi member's training step, read from its
configuration's widths (configs/prithvi-eo2-300m-member-train-bf16.json),
1 MAC = 2 FLOPs, LayerNorm, GELU, softmax and residual work left out.

A sample of h x w pixels has N = ceil(h / P) * ceil(w / P) + 1 tokens (its
own patches and the cls token; the bucket's padding is not attended). Its
encoder forward costs the patch embedding, 2 (N - 1) C P^2 D, and per
block 24 N D^2 in the linears (qkv 6, proj 2, the MLP 16 at an MLP ratio
of 4: 2 N D (4 D + 2 m)) and 4 N^2 D in attention (Q K^T and P V); the
neck 2 (N - 1) D 16 P^2. A training step counts what trains three times
(forward, input gradient, weight gradient: attention's backward is
8 N^2 D) and what a memory tier froze once; the head always trains, the
building extractor (roofline/flops.py) runs once, both over the crop's
pixels. The update moves 28 bytes a parameter (p, g, mu, nu read; p, mu,
nu written) and reads the gradient once more for the clip's norm.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .flops import builder_flops_per_px, head_flops_per_px

NECK_OUT = 16
HEAD = ((16, 64), (64, 64), (64, 64), (64, 2))
ADAM_BYTES_PER_PARAM = 28 + 4


def widths(cfg: Dict) -> Tuple[int, int, int, int, int]:
    """(D, depth, MLP width, patch side, input channels)."""
    d = cfg["embed_dim"]
    return d, cfg["depth"], int(cfg["mlp_ratio"] * d), cfg["patch_size"][-1], cfg["in_chans"]


def tokens(cfg: Dict, h: int, w: int) -> int:
    """Tokens an h x w sample attends over, the cls token included."""
    P = widths(cfg)[3]
    return -(-h // P) * -(-w // P) + 1


def attention_flops(cfg: Dict, n: int) -> float:
    """Forward FLOPs of every block's attention over n tokens, 4 n^2 D each."""
    d, depth = widths(cfg)[:2]
    return 4.0 * n * n * d * depth


def encoder_flops(cfg: Dict, n: int) -> float:
    """Forward FLOPs of the patch embedding and the blocks over n tokens."""
    d, depth, m, P, c = widths(cfg)
    return 2.0 * (n - 1) * c * P * P * d + depth * 2.0 * n * d * (4 * d + 2 * m) + \
        attention_flops(cfg, n)


def neck_flops(cfg: Dict, n: int) -> float:
    d, _, _, P, _ = widths(cfg)
    return 2.0 * (n - 1) * d * NECK_OUT * P * P


def sample_flops(cfg: Dict, h: int, w: int, encoder_frozen: bool, neck_frozen: bool) -> float:
    """Useful FLOPs of one h x w sample of a training step."""
    n, px = tokens(cfg, h, w), float(h) * w
    return ((1 if encoder_frozen else 3) * encoder_flops(cfg, n)
            + (1 if neck_frozen else 3) * neck_flops(cfg, n)
            + 3 * head_flops_per_px() * px + builder_flops_per_px() * px)


def param_count(cfg: Dict) -> int:
    """Trained parameters: the encoder, the neck and the head."""
    d, depth, m, P, c = widths(cfg)
    block = 4 * d + (3 * d * d + 3 * d) + (d * d + d) + (m * d + m) + (d * m + d)
    encoder = c * P * P * d + d + d + depth * block + 2 * d
    return encoder + d * NECK_OUT * P * P + NECK_OUT + sum(ci * co + co for ci, co in HEAD)


def adam_bytes(cfg: Dict) -> float:
    """Bytes one update moves at least."""
    return float(ADAM_BYTES_PER_PARAM) * param_count(cfg)

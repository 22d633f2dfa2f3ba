"""A POPCORN member with a Prithvi-EO-2.0 feature extractor, and its
weakly supervised training steps, in plain PyTorch, float32.

Written from the published description of the model (Szwarcman et al.,
"Prithvi-EO-2.0", arXiv:2412.02732; huggingface.co/ibm-nasa-geospatial/
Prithvi-EO-2.0-300M, config.json and prithvi_mae.py): the encoder is a ViT
of pre-norm blocks (LayerNorm, multi-head self-attention with a qkv and a
proj linear, LayerNorm, an MLP with exact GELU), a Conv3d patch embedding
of kernel and stride (1, P, P), a cls token whose position entry is zero,
a fixed 3D sin-cos position table (channels: 6/16 the w position, 6/16
the h position, 4/16 the t position, each MAE's 1D table: sines then
cosines of pos / 10000 ** (2i / d)) and a final LayerNorm. The member
feeds it [B, G, R, NIR, VV, VH] (the dataset-normalised S2 and S1), maps
the frame's tokens back to 10 m with a ConvTranspose2d(D -> 16, kernel
and stride P), and the rest is POPCORN's (model.py): the frozen building
extractor, the 1x1 head, scale x building score.

Each sample runs alone on its pixels in the batch's bucket (where its
admin mask is not -1), zero-padded on the far sides to a multiple of P;
its features are zero outside them. Attention runs in query blocks of
``QUERY_BLOCK`` under activation checkpointing, and so does every
transformer block, so that float32 at 14,500 tokens fits on the card.

The training steps (``run_steps``) are reference/train.py's: its sample
layout (``find_layout``), photometric augmentation and sparsity mask by
import, and the same loss, global-norm clip and Adam, with the memory
tiers freezing the encoder above ``limit1`` pixels and the neck too above
``limit2``. Nothing here comes from the program under test.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import Popcorn, dda_input, identity, load_state, load_stats, no_tf32
from .train import TrainSettings, find_layout, photometric, sparsity_mask

HEADS = 16  # Prithvi-EO-2.0-300M's attention heads
EPS = 1e-6
QUERY_BLOCK = 1024
PRITHVI_BANDS = [2, 3, 4, 5, 0, 1]  # [B, G, R, NIR, VV, VH] of dda_input's order


def sincos(dim: int, n: int) -> torch.Tensor:
    """MAE's 1D table of positions 0..n-1, (n, dim), in float64."""
    i = torch.arange(dim // 2, dtype=torch.float64)
    omega = 1.0 / 10000 ** (i / (dim / 2.0))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * omega[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def pos_embed(dim: int, h: int, w: int, swap_hw: bool = False) -> torch.Tensor:
    """The (h*w, dim) float32 table of one frame's tokens in row-major
    order; ``swap_hw`` gives the h channels the w position and the w
    channels the h position (a planted fault)."""
    d6, d4 = dim // 16 * 6, dim // 16 * 4
    rows = torch.arange(h).repeat_interleave(w)
    cols = torch.arange(w).repeat(h)
    if swap_hw:
        rows, cols = cols, rows
    wpart = sincos(d6, max(h, w))[cols]
    hpart = sincos(d6, max(h, w))[rows]
    tpart = sincos(d4, 1).expand(h * w, d4)
    return torch.cat([wpart, hpart, tpart], dim=1).float()


class PrithviMember:
    """The member of one state dict (Prithvi's names for ``encoder.*``,
    ``neck.*``). ``q`` rounds the operands of every product (model.fp8
    for the precision control)."""

    def __init__(self, sd: Dict[str, torch.Tensor], heads: int = HEADS, q=identity,
                 swap_hw: bool = False):
        self.sd, self.heads, self.q, self.swap_hw = sd, heads, q, swap_hw
        self.depth = len({k.split(".")[2] for k in sd if k.startswith("encoder.blocks.")})

    def lin(self, x, name):
        return F.linear(self.q(x), self.q(self.sd[f"{name}.weight"]), self.sd[f"{name}.bias"])

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.sd[f"{name}.weight"], self.sd[f"{name}.bias"],
                            EPS)

    def _attend(self, q, k, v):
        s = (self.q(q) @ self.q(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
        return self.q(torch.softmax(s, dim=-1)) @ self.q(v)

    def attention(self, x, p):
        n, d = x.shape
        qkv = self.lin(x, f"{p}.attn.qkv").view(n, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(1, 2, 0, 3)
        out = [checkpoint(self._attend, q[:, s:s + QUERY_BLOCK], k, v, use_reentrant=False)
               if torch.is_grad_enabled() else self._attend(q[:, s:s + QUERY_BLOCK], k, v)
               for s in range(0, n, QUERY_BLOCK)]
        o = torch.cat(out, dim=1).transpose(0, 1).reshape(n, d)
        return self.lin(o, f"{p}.attn.proj")

    def block(self, x, i: int):
        p = f"encoder.blocks.{i}"
        x = x + self.attention(self.norm(x, f"{p}.norm1"), p)
        return x + self.lin(F.gelu(self.lin(self.norm(x, f"{p}.norm2"), f"{p}.mlp.fc1")),
                            f"{p}.mlp.fc2")

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(6, h, w) in Prithvi's bands -> ((Hp*Wp, D) tokens, Hp, Wp)."""
        w3 = self.sd["encoder.patch_embed.proj.weight"]
        d, P = w3.shape[0], w3.shape[-1]
        _, h, w = x.shape
        hp, wp = -(-h // P), -(-w // P)
        x = F.pad(x, (0, wp * P - w, 0, hp * P - h))
        tok = F.conv3d(self.q(x[None, :, None]), self.q(w3), self.sd["encoder.patch_embed.proj.bias"],
                       stride=(1, P, P))
        tok = tok.flatten(2)[0].t() + pos_embed(d, hp, wp, self.swap_hw).to(x.device)
        t = torch.cat([self.sd["encoder.cls_token"].reshape(1, d), tok])
        for i in range(self.depth):
            t = (checkpoint(self.block, t, i, use_reentrant=False) if torch.is_grad_enabled()
                 else self.block(t, i))
        return self.norm(t, "encoder.norm")[1:], hp, wp

    def neck(self, tok, hp: int, wp: int, h: int, w: int) -> torch.Tensor:
        """(16, h, w): the transposed convolution over the token grid."""
        grid = tok.t().reshape(1, tok.shape[1], hp, wp)
        wt = self.sd["neck.weight"]
        y = F.conv_transpose2d(self.q(grid), self.q(wt), self.sd["neck.bias"],
                               stride=wt.shape[-1])
        return y[0, :, :h, :w]

    def features(self, x6: torch.Tensor, admin: torch.Tensor, frozen_encoder: bool,
                 frozen_neck: bool, whole_bucket: bool = False) -> torch.Tensor:
        """(B, 16, H, W): each sample's neck output on its pixels (admin
        mask not -1, or the whole bucket with ``whole_bucket``, a planted
        fault), zero elsewhere. ``x6`` (B, 6, H, W) in dda_input's order."""
        b, _, hh, ww = x6.shape
        out = []
        for i in range(b):
            r0, r1, c0, c1 = (0, hh, 0, ww) if whole_bucket else _extent(admin[i])
            xs = x6[i, PRITHVI_BANDS, r0:r1, c0:c1]
            grad = torch.is_grad_enabled()
            with torch.set_grad_enabled(grad and not frozen_encoder):
                tok, hp, wp = self.encode(xs)
            with torch.set_grad_enabled(grad and not frozen_neck):
                f = self.neck(tok, hp, wp, r1 - r0, c1 - c0)
            out.append(F.pad(f, (c0, ww - c1, r0, hh - r1)))
        return torch.stack(out)


def _extent(admin: torch.Tensor):
    """(r0, r1, c0, c1): the bounding box of a sample's pixels, where its
    admin mask is not -1."""
    rows = torch.nonzero((admin != -1).any(dim=1)).flatten()
    cols = torch.nonzero((admin != -1).any(dim=0)).flatten()
    return int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1


def is_trainable(key: str) -> bool:
    """A Prithvi member's trained tensors: the encoder's (not the fixed
    position table), the neck's and the head's."""
    return key.split(".")[0] in ("encoder", "neck", "head") and key != "encoder.pos_embed"


def run_steps(region, member_path: str, batches: Sequence[Dict], gen_states: Sequence,
              cfg: TrainSettings, device, q=identity, popcount_scale: float = 1.0,
              grad_scale: float = 1.0, heads: int = HEADS, whole_bucket: bool = False,
              swap_hw: bool = False) -> Dict[str, object]:
    """reference/train.py::run_steps for the Prithvi member: the same
    outputs and planted faults, and two more of the extractor's own:
    ``whole_bucket`` (the bucket's padding attended) and ``swap_hw`` (the
    position table's h and w swapped)."""
    stats = load_stats(device)
    sd = load_state(member_path, device)
    keys = [k for k in sd if is_trainable(k)]
    params = {k: sd[k].clone() for k in keys}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    builder = Popcorn(sd, q)
    losses, popcounts, grad1, misses = [], [], None, 0
    b1, b2, eps = 0.9, 0.999, 1e-8
    with no_tf32():
        for t, (batch, gstate) in enumerate(zip(batches, gen_states), start=1):
            bt, m = find_layout(region, batch)
            misses += m
            s2 = photometric(bt["S2"], bt["photometric"]).permute(0, 3, 1, 2)
            x6 = dda_input(s2, bt["S1"].permute(0, 3, 1, 2), stats)
            with torch.no_grad():
                score = builder.building_score("building_extractor.", x6)
            npix = x6.shape[0] * x6.shape[2] * x6.shape[3]
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            net = PrithviMember({**sd, **leaves}, heads, q, swap_hw)
            feats = net.features(x6, bt["admin_mask"], npix > cfg.limit1, npix > cfg.limit2,
                                 whole_bucket)
            scale = F.relu(Popcorn({**sd, **leaves}, q).head(feats)[:, 0])
            dense = scale * score
            sel = bt["admin_mask"] == bt["census_idx"][:, None, None]
            pc = torch.sum(dense * sel, dim=(1, 2))
            if popcount_scale != 1.0:
                pc = pc * torch.cat([pc.new_full((1,), popcount_scale), pc.new_ones(len(pc) - 1)])
            mask = sparsity_mask(score, bt["admin_mask"], bt["census_idx"], gstate)
            l1 = torch.mean(torch.abs(torch.log(pc + 1) - torch.log(bt["y"] + 1)))
            reg = torch.sum(torch.abs(scale) * mask) / torch.clamp(torch.sum(mask), min=1)
            loss = (l1 + cfg.scale_regularization * reg) * cfg.lam_weak
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
            g = {k: torch.zeros_like(params[k]) if d is None else d.detach() * grad_scale
                 for k, d in zip(keys, grads)}
            norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
            if norm >= cfg.gradient_clip:
                g = {k: v / norm * cfg.gradient_clip for k, v in g.items()}
            if t == 1:
                grad1 = g
            losses.append(float(loss.detach()))
            popcounts.append(pc.detach().double().cpu())
            for k in keys:
                mu[k] = b1 * mu[k] + (1 - b1) * g[k]
                nu[k] = b2 * nu[k] + (1 - b2) * g[k] * g[k]
                upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                params[k] = params[k] - cfg.learning_rate * upd
    return {"loss": losses, "popcount": popcounts, "grad1": grad1,
            "change": {k: params[k] - sd[k] for k in keys}, "batch_misses": misses}


def member_maps(sd: Dict[str, torch.Tensor], x6: torch.Tensor, heads: int = HEADS):
    """(density, scale), each (B, H, W), of the member on the whole of
    each image of ``x6`` (B, 6, H, W) in dda_input's order, the building
    score by the member's own extractor: the eval's forward of one patch."""
    with torch.no_grad(), no_tf32():
        score = Popcorn(sd).building_score("building_extractor.", x6)
        admin = torch.zeros(x6.shape[0], x6.shape[2], x6.shape[3], device=x6.device)
        feats = PrithviMember(sd, heads).features(x6, admin, True, True)
        scale = F.relu(Popcorn(sd).head(feats)[:, 0])
    return scale * score, scale


__all__ = ["PrithviMember", "member_maps", "pos_embed", "run_steps", "sincos"]
_ = np  # numpy is the reference's dependency for the region it reads

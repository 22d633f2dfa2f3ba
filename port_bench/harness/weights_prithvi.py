"""A Prithvi-EO-2.0 member's weights drawn from ``--seed``, in the ``.pth``
format that the program's trainer resumes from and the plain reference
(reference/prithvi.py) reads: {'model': state dict} with the encoder under
Prithvi's own names (``encoder.patch_embed.proj.*``, ``encoder.cls_token``,
``encoder.blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}.*``, ``encoder.norm.*``), ``neck.*``, ``head.{0,2,4,6}.*`` and
``building_extractor.*``.

The released checkpoint is not in the repository, so the encoder is drawn
as prithvi_mae.py initialises it (timm's ViT): linear weights and the
flattened patch embedding xavier-uniform, biases 0, LayerNorms 1 and 0,
the cls token normal with std 0.02. The neck takes torch's
ConvTranspose2d default (uniform +-1/sqrt(fan_in), fan_in = its output
channels x kernel area), the head the paper's initialisation (weights.py's
``HEAD`` drawn as there, the last bias ``biasinit``), and the building
extractor is the published DDA checkpoint's. The draws come from one
generator on the card.
"""

from __future__ import annotations

import math
import os

import torch

from port_bench.harness.weights import HEAD

NECK_OUT = 16


def make_member(dda_path: str, out_dir: str, seed: int, cfg, device) -> str:
    """Write the member of configuration ``cfg`` (its ``embed_dim``,
    ``depth``, ``mlp_ratio``, ``patch_size``, ``in_chans`` and the model's
    ``biasinit``) drawn from ``seed`` under ``out_dir``; its path."""
    d, depth, P = cfg["embed_dim"], cfg["depth"], cfg["patch_size"][-1]
    m, c = int(cfg["mlp_ratio"] * d), cfg["in_chans"]
    g = torch.Generator(device=device).manual_seed(int(seed))

    def xavier(shape, fan_out, fan_in):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * a

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound

    sd = {"encoder.patch_embed.proj.weight": xavier((d, c, 1, P, P), d, c * P * P),
          "encoder.patch_embed.proj.bias": torch.zeros(d, device=device),
          "encoder.cls_token": torch.randn(1, 1, d, generator=g, device=device) * 0.02}
    for i in range(depth):
        p = f"encoder.blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{p}.{norm}.weight"] = torch.ones(d, device=device)
            sd[f"{p}.{norm}.bias"] = torch.zeros(d, device=device)
        for name, (o, i_) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                              ("mlp.fc1", (m, d)), ("mlp.fc2", (d, m))):
            sd[f"{p}.{name}.weight"] = xavier((o, i_), o, i_)
            sd[f"{p}.{name}.bias"] = torch.zeros(o, device=device)
    sd["encoder.norm.weight"] = torch.ones(d, device=device)
    sd["encoder.norm.bias"] = torch.zeros(d, device=device)
    bound = 1.0 / math.sqrt(NECK_OUT * P * P)
    sd["neck.weight"] = uniform((d, NECK_OUT, P, P), bound)
    sd["neck.bias"] = uniform((NECK_OUT,), bound)
    for i, (ci, co) in enumerate(HEAD):
        b = 1.0 / ci ** 0.5
        sd[f"head.{2 * i}.weight"] = uniform((co, ci, 1, 1), b)
        sd[f"head.{2 * i}.bias"] = (torch.full((co,), float(cfg["model"]["biasinit"]),
                                               device=device) if i == len(HEAD) - 1
                                    else uniform((co,), b))
    dda = torch.load(dda_path, map_location="cpu", weights_only=True)["network"]
    sd.update({f"building_extractor.{k}": v for k, v in dda.items()})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "member0.pth")
    torch.save({"model": {k: v.detach().cpu().contiguous() for k, v in sd.items()}}, path)
    return path

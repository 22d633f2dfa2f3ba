"""Members' weights drawn from ``--seed``, in the reference ``.pth`` format
({'model': state dict} with ``unetmodel.*``, ``building_extractor.*`` and
``head.{0,2,4,6}.*``) that the program's eval and its trainer's resume
read, and that the plain reference reads too.

Every member starts from the building extractor the paper publishes (the
repository's DDA checkpoint): its feature UNet is that network with each
weight and bias tensor moved by ``perturb`` times the tensor's RMS in
seed-drawn normal noise (a member as fine-tuning leaves it; 0 keeps the
pretrained UNet, as training starts), its BatchNorms and its building
extractor are the DDA file's. Its occupancy head is drawn one of two ways:

* as the paper initialises it, where training starts (PyTorch's
  1x1-convolution default, uniform in +-1/sqrt(fan_in), the last bias set
  to ``biasinit``); its output then barely depends on the features;
* fitted to the member's own features on a crop of the region (``fit``),
  where a trained member is stood for: He-uniform weights (bound
  sqrt(6/fan_in)), each hidden unit's bias centring its pre-activation
  over the crop, and the last layer scaled so that each output spreads
  over the crop by ``spread`` times ``biasinit`` about a mean of
  ``biasinit``. The occupancy scale then varies with the features as a
  trained member's does, and an error in the member fold shows in it.

The draws come from one generator on the card, in one call for all
members.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from port_bench.reference.model import Popcorn, no_tf32

HEAD = ((16, 64), (64, 64), (64, 64), (64, 2))


def _is_weight(sd: Dict[str, torch.Tensor], k: str) -> bool:
    """A convolution's weight or bias, not a BatchNorm entry."""
    return torch.is_floating_point(sd[k]) and f"{k.rsplit('.', 1)[0]}.running_mean" not in sd


def _fitted_head(sd: Dict[str, torch.Tensor], x6: torch.Tensor, unif: torch.Tensor,
                 biasinit: float, spread: float) -> List:
    """[(weight, bias)] of a head fitted to the member's features on ``x6``
    (module docstring); ``unif`` holds the head's draws in [-1, 1]."""
    with torch.no_grad(), no_tf32():
        f = Popcorn(sd).features("unetmodel.", x6)
    x = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1]).double()
    out, off = [], 0
    for i, (ci, co) in enumerate(HEAD):
        w = unif[off:off + ci * co].view(co, ci).double() * (6.0 / ci) ** 0.5
        off += ci * co + co
        z = x @ w.T
        mean = z.mean(0)
        if i < len(HEAD) - 1:
            b = -mean
            x = torch.relu(z + b)
        else:
            g = spread * biasinit / z.std(0).clamp(min=1e-12)
            w, b = w * g[:, None], biasinit - mean * g
        out.append((w.float().view(co, ci, 1, 1), b.float()))
    return out


def make_members(dda_path: str, out_dir: str, seed: int, n: int, *, perturb: float,
                 biasinit: float, device, fit: Optional[torch.Tensor] = None,
                 spread: float = 1.0) -> List[str]:
    """Write ``n`` members drawn from ``seed`` under ``out_dir``; their paths.
    ``fit``: a (1, 6, H, W) network input to fit the heads on (module
    docstring); None draws them as the paper initialises them."""
    dda = torch.load(dda_path, map_location="cpu", weights_only=True)["network"]
    dda = {k: v.to(device) for k, v in dda.items()}
    moved = [k for k in dda if _is_weight(dda, k) and ".outc." not in k]
    n_unet = sum(dda[k].numel() for k in moved)
    n_head = sum(ci * co + co for ci, co in HEAD)
    g = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn(n * n_unet, generator=g, device=device)
    unif = torch.rand(n * n_head, generator=g, device=device) * 2 - 1
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for m in range(n):
        sd = {}
        off = m * n_unet
        for k, v in dda.items():
            t = v
            if k in moved:
                rms = torch.sqrt(torch.mean(v.float() ** 2))
                t = v + perturb * rms * noise[off:off + v.numel()].view_as(v)
                off += v.numel()
            sd[f"unetmodel.{k}"] = t
            sd[f"building_extractor.{k}"] = v
        draws = unif[m * n_head:(m + 1) * n_head]
        if fit is not None:
            head = _fitted_head(sd, fit, draws, biasinit, spread)
        else:
            head, off = [], 0
            for i, (ci, co) in enumerate(HEAD):
                bound = 1.0 / ci ** 0.5
                w = draws[off:off + ci * co].view(co, ci, 1, 1) * bound
                b = draws[off + ci * co:off + ci * co + co] * bound
                off += ci * co + co
                head.append((w, torch.full_like(b, biasinit) if i == len(HEAD) - 1 else b))
        for i, (w, b) in enumerate(head):
            sd[f"head.{2 * i}.weight"], sd[f"head.{2 * i}.bias"] = w, b
        path = os.path.join(out_dir, f"member{m}.pth")
        torch.save({"model": {k: v.detach().cpu().contiguous() for k, v in sd.items()}}, path)
        paths.append(path)
    return paths

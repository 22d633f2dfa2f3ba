"""POPCORN's forward pass in plain PyTorch, NCHW, read straight from the
state dicts of the published checkpoints.

Written from the POPCORN paper (Metzger et al., arXiv:2311.14006) and
the reference repository's description of its model (model/popcorn.py,
model/DDA_model/utils/networks.py): a dual-stream UNet of topology
[8, 16] per modality (S1 VV/VH, S2 B02/B03/B04/B08), each block
(conv3x3 -> BatchNorm -> ReLU) x 2, two max-pool downs, two
transposed-conv ups with the skip concatenated first; the frozen
building extractor is the same network with a 1x1 fusion conv over the
16 fused channels and a sigmoid, run on the input reflect-padded by 14
pixels; the occupancy head is a 1x1 MLP 16 -> 64 -> 64 -> 64 -> 2 whose
first channel, through a ReLU, scales the building score.

Nothing here comes from the program under test: the weights are the
``.pth`` / ``.pt`` state dicts, the normalisation statistics the
dataset's published ``dataset_stats.json`` (a copy beside this file).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict

import torch
import torch.nn.functional as F

StateDict = Dict[str, torch.Tensor]
BN_EPS = 1e-5
_HERE = os.path.dirname(os.path.abspath(__file__))


def load_stats(device) -> Dict[str, torch.Tensor]:
    """Per-modality mean and std, as (1, C, 1, 1) tensors: S2 in the
    R, G, B, NIR order the dataset reads its bands in, S1 as VV, VH."""
    with open(os.path.join(_HERE, "dataset_stats.json")) as f:
        s = json.load(f)

    def t(key, field):
        return torch.tensor(s[key][field], dtype=torch.float32, device=device).view(1, -1, 1, 1)

    return {"s2_mean": t("sen2springNIR", "mean"), "s2_std": t("sen2springNIR", "std"),
            "s1_mean": t("sen1", "mean"), "s1_std": t("sen1", "std")}


def dda_input(s2_rgbn: torch.Tensor, s1: torch.Tensor, stats) -> torch.Tensor:
    """The 6-channel network input [VV, VH, B02, B03, B04, B08] from raw S2
    (B, 4, H, W) in R, G, B, NIR order and raw S1 (B, 2, H, W), each
    z-scored with the dataset statistics."""
    s2 = (s2_rgbn.float() - stats["s2_mean"]) / stats["s2_std"]
    s1 = (s1.float() - stats["s1_mean"]) / stats["s1_std"]
    return torch.cat([s1, s2[:, [2, 1, 0]], s2[:, 3:4]], dim=1)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round a tensor to float8 (e4m3) at a per-tensor scale that maps its
    largest magnitude to the format's largest finite value (448), and
    back: what a product in fp8 operands sees. The gradient passes
    straight through the rounding, as in fp8 training."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    s = 448.0 / amax
    r = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (r - x.detach())


class Popcorn:
    """The networks of one state dict. ``q`` rounds every operand of a
    convolution (input and weight) before it: ``identity`` for the
    reference, ``fp8`` for the precision control."""

    def __init__(self, sd: StateDict, q=identity):
        self.sd, self.q = sd, q

    def conv(self, x: torch.Tensor, name: str, **kw) -> torch.Tensor:
        return F.conv2d(self.q(x), self.q(self.sd[f"{name}.weight"]), self.sd[f"{name}.bias"], **kw)

    def bn(self, p: str, x: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"],
                            sd[f"{p}.weight"], sd[f"{p}.bias"], training=False, eps=BN_EPS)

    def double_conv(self, p: str, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in ((0, 1), (3, 4)):
            x = F.relu(self.bn(f"{p}.{norm}", self.conv(x, f"{p}.{conv}", padding=1)))
        return x

    def up(self, p: str, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        up = F.conv_transpose2d(self.q(x1), self.q(self.sd[f"{p}.up.weight"]),
                                self.sd[f"{p}.up.bias"], stride=2)
        dy, dx = x2.shape[2] - up.shape[2], x2.shape[3] - up.shape[3]
        up = F.pad(up, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.double_conv(f"{p}.conv.conv", torch.cat([x2, up], dim=1))

    def stream(self, p: str, x: torch.Tensor, frozen_encoder: bool = False) -> torch.Tensor:
        """One UNet stream's 8 output features (before its unused out conv);
        ``frozen_encoder`` takes no gradient through the downward path."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen_encoder):
            x1 = self.double_conv(f"{p}inc.conv.conv", x)
            d1 = self.double_conv(f"{p}down_seq.down1.mpconv.1.conv", F.max_pool2d(x1, 2))
            d2 = self.double_conv(f"{p}down_seq.down2.mpconv.1.conv", F.max_pool2d(d1, 2))
        u2 = self.up(f"{p}up_seq.up2", d2, d1)
        return self.up(f"{p}up_seq.up1", u2, x1)

    def features(self, prefix: str, x6: torch.Tensor, frozen_encoder: bool = False) -> torch.Tensor:
        """The 16 fused features: the SAR stream's 8, then the optical's."""
        return torch.cat([self.stream(f"{prefix}sar_stream.", x6[:, :2], frozen_encoder),
                          self.stream(f"{prefix}optical_stream.", x6[:, 2:], frozen_encoder)],
                         dim=1)

    def building_score(self, prefix: str, x6: torch.Tensor) -> torch.Tensor:
        """Built-up probability (B, H, W) of the frozen extractor under
        ``prefix`` ('' in the DDA file, 'building_extractor.' in a member)."""
        p = 14
        f = self.features(prefix, F.pad(x6, (p, p, p, p), mode="reflect"))
        logit = self.conv(f, f"{prefix}fusion_out_conv.conv")
        return torch.sigmoid(logit)[:, 0, p:-p, p:-p]

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        for i in (0, 2, 4):
            x = F.relu(self.conv(x, f"head.{i}"))
        return self.conv(x, "head.6")

    def occupancy(self, x6: torch.Tensor, score: torch.Tensor, frozen_encoder: bool = False,
                  frozen_unet: bool = False):
        """(population density, occupancy scale), each (B, H, W): the
        member's UNet and head on the unpadded input, scale = ReLU of the
        head's first channel, density = scale x building score. The
        ``frozen_*`` flags are training's memory tiers."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen_unet):
            feats = self.features("unetmodel.", x6, frozen_encoder)
        scale = F.relu(self.head(feats)[:, 0])
        return scale * score, scale


def load_state(path: str, device) -> StateDict:
    """A checkpoint's state dict as float32 tensors on ``device``: the DDA
    file ({'network': sd}) or a POPCORN member ({'model': sd})."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    sd = ck.get("network", ck.get("model", ck))
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()
            if torch.is_floating_point(v)}


@contextlib.contextmanager
def no_tf32():
    """Float32 products in cuDNN and cuBLAS: TF32 off inside the block."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old

"""Weights carried across: the reference's torch checkpoints <-> the
port's parameter trees.

The port keeps the JAX package's tree layout (popcorn_tpu/nn/unet.py) with
torch tensors as leaves, NHWC-oriented:

  conv3x3  (O,I,3,3)  -> HWIO (3,3,I,O)
  conv1x1  (O,I,1,1)  -> (I,O) channel matmul
  convT2x2 (I,O,2,2)  -> (I,2,2,O)
  BatchNorm(gamma,beta,mean,var) -> frozen affine
      scale = gamma / sqrt(var + eps), shift = beta - mean * scale

Checkpoints use the reference's key names (``sar_stream.*``,
``optical_stream.*``, ``fusion_out_conv.conv`` in the DDA checkpoint;
``unetmodel.*``, ``building_extractor.*``, ``head.{0,2,4,6}.*`` in a POPCORN
``.pth``), so members pass between the reference, the JAX package and the
port. Conversions run in numpy float32 on the host, the same arithmetic as
popcorn_tpu/compat/torch_convert.py, so both packages load bit-identical
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import BN_EPS, ModelConfig, find_dda_checkpoint

Tree = Dict[str, Any]


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's state dict as {name: float32 numpy array}: the DDA
    checkpoint ({'network': sd, ...}), a POPCORN .pth ({'model': sd, ...})
    or a raw state dict."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ck, dict) and "network" in ck:
        sd = ck["network"]
    elif isinstance(ck, dict) and "model" in ck:
        sd = ck["model"]
    else:
        sd = ck
    return {
        k: v.detach().cpu().numpy().astype(np.float32)
        for k, v in sd.items()
        if isinstance(v, torch.Tensor)
    }


def _conv(sd, name) -> Tree:
    return {"w": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)), "b": sd[f"{name}.bias"]}


def _out_conv(sd, name) -> Tree:
    return {"w": sd[f"{name}.weight"][:, :, 0, 0].T.copy(), "b": sd[f"{name}.bias"]}


def _bn(sd, prefix: str) -> Tree:
    gamma = sd[f"{prefix}.weight"]
    beta = sd[f"{prefix}.bias"]
    mean = sd[f"{prefix}.running_mean"]
    var = sd[f"{prefix}.running_var"]
    scale = gamma / np.sqrt(var + BN_EPS)
    shift = beta - mean * scale
    return {"scale": scale.astype(np.float32), "shift": shift.astype(np.float32)}


def _double_conv(sd, prefix: str) -> Tuple[Tree, Tree]:
    """A torch DoubleConv Sequential: 0=conv, 1=bn, 3=conv, 4=bn."""
    params = {"conv1": _conv(sd, f"{prefix}.0"), "conv2": _conv(sd, f"{prefix}.3")}
    return params, {"bn1": _bn(sd, f"{prefix}.1"), "bn2": _bn(sd, f"{prefix}.4")}


def _stream(sd, p: str) -> Tuple[Tree, Tree]:
    """One UNet stream under prefix p (e.g. 'sar_stream.'); the unused
    per-stream 'outc' is skipped."""
    params: Tree = {}
    bn: Tree = {}
    params["inc"], bn["inc"] = _double_conv(sd, f"{p}inc.conv.conv")
    params["down1"], bn["down1"] = _double_conv(sd, f"{p}down_seq.down1.mpconv.1.conv")
    params["down2"], bn["down2"] = _double_conv(sd, f"{p}down_seq.down2.mpconv.1.conv")
    for up in ("up2", "up1"):
        conv, bn[up] = _double_conv(sd, f"{p}up_seq.{up}.conv.conv")
        params[up] = {
            "tconv": {
                "w": np.transpose(sd[f"{p}up_seq.{up}.up.weight"], (0, 2, 3, 1)),
                "b": sd[f"{p}up_seq.{up}.up.bias"],
            },
            "conv": conv,
        }
    return params, bn


def dual_stream_to_tree(sd: Dict[str, np.ndarray], prefix: str = "") -> Tuple[Tree, Tree]:
    """A DualStreamUNet state dict (optionally under ``prefix``) as numpy
    (params, bn) trees."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sar_p, sar_bn = _stream(sub, "sar_stream.")
    opt_p, opt_bn = _stream(sub, "optical_stream.")
    params = {
        "sar": sar_p,
        "opt": opt_p,
        "sar_out": _out_conv(sub, "sar_out_conv.conv"),
        "opt_out": _out_conv(sub, "optical_out_conv.conv"),
        "fusion_out": _out_conv(sub, "fusion_out_conv.conv"),
    }
    return params, {"sar": sar_bn, "opt": opt_bn}


def head_to_tree(sd: Dict[str, np.ndarray], prefix: str = "head.") -> Tree:
    """The 4-layer 1x1-conv head (torch Sequential indices 0, 2, 4, 6)."""
    return {
        f"l{i + 1}": {
            "w": sd[f"{prefix}{idx}.weight"][:, :, 0, 0].T.copy(),
            "b": sd[f"{prefix}{idx}.bias"],
        }
        for i, idx in enumerate((0, 2, 4, 6))
    }


def to_torch(tree: Any, device="cpu") -> Any:
    """Map a nested dict of arrays (numpy or torch) to float32 torch
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree, np.float32))
    return t.to(device=device, dtype=torch.float32).contiguous()


def to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree, np.float32)


def load_dda(path: Optional[str] = None, device="cpu") -> Tuple[Tree, Tree]:
    """The pretrained DDA dual-stream UNet (the repo's
    weights/fusionda_newAug8_16_checkpoint30_lossweight0.5.pt by default)
    as (params, bn) trees of torch tensors."""
    path = path or find_dda_checkpoint()
    if path is None:
        raise FileNotFoundError("DDA checkpoint not found; set POPCORN_DDA_CHECKPOINT.")
    params, bn = dual_stream_to_tree(load_torch_state(path))
    return to_torch(params, device), to_torch(bn, device)


def init_head(seed: int, cin: int = 16, hidden: int = 64, biasinit: float = 0.75) -> Tree:
    """A head drawn from ``numpy.random.default_rng(seed)`` with the
    reference's init (popcorn.py:78-88): torch-default 1x1 convs (uniform
    +-1/sqrt(fan_in) for weight and bias), final bias set to ``biasinit``."""
    rng = np.random.default_rng(seed)
    dims = [(cin, hidden), (hidden, hidden), (hidden, hidden), (hidden, 2)]
    head = {}
    for i, (ci, co) in enumerate(dims):
        bound = 1.0 / np.sqrt(ci)
        head[f"l{i + 1}"] = {
            "w": rng.uniform(-bound, bound, (ci, co)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (co,)).astype(np.float32),
        }
    head["l4"]["b"] = np.full((2,), biasinit, np.float32)
    return to_torch(head)


def load_popcorn_from_dda(
    cfg: ModelConfig, dda_path: Optional[str] = None, head_seed: int = 0
) -> Tuple[Tree, Tree]:
    """Fresh POPCORN (params, consts): the DDA weights for both the feature
    extractor and the building extractor, and a seeded head
    (model/popcorn.py:57-97 with pretrained=True)."""
    unet, unet_bn = load_dda(dda_path)
    builder, builder_bn = load_dda(dda_path)
    params = {"unet": unet, "head": init_head(head_seed, biasinit=cfg.biasinit)}
    consts = {"unet_bn": unet_bn, "builder": {"params": builder, "bn": builder_bn}}
    return params, consts


def from_jax(params: Tree, consts: Tree) -> Tuple[Tree, Tree]:
    """The JAX package's (params, consts) trees, given as numpy arrays, as
    the port's trees. The layouts are the same, so this is a leaf-wise
    conversion."""
    return to_torch(params), to_torch(consts)


def load_popcorn_checkpoint(path: str, device="cpu") -> Tuple[Tree, Tree]:
    """A POPCORN .pth training checkpoint as (params, consts)."""
    sd = load_torch_state(path)
    unet, unet_bn = dual_stream_to_tree(sd, prefix="unetmodel.")
    builder, builder_bn = dual_stream_to_tree(sd, prefix="building_extractor.")
    params = {"unet": unet, "head": head_to_tree(sd)}
    consts = {"unet_bn": unet_bn, "builder": {"params": builder, "bn": builder_bn}}
    return to_torch(params, device), to_torch(consts, device)


# -- export: trees -> the reference's .pth format ---------------------------


def _f32(a) -> np.ndarray:
    return np.asarray(to_numpy(a), np.float32)


def _inv_bn(bn: Tree, out: Dict, prefix: str) -> None:
    """Folded (scale, shift) -> a torch BN with running_mean=0 and
    running_var=1-eps, so gamma/sqrt(var+eps) == scale and beta == shift
    (the original gamma/mean/var are not recoverable from the fold and do
    not matter for frozen inference)."""
    scale = _f32(bn["scale"])
    out[f"{prefix}.weight"] = scale
    out[f"{prefix}.bias"] = _f32(bn["shift"])
    out[f"{prefix}.running_mean"] = np.zeros_like(scale)
    out[f"{prefix}.running_var"] = np.full_like(scale, 1.0 - BN_EPS)
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _inv_double_conv(p: Tree, bn: Tree, out: Dict, prefix: str) -> None:
    for i, (conv, norm) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        out[f"{prefix}.{3 * i}.weight"] = np.transpose(_f32(p[conv]["w"]), (3, 2, 0, 1))
        out[f"{prefix}.{3 * i}.bias"] = _f32(p[conv]["b"])
        _inv_bn(bn[norm], out, f"{prefix}.{3 * i + 1}")


def _inv_out_conv(p: Tree, out: Dict, name: str) -> None:
    out[f"{name}.weight"] = _f32(p["w"]).T[:, :, None, None].copy()
    out[f"{name}.bias"] = _f32(p["b"])


def dual_stream_from_tree(params: Tree, bn: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for stream, key in (("sar_stream", "sar"), ("optical_stream", "opt")):
        p, b, pre = params[key], bn[key], f"{prefix}{stream}."
        _inv_double_conv(p["inc"], b["inc"], out, f"{pre}inc.conv.conv")
        _inv_double_conv(p["down1"], b["down1"], out, f"{pre}down_seq.down1.mpconv.1.conv")
        _inv_double_conv(p["down2"], b["down2"], out, f"{pre}down_seq.down2.mpconv.1.conv")
        for up in ("up2", "up1"):
            out[f"{pre}up_seq.{up}.up.weight"] = np.transpose(_f32(p[up]["tconv"]["w"]), (0, 3, 1, 2))
            out[f"{pre}up_seq.{up}.up.bias"] = _f32(p[up]["tconv"]["b"])
            _inv_double_conv(p[up]["conv"], b[up], out, f"{pre}up_seq.{up}.conv.conv")
    _inv_out_conv(params["sar_out"], out, f"{prefix}sar_out_conv.conv")
    _inv_out_conv(params["opt_out"], out, f"{prefix}optical_out_conv.conv")
    _inv_out_conv(params["fusion_out"], out, f"{prefix}fusion_out_conv.conv")
    # the reference UNet registers a per-stream outc (unused by every
    # forward) and loads checkpoints strictly: emit zeros for it
    for stream in ("sar_stream", "optical_stream"):
        out[f"{prefix}{stream}.outc.conv.weight"] = np.zeros((1, 8, 1, 1), np.float32)
        out[f"{prefix}{stream}.outc.conv.bias"] = np.zeros((1,), np.float32)
    return out


def save_popcorn_checkpoint(
    path: str, params: Tree, consts: Tree, epoch: int = 0, iteration: int = 0,
    optimizer: Optional[Dict] = None,
) -> None:
    """Write (params, consts) as a reference .pth training checkpoint
    ({'model': sd, 'epoch', 'iter'} with unetmodel.*/building_extractor.*/
    head.* keys, run_train.py:445-456), plus the optimizer state under
    'optimizer' when given (train/checkpoint.py)."""
    sd = dual_stream_from_tree(params["unet"], consts["unet_bn"], "unetmodel.")
    sd.update(
        dual_stream_from_tree(
            consts["builder"]["params"], consts["builder"]["bn"], "building_extractor."
        )
    )
    for i, idx in enumerate((0, 2, 4, 6)):
        layer = params["head"][f"l{i + 1}"]
        sd[f"head.{idx}.weight"] = _f32(layer["w"]).T[:, :, None, None].copy()
        sd[f"head.{idx}.bias"] = _f32(layer["b"])
    ck = {
        "model": {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
        "epoch": epoch,
        "iter": iteration,
    }
    if optimizer is not None:
        ck["optimizer"] = optimizer
    torch.save(ck, path)

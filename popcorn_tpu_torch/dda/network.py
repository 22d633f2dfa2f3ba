"""Trainable-BatchNorm dual-stream UNet for DDA training.

Counterpart of popcorn_tpu/dda/network.py. The POPCORN runtime always
freezes BatchNorm (nn/unet.py), but training the DDA extractor itself
needs live batch statistics. This module runs the same architecture with
explicit BN parameters (gamma/beta) and running-stat state (mean/var,
torch momentum 0.1 semantics) through the nn/ops.py convs under autograd
(the JAX package runs no Pallas kernel here either), and exports a trained
model into the frozen scale/shift constants the POPCORN extractor
consumes.

BN tree layout per DoubleConv: {'bn1'|'bn2': {'gamma','beta'}} (params)
and {'bn1'|'bn2': {'mean','var'}} (state), the JAX package's trees, so
weights carry across (compat/weights.py::from_jax_dda).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..compat.weights import to_torch
from ..config import BN_EPS
from ..nn.ops import conv1x1, conv3x3, conv_transpose_2x2, max_pool_2x2, pad_to_match
from ..nn.unet import SAR_IN

Tree = Dict[str, Any]
MOMENTUM = 0.1  # torch BatchNorm2d default


def _bn_apply(x, gamma, beta, mean, var):
    inv = gamma / torch.sqrt(var + BN_EPS)
    return x * inv + (beta - mean * inv)


def batch_norm(x: torch.Tensor, bp: Tree, bs: Tree, train: bool):
    """(y, new_state). In training: normalise with the batch mean and the
    biased batch variance (differentiable), and move the running
    statistics toward the mean and the unbiased variance at MOMENTUM,
    F.batch_norm's rule written out; the new state carries no gradient."""
    if not train:
        return _bn_apply(x, bp["gamma"], bp["beta"], bs["mean"], bs["var"]), bs
    axes = (0, 1, 2)
    mean = torch.mean(x, axes)
    var = torch.var(x, axes, correction=0)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    with torch.no_grad():
        unbiased = var * n / max(n - 1, 1)
        new = {
            "mean": (1 - MOMENTUM) * bs["mean"] + MOMENTUM * mean,
            "var": (1 - MOMENTUM) * bs["var"] + MOMENTUM * unbiased,
        }
    return _bn_apply(x, bp["gamma"], bp["beta"], mean, var), new


def _dc(p, bp, bs, x, train):
    y, s1 = batch_norm(conv3x3(x, p["conv1"]), bp["bn1"], bs["bn1"], train)
    y = torch.relu(y)
    y, s2 = batch_norm(conv3x3(y, p["conv2"]), bp["bn2"], bs["bn2"], train)
    return torch.relu(y), {"bn1": s1, "bn2": s2}


def _stream(p, bp, bs, x, train):
    x1, s_inc = _dc(p["inc"], bp["inc"], bs["inc"], x, train)
    d1, s_d1 = _dc(p["down1"], bp["down1"], bs["down1"], max_pool_2x2(x1), train)
    d2, s_d2 = _dc(p["down2"], bp["down2"], bs["down2"], max_pool_2x2(d1), train)

    u = pad_to_match(conv_transpose_2x2(d2, p["up2"]["tconv"]), d1)
    u2, s_u2 = _dc(p["up2"]["conv"], bp["up2"], bs["up2"], torch.cat([d1, u], -1), train)
    u = pad_to_match(conv_transpose_2x2(u2, p["up1"]["tconv"]), x1)
    u1, s_u1 = _dc(p["up1"]["conv"], bp["up1"], bs["up1"], torch.cat([x1, u], -1), train)
    state = {"inc": s_inc, "down1": s_d1, "down2": s_d2, "up2": s_u2, "up1": s_u1}
    return u1, state


def dual_stream_train_forward(
    params: Tree, bn_params: Tree, bn_state: Tree, x6: torch.Tensor, train: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tree]:
    """(sar_logits, opt_logits, fusion_logits, new_bn_state) for an NHWC
    input in DDA's 6-channel order [S1 | S2]."""
    sar, s_sar = _stream(params["sar"], bn_params["sar"], bn_state["sar"], x6[..., :SAR_IN], train)
    opt, s_opt = _stream(params["opt"], bn_params["opt"], bn_state["opt"], x6[..., SAR_IN:], train)
    fused = torch.cat([sar, opt], -1)
    sar_logits = conv1x1(sar, params["sar_out"])
    opt_logits = conv1x1(opt, params["opt_out"])
    fusion_logits = conv1x1(fused, params["fusion_out"])
    return sar_logits, opt_logits, fusion_logits, {"sar": s_sar, "opt": s_opt}


def init_bn(topology=(8, 16)) -> Tuple[Tree, Tree]:
    """(bn_params, bn_state) with torch defaults (gamma=1, beta=0, mean=0,
    var=1)."""
    t0, t1 = topology
    chans = {"inc": t0, "down1": t1, "down2": t1, "up2": t0, "up1": t0}

    def tree(a, b, va, vb):
        return {k: {bn: {a: np.full(c, va, np.float32), b: np.full(c, vb, np.float32)}
                    for bn in ("bn1", "bn2")} for k, c in chans.items()}

    params = {s: tree("gamma", "beta", 1.0, 0.0) for s in ("sar", "opt")}
    state = {s: tree("mean", "var", 0.0, 1.0) for s in ("sar", "opt")}
    return to_torch(params), to_torch(state)


def to_frozen_consts(bn_params: Tree, bn_state: Tree) -> Tree:
    """Export trained BN to POPCORN's frozen scale/shift constants."""
    if "gamma" in bn_params:
        scale = bn_params["gamma"] / torch.sqrt(bn_state["var"] + BN_EPS)
        return {"scale": scale, "shift": bn_params["beta"] - bn_state["mean"] * scale}
    return {k: to_frozen_consts(v, bn_state[k]) for k, v in bn_params.items()}

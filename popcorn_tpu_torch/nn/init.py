"""Random parameter initialisation for the POPCORN model.

Counterpart of popcorn_tpu/nn/init.py::init_popcorn (the reference's
scheme, model/popcorn.py:59-66, 78-88): UNet convs get Kaiming-normal
(fan_out, relu) weights and uniform +-1/sqrt(fan_in) biases; transposed
and 1x1 convs keep torch's default uniform init; the head is
compat/weights.py::init_head with the final bias set to ``biasinit``; the
frozen BatchNorm constants are the identity. Draws come from a numpy
generator, so they are not JAX's bits; tests that compare the two
packages carry JAX-initialised parameters across instead.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ..compat.weights import init_head, to_torch
from ..config import ModelConfig
from .unet import OPT_IN, SAR_IN

Tree = Dict[str, Any]


def _conv(rng, kh, kw, cin, cout) -> Tree:
    std = (2.0 / (cout * kh * kw)) ** 0.5
    bound = 1.0 / (cin * kh * kw) ** 0.5
    return {
        "w": (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32),
        "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32),
    }


def _double_conv(rng, cin, cout) -> Tree:
    return {"conv1": _conv(rng, 3, 3, cin, cout), "conv2": _conv(rng, 3, 3, cout, cout)}


def _tconv(rng, c) -> Tree:
    bound = 1.0 / (c * 4) ** 0.5
    return {
        "w": rng.uniform(-bound, bound, (c, 2, 2, c)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (c,)).astype(np.float32),
    }


def _out_conv(rng, cin, cout=1) -> Tree:
    bound = 1.0 / cin**0.5
    return {
        "w": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32),
    }


def init_stream(rng, cin, topology=(8, 16)) -> Tree:
    t0, t1 = topology
    return {
        "inc": _double_conv(rng, cin, t0),
        "down1": _double_conv(rng, t0, t1),
        "down2": _double_conv(rng, t1, t1),
        "up2": {"tconv": _tconv(rng, t1), "conv": _double_conv(rng, 2 * t1, t0)},
        "up1": {"tconv": _tconv(rng, t0), "conv": _double_conv(rng, 2 * t0, t0)},
    }


def init_dual_stream(rng, topology=(8, 16)) -> Tree:
    t0 = topology[0]
    return {
        "sar": init_stream(rng, SAR_IN, topology),
        "opt": init_stream(rng, OPT_IN, topology),
        "sar_out": _out_conv(rng, t0),
        "opt_out": _out_conv(rng, t0),
        "fusion_out": _out_conv(rng, 2 * t0),
    }


def init_dual_stream_bn(topology=(8, 16)) -> Tree:
    t0, t1 = topology

    def dc(c):
        ident = {"scale": np.ones((c,), np.float32), "shift": np.zeros((c,), np.float32)}
        return {"bn1": dict(ident), "bn2": dict(ident)}

    stream = {"inc": dc(t0), "down1": dc(t1), "down2": dc(t1), "up2": dc(t0), "up1": dc(t0)}
    return {"sar": stream, "opt": {k: dict(v) for k, v in stream.items()}}


def init_popcorn(seed: int, cfg: ModelConfig) -> Tuple[Tree, Tree]:
    """Random (params, consts) from ``numpy.random.default_rng(seed)``:
    the pretrained=False branch of the trainer."""
    rng = np.random.default_rng(seed)
    params = {
        "unet": to_torch(init_dual_stream(rng)),
        "head": init_head(int(rng.integers(2**31)), biasinit=cfg.biasinit),
    }
    consts = {
        "unet_bn": to_torch(init_dual_stream_bn()),
        "builder": {"params": to_torch(init_dual_stream(rng)), "bn": to_torch(init_dual_stream_bn())},
    }
    return params, consts

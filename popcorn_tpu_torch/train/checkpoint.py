"""Checkpoint save/resume as reference-format ``.pth`` files.

Counterpart of popcorn_tpu/train/checkpoint.py, which writes Orbax
directories. The port writes what the reference's run_train.py:445-476
writes: {'model': state_dict, 'optimizer', 'epoch', 'iter'} with the keys
``unetmodel.*``, ``building_extractor.*``, ``head.{0,2,4,6}.*``
(compat/weights.py::save_popcorn_checkpoint), so the JAX package's
compat/torch_convert.py::load_popcorn_checkpoint and the port's eval
``load_member`` both read it. The optimizer entry holds the Adam state
(train/state.py) as {'count', 'lr', 'mu': {name: tensor}, 'nu': {...}}
with dotted parameter names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..compat.weights import load_popcorn_checkpoint, save_popcorn_checkpoint, to_torch
from .state import tree_flatten, tree_unflatten

Tree = Dict[str, Any]


def _flat(tree: Tree) -> Dict[str, torch.Tensor]:
    return {".".join(p): v.detach().cpu() for p, v in tree_flatten(tree)}


def _unflat(d: Dict[str, torch.Tensor], device) -> Tree:
    return to_torch(tree_unflatten((tuple(k.split(".")), v) for k, v in d.items()), device)


def save_checkpoint(
    path: str, params: Tree, consts: Tree, opt_state: Optional[Dict[str, Any]],
    epoch: int, iteration: int,
) -> None:
    opt = None
    if opt_state is not None:
        opt = {
            "count": int(opt_state["count"]), "lr": float(opt_state["lr"]),
            "mu": _flat(opt_state["mu"]), "nu": _flat(opt_state["nu"]),
        }
    save_popcorn_checkpoint(path, params, consts, epoch=epoch, iteration=iteration, optimizer=opt)


def restore_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """{'params', 'consts', 'opt_state' (None when the file has none),
    'epoch', 'iter'} with tensors on ``device``."""
    params, consts = load_popcorn_checkpoint(path, device)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    opt = ck.get("optimizer")
    opt_state = None
    if opt is not None:
        opt_state = {
            "count": int(opt["count"]), "lr": float(opt["lr"]),
            "mu": _unflat(opt["mu"], device), "nu": _unflat(opt["nu"], device),
        }
    return {
        "params": params, "consts": consts, "opt_state": opt_state,
        "epoch": int(ck.get("epoch", 0)), "iter": int(ck.get("iter", 0)),
    }

"""Optimizer chain and the train step.

Counterpart of popcorn_tpu/train/state.py. The optimizer is written out
with optax's semantics, in this order (the reference's torch Adam + clip +
StepLR, run_train.py:82-93, 233-234):

  * global-norm clipping: g * max_norm / norm when norm >= max_norm
    (optax.clip_by_global_norm; torch's clip_grad_norm_ divides by
    norm + 1e-6 instead);
  * weight decay added to the gradient before the moments, everywhere
    except head.l4 (the reference's no-decay group head.6.*);
  * Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), then -lr;
  * the learning rate lives in the optimizer state, so StepLR changes it
    between epochs (optax.inject_hyperparams).

A parameter frozen by a memory tier gets a gradient of zero, not None:
optax still decays its moments and applies m/(sqrt(v)+eps), which
torch.optim.Adam would skip for a None gradient.

One step: photometric augmentation -> normalization -> sparse-masked
POPCORN forward -> census loss * lam_weak -> backward -> update, with the
memory-tier flags as arguments and TF32 off (nn/ops.py::float32_exact).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..config import ModelConfig, TrainConfig
from ..data.normalize import NormStats, normalize_and_assemble, photometric_s2_traced
from ..losses.losses import get_loss
from ..nn.ops import float32_exact
from ..nn.popcorn import popcorn_forward, popcorn_predict

Tree = Dict[str, Any]
Path = Tuple[str, ...]

# Batch keys carrying one row per sample (everything else — 'photometric'
# and future batch-level leaves — is shared by every microbatch).
PER_SAMPLE_KEYS = (
    "S2", "S1", "VIIRS", "admin_mask", "census_idx", "y", "building_counts"
)


def tree_flatten(tree: Tree, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs in sorted key order, as jax.tree_util orders
    dict keys."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += tree_flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_unflatten(pairs) -> Tree:
    out: Tree = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def keystr(path: Path) -> str:
    """jax.tree_util.keystr of a dict path: "['head']['l1']['b']"."""
    return "".join(f"['{k}']" for k in path)


def decay_mask(path: Path) -> bool:
    """True where weight decay applies: everywhere except head.l4 (the
    reference's no-decay group head.6.{weight,bias}, run_train.py:85-89)."""
    return not ("head" in path and "l4" in path)


def step_lr(base_lr: float, epoch: int, step_size: int, gamma: float) -> float:
    """StepLR schedule value at ``epoch`` (torch semantics)."""
    return base_lr * (gamma ** (epoch // step_size))


class Optimizer:
    """The optax chain of popcorn_tpu/train/state.py::make_optimizer on
    parameter trees of tensors. The state is {'count', 'lr', 'mu', 'nu'}."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig):
        self.clip = tc.gradient_clip
        self.weight_decay = tc.weight_decay
        self.learning_rate = tc.learning_rate

    def init(self, params: Tree) -> Dict[str, Any]:
        def zeros():
            return tree_unflatten((p, torch.zeros_like(v)) for p, v in tree_flatten(params))

        return {"count": 0, "lr": self.learning_rate, "mu": zeros(), "nu": zeros()}

    def update(self, grads: Tree, state: Dict[str, Any], params: Tree) -> Tuple[Tree, Dict[str, Any]]:
        """(new params, new state); nothing is updated in place."""
        flat = tree_flatten(params)
        paths = [p for p, _ in flat]
        gd = dict(tree_flatten(grads))
        g = [gd[p].float() for p in paths]
        if self.clip > 0:
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
            keep = norm < self.clip
            g = [torch.where(keep, t, (t / norm) * self.clip) for t in g]
        if self.weight_decay > 0:
            g = [
                t + self.weight_decay * v if decay_mask(p) else t
                for t, (p, v) in zip(g, flat)
            ]
        mu_d, nu_d = dict(tree_flatten(state["mu"])), dict(tree_flatten(state["nu"]))
        count = state["count"] + 1
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(1 - (one * self.b1) ** count)
        bc2 = float(1 - (one * self.b2) ** count)
        new_p, new_mu, new_nu = [], [], []
        for t, (p, v) in zip(g, flat):
            mu = (1 - self.b1) * t + self.b1 * mu_d[p]
            nu = (1 - self.b2) * (t * t) + self.b2 * nu_d[p]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            new_p.append((p, v + u * (-state["lr"])))
            new_mu.append((p, mu))
            new_nu.append((p, nu))
        new_state = {
            "count": count, "lr": state["lr"],
            "mu": tree_unflatten(new_mu), "nu": tree_unflatten(new_nu),
        }
        return tree_unflatten(new_p), new_state


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def set_learning_rate(opt_state: Dict[str, Any], lr: float) -> Dict[str, Any]:
    """The injected learning rate for the next updates."""
    opt_state["lr"] = float(lr)
    return opt_state


def _model_inputs(mcfg: ModelConfig, stats: NormStats, batch, photometric: bool):
    sample = {}
    if mcfg.s2 and "S2" in batch:
        # S2 may arrive as integers (the feed ships lossless S2 in 2 bytes);
        # upcast before the photometric aug
        s2 = batch["S2"].float()
        sample["S2"] = photometric_s2_traced(s2, batch["photometric"]) if photometric else s2
    if mcfg.s1 and "S1" in batch:
        sample["S1"] = batch["S1"]
    if mcfg.viirs and "VIIRS" in batch:
        sample["VIIRS"] = batch["VIIRS"]
    inputs = {
        "input": normalize_and_assemble(sample, stats),
        "admin_mask": batch["admin_mask"],
        "census_idx": batch["census_idx"],
    }
    if "building_counts" in batch:
        inputs["building_counts"] = batch["building_counts"]
    return inputs


class TrainStep:
    """The train step of popcorn_tpu/train/state.py::make_train_step.

    ``step(params, opt_state, batch, generator, *, encoder_no_grad,
    unet_no_grad, collect_watch, mask) -> (params, opt_state, aux)``;
    ``step.grads(...)`` returns the averaged gradients and aux without the
    update. batch: {'S2','S1' (B,H,W,C) raw, 'admin_mask' (B,H,W),
    'census_idx','y' (B,), 'photometric' (4,)} as tensors on one device.
    ``mask`` (B,H,W) bool replaces the drawn sparsity mask."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, consts: Tree,
                 stats: NormStats, optimizer: Optimizer):
        self.mcfg, self.tcfg, self.consts = mcfg, tcfg, consts
        self.stats, self.optimizer = stats, optimizer

    def loss_fn(self, params, batch, generator, encoder_no_grad, unet_no_grad, mask):
        out = popcorn_forward(
            params, self.consts, _model_inputs(self.mcfg, self.stats, batch, True),
            self.mcfg, train=True, padding=False, encoder_no_grad=encoder_no_grad,
            unet_no_grad=unet_no_grad, sparse=True, generator=generator, mask=mask,
        )
        loss, aux = get_loss(
            out["popcount"], batch["y"], scale_abs_mean=out["scale_abs_mean"],
            loss=self.tcfg.loss, lam=self.tcfg.lam,
            scale_regularization=self.tcfg.scale_regularization, tag="weak",
        )
        optim_loss = loss * self.tcfg.lam_weak
        aux["optimization_loss"] = optim_loss
        aux["popcount"] = out["popcount"]
        return optim_loss, aux

    def _value_and_grad(self, params, batch, generator, enc, unet, mask):
        flat = tree_flatten(params)
        leaves = [v.detach().requires_grad_(True) for _, v in flat]
        tparams = tree_unflatten((p, q) for (p, _), q in zip(flat, leaves))
        loss, aux = self.loss_fn(tparams, batch, generator, enc, unet, mask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a frozen leaf's gradient is zero, not None (see the module doc)
        grads = [torch.zeros_like(q) if d is None else d for q, d in zip(leaves, grads)]
        aux = {k: v.detach() for k, v in aux.items()}
        return tree_unflatten((p, d) for (p, _), d in zip(flat, grads)), aux

    def grads(self, params, batch, generator=None, *, encoder_no_grad=False,
              unet_no_grad=False, mask=None):
        """Gradients of the loss, averaged over ``tcfg.grad_accum``
        microbatches when it divides the batch (one microbatch's
        activations live at a time), and aux: scalars averaged over the
        microbatches, popcount restacked in input order."""
        n_micro = max(1, int(self.tcfg.grad_accum))
        b = batch["y"].shape[0]
        with float32_exact():
            if not (n_micro > 1 and b >= n_micro and b % n_micro == 0):
                return self._value_and_grad(params, batch, generator, encoder_no_grad,
                                            unet_no_grad, mask)
            mb = b // n_micro
            g_sum, auxs = None, []
            for i in range(n_micro):
                sl = slice(i * mb, (i + 1) * mb)
                # split ONLY the per-sample keys: the length-4 photometric
                # vector must reach every microbatch whole (B == 4 would
                # otherwise look per-sample)
                mbatch = {k: (v[sl] if k in PER_SAMPLE_KEYS else v) for k, v in batch.items()}
                g, aux = self._value_and_grad(
                    params, mbatch, generator, encoder_no_grad, unet_no_grad,
                    None if mask is None else mask[sl],
                )
                g_sum = g if g_sum is None else tree_unflatten(
                    (p, a + d) for (p, a), (_, d) in zip(tree_flatten(g_sum), tree_flatten(g))
                )
                auxs.append(aux)
        grads = tree_unflatten((p, v / n_micro) for p, v in tree_flatten(g_sum))
        aux = {
            k: (torch.cat([a[k] for a in auxs]) if auxs[0][k].dim() >= 1
                else torch.stack([a[k] for a in auxs]).mean())
            for k in auxs[0]
        }
        return grads, aux

    def __call__(self, params, opt_state, batch, generator=None, *, encoder_no_grad=False,
                 unet_no_grad=False, collect_watch=False, mask=None):
        grads, aux = self.grads(params, batch, generator, encoder_no_grad=encoder_no_grad,
                                unet_no_grad=unet_no_grad, mask=mask)
        if collect_watch:
            # per-layer gradient norms for the wandb.watch equivalent
            # (reference run_train.py:75)
            aux["watch"] = {
                keystr(p): torch.sqrt(torch.sum(g.float() ** 2)) for p, g in tree_flatten(grads)
            }
        params, opt_state = self.optimizer.update(grads, opt_state, params)
        return params, opt_state, aux


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, consts: Tree,
                    stats: NormStats, optimizer: Optimizer) -> TrainStep:
    return TrainStep(mcfg, tcfg, consts, stats, optimizer)


def make_eval_popcount(mcfg: ModelConfig, consts: Tree, stats: NormStats) -> Callable:
    """No-grad popcount for weak validation (run_train.py:289-312): no
    augmentation, the eval forward through the kernels."""

    def fn(params, batch):
        inputs = _model_inputs(mcfg, stats, batch, False)
        return popcorn_predict(params, consts, inputs, mcfg, padding=False)["popcount"]

    return fn

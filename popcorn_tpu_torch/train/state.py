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
The forward, the backward and the update are the spans ``step.forward``,
``step.backward`` and ``step.optimizer`` (utils/profiling.py).

Data parallelism (``mesh``, dist/mesh.py): each rank holds its rows of
the global batch (``shard_batch``) and computes the GLOBAL loss: the
popcounts, targets and the scale regulariser's masked sums of every rank
are gathered, with the gradient flowing through this rank's own terms
only (``Mesh.gather_rows_with_grad``, ``Mesh.sum_with_grad``), so a
rank's gradient is its share of the single-device gradient (for a mean
loss, its own loss scaled by its share of the global valid count) and
padded rows ('valid' False, ``pad_batch_to_multiple``) weigh nothing.
One all-reduce over a flat buffer of the trainable leaves then sums the
shares, after ``grads`` and before ``Optimizer.update``, so the
global-norm clip sees the global gradient. Leaves frozen by a memory tier
stay zero and out of the reduce. The sparsity mask's empty-batch test is
the global batch's (``sparsity_mask(any_fn=)``), and the logged values
are the global batch's, as in the JAX package's sharded step.

Spatial training (``tcfg.spatial_train``): every rank holds every sample,
but only its rows [u0, u1) of each crop (dist/mesh.py::shard_batch_spatial,
which records them as 'row_block'). The rank runs the frozen builder over
those rows and the member UNet over its window (dist/rows.py::
member_window), keeps the features of its own rows [k0, k1) before the
head, so no context row reaches the loss, and sums the crop's terms over
the ranks: each sample's popcount and the scale regulariser's numerator
through ``Mesh.sum_with_grad``, its denominator through an all-reduce. The
context is at least the receptive field, so a rank's kept outputs depend
on the parameters only through its own graph, and the sum of the ranks'
gradient shares (``reduce_grads``) is the single-device gradient; the
sparsity lattice is drawn over the whole crop and each rank keeps its
rows. A rank whose block is empty adds nothing, and takes part in every
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..config import ModelConfig, TrainConfig
from ..data.normalize import NormStats, normalize_and_assemble, photometric_s2_traced
from ..losses.losses import get_loss
from ..dist.rows import Rows, member_window
from ..nn.ops import float32_exact
from ..nn.popcorn import (
    compute_dtype,
    create_building_score,
    popcorn_forward,
    popcorn_predict,
    sparsity_mask,
)
from ..utils.profiling import span

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
    'census_idx','y' (B,), 'photometric' (4,)} as tensors on one device,
    and under a ``mesh`` optionally 'valid' (B,) bool: this rank's rows of
    the global batch (module docstring), or with 'row_block' this rank's
    rows of every sample (spatial training). ``mask`` (B,H,W) bool, the
    whole crops' under spatial training, replaces the drawn sparsity
    mask."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, consts: Tree,
                 stats: NormStats, optimizer: Optimizer, mesh=None):
        self.mcfg, self.tcfg, self.consts = mcfg, tcfg, consts
        self.stats, self.optimizer = stats, optimizer
        self.mesh = mesh if mesh is not None and mesh.n_data > 1 else None
        # a rank's window takes the builder's score of its rows as input
        self.member_cfg = dataclasses.replace(mcfg, sentinel_buildings=False)
        self.unused: frozenset = frozenset()  # leaves of the last grads with no gradient

    def _global_any(self, t: torch.Tensor) -> torch.Tensor:
        r = self.mesh.all_reduce(t.reshape(1).to(torch.int32), op=torch.distributed.ReduceOp.MAX)
        return r[0] > 0

    def _global_terms(self, out, batch):
        """The global batch's popcounts and targets (valid rows) and scale
        regulariser, differentiable through this rank's terms: the samples
        gathered from every rank, or under spatial training each sample's
        popcount summed over the ranks' rows."""
        mesh = self.mesh
        pc = out["popcount"]
        valid = batch.get("valid")
        v = (torch.ones(pc.shape[0], dtype=torch.bool, device=pc.device) if valid is None
             else torch.as_tensor(valid, device=pc.device).bool())
        if "row_block" in batch:
            popcount, y = mesh.sum_with_grad(pc), batch["y"]
        else:
            keep = mesh.all_gather(v.to(torch.uint8)).bool()
            popcount = mesh.gather_rows_with_grad(pc)[keep]
            y = mesh.all_gather(torch.as_tensor(batch["y"], device=pc.device).float())[keep]
        sam = None
        if out["scale"] is not None:
            w = out["sparsity_mask"] & v[:, None, None]
            num = mesh.sum_with_grad(torch.sum(torch.abs(out["scale"]) * w))
            den = mesh.all_reduce(torch.sum(w).float().reshape(1))[0]
            sam = num / torch.clamp(den, min=1)
        return popcount, y, sam

    def _block_forward(self, params, batch, generator, encoder_no_grad, unet_no_grad, mask):
        """The forward of this rank's rows of every crop (module
        docstring): popcorn_forward's outputs over the kept rows."""
        mcfg = self.mcfg
        hp, k0, k1, u0, _ = batch["row_block"]
        inputs = _model_inputs(mcfg, self.stats, batch, True)
        x = inputs["input"]
        if k0 == k1:  # no rows here
            score = x.new_zeros(x.shape[:3])
        elif "building_counts" not in inputs or mcfg.sentinel_buildings:
            score = create_building_score(self.consts["builder"], x, s1=mcfg.s1, s2=mcfg.s2,
                                          nir=mcfg.nir, dtype=compute_dtype(mcfg))
        else:
            score = inputs["building_counts"]
            score = score[..., 0] if score.dim() == 4 else score
        kept = slice(k0 - u0, k1 - u0)
        admin = inputs["admin_mask"][:, kept]
        if mask is None:
            mask = sparsity_mask(generator, score[:, kept], admin, inputs["census_idx"],
                                 occupancy=mcfg.occupancy_model, any_fn=self._global_any,
                                 rows=(hp, k0, k1))
        else:
            mask = mask[:, k0:k1]
        if k0 == k1:  # zero terms, no graph
            zero = x.new_zeros((x.shape[0], 0, x.shape[2]))
            return {"popcount": x.new_zeros(x.shape[0]), "sparsity_mask": mask,
                    "scale": zero if mcfg.occupancy_model else None}
        xw, sw, keep, cols = member_window(x, score, Rows(hp, k0, k1), u0)
        return popcorn_forward(
            params, self.consts, {"input": xw, "building_counts": sw, "admin_mask": admin,
                                  "census_idx": inputs["census_idx"]},
            self.member_cfg, train=True, padding=None, encoder_no_grad=encoder_no_grad,
            unet_no_grad=unet_no_grad, sparse=True, mask=mask, keep=(keep, cols),
        )

    def loss_fn(self, params, batch, generator, encoder_no_grad, unet_no_grad, mask):
        if self.mesh is not None and "row_block" in batch:
            out = self._block_forward(params, batch, generator, encoder_no_grad, unet_no_grad,
                                      mask)
        else:
            out = popcorn_forward(
                params, self.consts, _model_inputs(self.mcfg, self.stats, batch, True),
                self.mcfg, train=True, padding=False, encoder_no_grad=encoder_no_grad,
                unet_no_grad=unet_no_grad, sparse=True, generator=generator, mask=mask,
                mask_any=None if self.mesh is None else self._global_any,
            )
        if self.mesh is None:
            popcount, y, sam = out["popcount"], batch["y"], out["scale_abs_mean"]
        else:
            popcount, y, sam = self._global_terms(out, batch)
        loss, aux = get_loss(
            popcount, y, scale_abs_mean=sam,
            loss=self.tcfg.loss, lam=self.tcfg.lam,
            scale_regularization=self.tcfg.scale_regularization, tag="weak",
        )
        optim_loss = loss * self.tcfg.lam_weak
        aux["optimization_loss"] = optim_loss
        # a rank's own samples; the crop's under spatial training
        aux["popcount"] = popcount if "row_block" in batch else out["popcount"]
        return optim_loss, aux

    def _value_and_grad(self, params, batch, generator, enc, unet, mask):
        flat = tree_flatten(params)
        leaves = [v.detach().requires_grad_(True) for _, v in flat]
        tparams = tree_unflatten((p, q) for (p, _), q in zip(flat, leaves))
        with span("step.forward"):
            loss, aux = self.loss_fn(tparams, batch, generator, enc, unet, mask)
        with span("step.backward"):
            # a spatial rank with no rows has a loss without a graph
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True) if loss.requires_grad
                     else [None] * len(leaves))
            self.unused = frozenset(p for (p, _), d in zip(flat, grads) if d is None)
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
                mbatch = {k: (v[sl] if k in PER_SAMPLE_KEYS or k == "valid" else v)
                          for k, v in batch.items()}
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

    def reduce_grads(self, grads: Tree) -> Tree:
        """The sum of every rank's gradient shares: one all-reduce over a
        flat buffer of the leaves that had a gradient on some rank in the
        last ``grads`` (frozen leaves stay zero and out of it; a spatial
        rank with no rows has none)."""
        flat = tree_flatten(grads)
        used = torch.tensor([p not in self.unused for p, _ in flat], dtype=torch.int32)
        used = self.mesh.all_reduce(used, op=torch.distributed.ReduceOp.MAX).bool().tolist()
        live = [g for (_, g), u in zip(flat, used) if u]
        if not live:
            return grads
        buf = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in live]))
        out, off = [], 0
        for (p, g), u in zip(flat, used):
            if u:
                g = buf[off:off + g.numel()].view_as(g)
                off += g.numel()
            out.append((p, g))
        return tree_unflatten(out)

    def __call__(self, params, opt_state, batch, generator=None, *, encoder_no_grad=False,
                 unet_no_grad=False, collect_watch=False, mask=None):
        grads, aux = self.grads(params, batch, generator, encoder_no_grad=encoder_no_grad,
                                unet_no_grad=unet_no_grad, mask=mask)
        if self.mesh is not None:
            grads = self.reduce_grads(grads)
        if collect_watch:
            # per-layer gradient norms for the wandb.watch equivalent
            # (reference run_train.py:75)
            aux["watch"] = {
                keystr(p): torch.sqrt(torch.sum(g.float() ** 2)) for p, g in tree_flatten(grads)
            }
        with span("step.optimizer"):
            params, opt_state = self.optimizer.update(grads, opt_state, params)
        return params, opt_state, aux


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, consts: Tree,
                    stats: NormStats, optimizer: Optimizer, mesh=None) -> TrainStep:
    return TrainStep(mcfg, tcfg, consts, stats, optimizer, mesh)


def make_eval_popcount(mcfg: ModelConfig, consts: Tree, stats: NormStats) -> Callable:
    """No-grad popcount for weak validation (run_train.py:289-312): no
    augmentation, the eval forward through the kernels."""

    def fn(params, batch):
        inputs = _model_inputs(mcfg, stats, batch, False)
        return popcorn_predict(params, consts, inputs, mcfg, padding=False)["popcount"]

    return fn

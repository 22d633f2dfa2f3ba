"""One training step of the port against the JAX package's make_train_step
on the same numpy-seeded batch and the same JAX-initialised parameters
(pretrained=False, fused_head=True, layout='plain', 2x64x64, the JAX
sparsity mask injected), in all three memory tiers; the port's optimizer
against the optax chain of make_optimizer; grad_accum; and the sparsity
mask's semantics.

The JAX gradients are read exactly through a probe transformation whose
state keeps the incoming updates. Tolerances: loss rtol 1e-4; every
gradient leaf rtol 1e-4 and atol 1e-4 * max|leaf| (float32 through two
UNets, their backward and the head, summed over 8192 pixels in another
order); a frozen leaf must be exactly zero in both. The optimizer: rtol
1e-5 (the same float32 update formulas, a different reduction order in the
global norm)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.config import TrainConfig as JTrainConfig
from popcorn_tpu.data.normalize import NormStats as JNormStats
from popcorn_tpu.data.normalize import normalize_and_assemble as j_normalize
from popcorn_tpu.data.normalize import photometric_s2_traced as j_photometric
from popcorn_tpu.nn.init import init_popcorn as j_init
from popcorn_tpu.nn.popcorn import create_building_score as j_score
from popcorn_tpu.nn.popcorn import sparsity_mask as j_sparsity_mask
from popcorn_tpu.train.state import make_optimizer as j_make_optimizer
from popcorn_tpu.train.state import make_train_step as j_make_train_step
from popcorn_tpu_torch.compat.weights import from_jax
from popcorn_tpu_torch.config import ModelConfig, TrainConfig
from popcorn_tpu_torch.data.normalize import NormStats
from popcorn_tpu_torch.nn.popcorn import sparsity_mask
from popcorn_tpu_torch.train.state import (
    PER_SAMPLE_KEYS,
    keystr,
    make_optimizer,
    make_train_step,
    tree_flatten,
)

torch.set_num_threads(1)
TIERS = {
    "full": dict(encoder_no_grad=False, unet_no_grad=False),
    "encoder_frozen": dict(encoder_no_grad=True, unet_no_grad=False),
    "unet_frozen": dict(encoder_no_grad=True, unet_no_grad=True),
}
ENCODER = ("inc", "down1", "down2")


def _batch(b, h=64, w=64, seed=2, photometric=(1.0, 0.9, 1.0, 1.1)):
    rng = np.random.default_rng(seed)
    idx = np.arange(1, b + 1, dtype=np.float32)
    # each sample's admin region is a part of its crop: -1 pads and a
    # neighbour's id elsewhere
    admin = np.where(rng.random((b, h, w)) < 0.7, idx[:, None, None], -1.0).astype(np.float32)
    return {
        "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
        "admin_mask": admin,
        "census_idx": idx,
        "y": rng.uniform(10, 1000, (b,)).astype(np.float32),
        "photometric": np.asarray(photometric, np.float32),
    }


def _grad_probe():
    """An optax transformation that applies nothing and keeps the incoming
    gradients as its state: the step's gradients, exactly."""

    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), updates

    return optax.GradientTransformation(init, update)


def _jax_mask(jconsts, batch, key):
    """The mask popcorn_forward draws from ``key`` inside the JAX step."""
    s2 = j_photometric(jnp.asarray(batch["S2"]), jnp.asarray(batch["photometric"]))
    x = j_normalize({"S2": s2, "S1": jnp.asarray(batch["S1"])}, JNormStats())
    score = j_score(jconsts["builder"], x, s1=True, s2=True, nir=True, layout="plain")
    return np.asarray(j_sparsity_mask(key, score, jnp.asarray(batch["admin_mask"]),
                                      jnp.asarray(batch["census_idx"]), occupancy=True))


@pytest.fixture(scope="module")
def model():
    jmcfg = JModelConfig(pretrained=False, fused_head=True, layout="plain", biasinit=0.9407)
    jparams, jconsts = j_init(jax.random.PRNGKey(0), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    return jmcfg, jparams, jconsts, params, consts


@pytest.fixture(scope="module")
def jax_step(model):
    jmcfg, jparams, jconsts, _, _ = model
    probe = _grad_probe()
    step = j_make_train_step(jmcfg, JTrainConfig(), jconsts, JNormStats(), probe)
    return step, probe


@pytest.mark.parametrize("tier", list(TIERS))
def test_train_step_grads_match_jax(model, jax_step, tier):
    jmcfg, jparams, jconsts, params, consts = model
    step, probe = jax_step
    batch = _batch(2)
    key = jax.random.PRNGKey(7)
    _, grads_ref, aux_ref = step(jparams, probe.init(jparams), batch, key, **TIERS[tier])
    mask = _jax_mask(jconsts, batch, key)

    tstep = make_train_step(ModelConfig(biasinit=0.9407, pretrained=False), TrainConfig(),
                            consts, NormStats(), make_optimizer(TrainConfig()))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, aux = tstep.grads(params, tbatch, mask=torch.from_numpy(mask.copy()), **TIERS[tier])

    np.testing.assert_allclose(float(aux["optimization_loss"]),
                               float(aux_ref["optimization_loss"]), rtol=1e-4)
    np.testing.assert_allclose(aux["popcount"].numpy(), np.asarray(aux_ref["popcount"]), rtol=1e-4)
    ref = dict(tree_flatten(jax.tree.map(np.asarray, grads_ref)))
    got = dict(tree_flatten(grads))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        g = got[path].numpy()
        frozen = path[0] == "unet" and (
            TIERS[tier]["unet_no_grad"]
            or (TIERS[tier]["encoder_no_grad"] and len(path) > 2 and path[2] in ENCODER)
            or path[1] in ("sar_out", "opt_out", "fusion_out")
        )
        if frozen:
            assert not r.any() and not g.any(), f"{keystr(path)} is frozen"
            continue
        assert np.abs(r).max() > 0, keystr(path)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=keystr(path))


def test_optimizer_matches_optax_chain(model):
    """Two updates with weight decay (reaching the head.l4 mask) and the
    global-norm clip active; the learning rate changed in between as
    StepLR does."""
    _, jparams, _, params, _ = model
    tc = dict(weight_decay=0.05, gradient_clip=0.01, learning_rate=1e-3)
    jopt = j_make_optimizer(JTrainConfig(**tc))
    opt = make_optimizer(TrainConfig(**tc))
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(5)
    jp, tp = jparams, params
    for it in range(2):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jparams)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, state = opt.update(from_jax(g, {})[0], state, tp)
        if it == 0:
            jstate.hyperparams["learning_rate"] = jnp.asarray(5e-4, jnp.float32)
            state["lr"] = 5e-4
    ref = dict(tree_flatten(jax.tree.map(np.asarray, jp)))
    for path, v in tree_flatten(tp):
        np.testing.assert_allclose(v.numpy(), ref[path], rtol=1e-5, atol=1e-7, err_msg=keystr(path))
    assert state["count"] == 2


def _port_step(consts, **tc):
    tcfg = TrainConfig(**tc)
    return make_train_step(ModelConfig(pretrained=False), tcfg, consts, NormStats(),
                           make_optimizer(tcfg))


@pytest.mark.parametrize("photometric", [(0.0, 1.0, 0.0, 1.0), (1.0, 0.8, 1.0, 1.3)],
                         ids=["identity", "b4_photometric"])
def test_grad_accum_equals_microbatch_mean(model, photometric):
    """grad_accum=2 over B=4 == the mean of the two B=2 microbatch
    gradients (same masks); the length-4 photometric vector must reach
    both microbatches whole, not be split as if it were per-sample."""
    _, _, _, params, consts = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, 32, 32, seed=9, photometric=photometric).items()}
    mask = torch.from_numpy(np.random.default_rng(9).random((4, 32, 32)) < 0.5)
    grads, aux = _port_step(consts, grad_accum=2).grads(params, batch, mask=mask)
    one = _port_step(consts)
    parts = []
    for sl in (slice(0, 2), slice(2, 4)):
        mb = {k: (v[sl] if k in PER_SAMPLE_KEYS else v) for k, v in batch.items()}
        parts.append(one.grads(params, mb, mask=mask[sl]))
    np.testing.assert_allclose(
        float(aux["optimization_loss"]),
        np.mean([float(a["optimization_loss"]) for _, a in parts]), rtol=1e-6,
    )
    np.testing.assert_allclose(
        aux["popcount"].numpy(), torch.cat([a["popcount"] for _, a in parts]).numpy(), rtol=1e-6
    )
    g0, g1 = dict(tree_flatten(parts[0][0])), dict(tree_flatten(parts[1][0]))
    for path, v in tree_flatten(grads):
        np.testing.assert_allclose(v.numpy(), ((g0[path] + g1[path]) / 2).numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=keystr(path))


def test_train_step_updates_and_watches(model):
    """The full step: an update that moves the trainable leaves, no frozen
    out conv moved by the zero gradient, and the per-leaf gradient norms."""
    _, _, _, params, consts = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 32, 32, seed=4).items()}
    step = _port_step(consts)
    opt_state = step.optimizer.init(params)
    new, opt_state, aux = step(params, opt_state, batch, torch.Generator().manual_seed(0),
                               collect_watch=True)
    old = dict(tree_flatten(params))
    moved = {keystr(p): bool((v != old[p]).any()) for p, v in tree_flatten(new)}
    assert moved["['head']['l4']['b']"] and moved["['unet']['sar']['inc']['conv1']['w']"]
    assert not moved["['unet']['fusion_out']['w']"]
    assert set(aux["watch"]) == set(moved)
    assert float(aux["watch"]["['unet']['fusion_out']['w']"]) == 0.0
    assert opt_state["count"] == 1


def test_sparsity_mask_semantics():
    """tests/test_losses_and_aug.py::test_sparsity_mask_semantics on the
    port's mask."""
    rng = np.random.default_rng(1600)
    b, h, w = 2, 80, 90
    buildings = torch.from_numpy((rng.random((b, h, w, 1)) > 0.7).astype(np.float32))
    admin = torch.from_numpy(rng.integers(0, 3, (b, h, w)).astype(np.float32))
    idx = torch.tensor([1.0, 2.0])
    m = sparsity_mask(torch.Generator().manual_seed(0), buildings, admin, idx, occupancy=True).numpy()
    admin_sel = admin.numpy() == idx.numpy()[:, None, None]
    assert not m[~admin_sel].any()
    bsel = (buildings.numpy()[..., 0] > 0) & admin_sel
    assert m[bsel].all()
    assert m.sum() > bsel.sum()
    # the lattice is one draw shared by the batch, on 60 rows x 60 columns
    extra = m & ~bsel
    assert extra.any(axis=(0, 2)).sum() <= 60 and extra.any(axis=(0, 1)).sum() <= 60
    # an empty batch mask falls back to the whole admin region
    none = torch.full((b, h, w), 5.0)
    m2 = sparsity_mask(torch.Generator().manual_seed(0), buildings, none, idx, occupancy=True)
    assert not m2.any()
    empty_b = torch.zeros_like(buildings)
    m3 = sparsity_mask(torch.Generator().manual_seed(1), empty_b, admin, idx, occupancy=False)
    np.testing.assert_array_equal(m3.numpy(), admin_sel)


def test_train_config_fields_match_jax():
    """Every TrainConfig field of the JAX package, with its default."""
    ref = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got == ref

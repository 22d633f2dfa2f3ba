"""The unfused head (``ModelConfig(fused_head=False)``, ``--no_fused_head``)
against the JAX package's ``fused_head=False`` with ``layout='plain'``, on
the same numpy-seeded inputs and the same JAX-initialised weights.

Tolerances:
- float32: maps rtol 2e-4 / atol 2e-5 and popcount rtol 2e-4, the
  whole-model bound of tests/test_torch_popcorn.py; the train step's
  gradients rtol 1e-4 and atol 1e-4 * max|leaf| a leaf, the bound of
  tests/test_torch_train_step.py.
- bfloat16: the bounds of tests/test_torch_bf16.py. The train forward and
  the step's gradients run the same op-by-op rounding on both sides
  (relative L2 <= 1e-2, correlation >= 0.9999); the eval's frozen UNets
  are kernels A/B in the port (their plain versions here) and XLA ops in
  JAX's plain engine, which round in other places (correlation >= 0.999).
"""

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
from popcorn_tpu.nn.init import init_popcorn as j_init
from popcorn_tpu.nn.popcorn import head_apply as j_head_apply
from popcorn_tpu.nn.popcorn import popcorn_forward as j_forward
from popcorn_tpu.train.state import make_train_step as j_make_train_step
from popcorn_tpu_torch.compat.weights import from_jax
from popcorn_tpu_torch.config import ModelConfig, TrainConfig
from popcorn_tpu_torch.data.normalize import NormStats
from popcorn_tpu_torch.nn import head as hd
from popcorn_tpu_torch.nn import popcorn as pc
from popcorn_tpu_torch.nn.popcorn import popcorn_forward
from popcorn_tpu_torch.train.state import make_optimizer, make_train_step, tree_flatten

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_RTOL = 1e-4
REL_L2 = 1e-2
CORR_SAME, CORR_XLA = 0.9999, 0.999
DTYPES = ("float32", "bfloat16")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close_bf16(got, ref, corr_min: float, what: str) -> None:
    a, b = _np(ref).ravel().astype(np.float64), _np(got).ravel().astype(np.float64)
    rel = np.linalg.norm(b - a) / np.linalg.norm(a)
    corr = np.corrcoef(a, b)[0, 1]
    assert rel <= REL_L2 and corr >= corr_min, f"{what}: relative L2 {rel}, correlation {corr}"


@pytest.fixture(scope="module")
def model():
    jmcfg = JModelConfig(pretrained=False, fused_head=False, layout="plain", biasinit=0.9407)
    jparams, jconsts = j_init(jax.random.PRNGKey(3), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    return jmcfg, jparams, jconsts, params, consts


def _inputs(seed=41, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return {
        "input": rng.normal(size=(b, h, w, 6)).astype(np.float32),
        "building_counts": rng.uniform(0, 1, (b, h, w)).astype(np.float32),
    }


def _configs(jmcfg, dtype):
    return (dataclasses.replace(jmcfg, compute_dtype=dtype),
            ModelConfig(pretrained=False, fused_head=False, biasinit=0.9407, compute_dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unfused_forward_matches_jax(model, train, dtype):
    jmcfg, jparams, jconsts, params, consts = model
    jcfg, cfg = _configs(jmcfg, dtype)
    x = _inputs()
    ref = j_forward(jparams, jconsts, {k: jnp.asarray(v) for k, v in x.items()}, jcfg,
                    train=train, padding=False)
    with torch.set_grad_enabled(train):
        got = popcorn_forward(params, consts, {k: torch.from_numpy(v) for k, v in x.items()}, cfg,
                              train=train, padding=False)
    assert got["popdensemap"].dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_np(got["popdensemap"]), _np(ref["popdensemap"]), **TOL)
        np.testing.assert_allclose(_np(got["popcount"]), _np(ref["popcount"]), rtol=2e-4)
    else:
        corr = CORR_SAME if train else CORR_XLA
        _assert_close_bf16(got["popdensemap"], ref["popdensemap"], corr, f"map ({dtype})")
        _assert_close_bf16(got["popcount"], ref["popcount"], 0.0, f"popcount ({dtype})")


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_unfused_matches_jax_head_apply(model, dtype):
    """The head alone: bf16 operands and outputs, biases added in bf16, as
    popcorn_tpu/nn/ops.py::conv1x1 does."""
    _, jparams, _, params, _ = model
    feats = np.random.default_rng(5).normal(size=(2, 16, 24, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    ref = j_head_apply(jparams["head"], jnp.asarray(feats), jdt, fused=False)
    got = hd.head_unfused(params["head"], torch.from_numpy(feats), tdt)
    assert got.shape == (2, 16, 24, 2) and got.dtype == (tdt or torch.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    else:
        _assert_close_bf16(got, ref, CORR_SAME, "head")


def _grad_probe():
    """An optax transformation that applies nothing and keeps the incoming
    gradients as its state: the JAX step's gradients, exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def _batch(b=2, h=64, w=64, seed=2):
    rng = np.random.default_rng(seed)
    idx = np.arange(1, b + 1, dtype=np.float32)
    return {
        "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
        "admin_mask": np.where(rng.random((b, h, w)) < 0.7, idx[:, None, None], -1.0).astype(np.float32),
        "census_idx": idx,
        "y": rng.uniform(10, 1000, (b,)).astype(np.float32),
        "photometric": np.asarray((1.0, 0.9, 1.0, 1.1), np.float32),
    }


def _jax_head_grads(jcfg, jparams, jconsts, batch, flags):
    probe = _grad_probe()
    jstep = j_make_train_step(jcfg, JTrainConfig(), jconsts, JNormStats(), probe)
    _, jgrads, jaux = jstep(jparams, probe.init(jparams), batch, jax.random.PRNGKey(7), **flags)
    ref = {p: r for p, r in tree_flatten(jax.tree.map(np.asarray, jgrads)) if p[0] == "head"}
    return ref, float(jaux["optimization_loss"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_unfused_step_grads_match_jax(model, dtype):
    """One train step's gradients (unet_no_grad: the head's leaves alone
    take a gradient) against jax.grad inside the JAX step; the sparsity
    mask is the JAX step's, injected (a full-ones admin region makes the
    lattice irrelevant).

    In bf16 the weights' gradients are held to JAX's bf16 step, the
    biases' to its float32 step: XLA on the CPU sums a bf16 bias gradient
    over the 8192 pixels in bf16, which puts JAX's bf16 bias gradients
    56-84% (relative L2) from its own float32 ones on this batch, where the
    port's, summed in float32, lie within 0.6%."""
    jmcfg, jparams, jconsts, params, consts = model
    jcfg, cfg = _configs(jmcfg, dtype)
    batch = _batch()
    batch["admin_mask"] = np.broadcast_to(batch["census_idx"][:, None, None], (2, 64, 64)).copy()
    flags = dict(encoder_no_grad=True, unet_no_grad=True)
    ref, jloss = _jax_head_grads(jcfg, jparams, jconsts, batch, flags)
    step = make_train_step(cfg, TrainConfig(), consts, NormStats(), make_optimizer(TrainConfig()))
    mask = torch.ones((2, 64, 64), dtype=torch.bool)
    grads, aux = step.grads(params, {k: torch.from_numpy(v) for k, v in batch.items()}, mask=mask,
                            **flags)
    got = {p: g.numpy() for p, g in tree_flatten(grads) if p[0] == "head"}
    assert got.keys() == ref.keys() and len(ref) == 8
    if dtype == "float32":
        np.testing.assert_allclose(float(aux["optimization_loss"]), jloss, rtol=1e-4)
        for path, r in ref.items():
            assert np.abs(r).max() > 0, path
            np.testing.assert_allclose(got[path], r, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(r).max(), err_msg=str(path))
        return
    np.testing.assert_allclose(float(aux["optimization_loss"]), jloss, rtol=REL_L2)
    ref32, _ = _jax_head_grads(jmcfg, jparams, jconsts, batch, flags)
    for path in sorted(ref, key=str):
        r = ref[path] if path[-1] == "w" else ref32[path]
        _assert_close_bf16(got[path], r, CORR_SAME, f"gradient {path}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unfused_route_takes_no_head_kernel(model, monkeypatch, train):
    """fused_head=False never reaches the wrappers of kernels C and D; the
    default (fused) does."""
    *_, params, consts = model

    def refuse(*a, **k):
        raise AssertionError("a head kernel's wrapper was called")

    monkeypatch.setattr(pc, "head_apply", refuse)
    monkeypatch.setattr(pc, "head_train", refuse)
    x = {k: torch.from_numpy(v) for k, v in _inputs(b=1, h=32, w=32).items()}
    cfg = ModelConfig(pretrained=False, fused_head=False)
    with torch.set_grad_enabled(train):
        out = popcorn_forward(params, consts, x, cfg, train=train, padding=False)
        assert torch.isfinite(out["popdensemap"]).all()
        with pytest.raises(AssertionError, match="head kernel"):
            popcorn_forward(params, consts, x, dataclasses.replace(cfg, fused_head=True),
                            train=train, padding=False)


def test_fused_head_is_the_default():
    assert ModelConfig().fused_head is True
    assert JModelConfig().fused_head is False  # JAX's CLIs turn it on on a TPU only

"""The one-rank train step's float32 gradients against float64 ones, on
tests/test_torch_spatial_train.py's 1x300x64 crop (its crop "b", the
JAX-initialised weights, the mask the JAX step draws from PRNGKey(5)).

The port's float32 step and the JAX package's agree in loss to 3.5e-7 on
this crop, but their gradients differ by up to 3.2e-4 norm-relative in a
leaf. The float64 runs tell float32 rounding from a difference in the
backward: the port's plain step in float64 (the parameters, constants,
normalization statistics and batch cast; ``Tensor.float`` keeps float64,
so no cast narrows it) and the JAX step in float64 (a subprocess with
jax_enable_x64 and jnp.float32 taken as float64, the same mask injected).
The two float64 steps agree to float32 rounding of the normalization
statistics (8.7e-8 measured), so the backward is the same; the port's
float32 gradients lie within 1.9e-6 of the float64 ones and the JAX
package's within 3.2e-4: the gap between the float32 steps is the JAX
package's float32 summation on the CPU, not a fault of the port. The
bounds below are those measurements with headroom; the port's float32
step must stay no further from float64 than twice the JAX package's."""

import contextlib
import os
import subprocess
import sys
import textwrap

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
from popcorn_tpu.train.state import make_train_step as j_make_train_step
from popcorn_tpu_torch.compat.weights import from_jax
from popcorn_tpu_torch.config import ModelConfig, TrainConfig
from popcorn_tpu_torch.data.normalize import NormStats
from popcorn_tpu_torch.train.state import make_optimizer, make_train_step, tree_flatten
from test_torch_spatial_train import CROPS, KEY, _crop, _jax_mask

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_AGREE = 1e-6  # the two float64 steps, worst leaf (measured 8.7e-8)
PORT_F32 = 1e-5  # the port's float32 step from float64 (measured 1.9e-6)
JAX_F32 = 1e-3  # the JAX package's float32 step from float64 (measured 3.2e-4)

# the JAX step in float64, in its own process: x64 is process-wide, and the
# JAX package casts to jnp.float32 by name; the weights are drawn before
# x64 is on, so they are the float32 run's, widened
JAX_F64 = textwrap.dedent("""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from popcorn_tpu.config import ModelConfig, TrainConfig
    from popcorn_tpu.data.normalize import NormStats
    from popcorn_tpu.nn.init import init_popcorn
    import popcorn_tpu.nn.popcorn as jpop
    from popcorn_tpu.train.state import make_train_step

    root = sys.argv[1]
    mcfg = ModelConfig(pretrained=False, fused_head=False, layout="plain", biasinit=0.9407)
    params, consts = jax.tree.map(np.asarray, init_popcorn(jax.random.PRNGKey(0), mcfg))
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a, t)
    params, consts = wide(params), wide(consts)
    mask = jnp.asarray(np.load(root + "/mask.npy"))
    jpop.sparsity_mask = lambda *a, **k: mask
    batch = {k: v.astype(np.float64) for k, v in np.load(root + "/crop.npz").items()}
    probe = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                         lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    step = make_train_step(mcfg, TrainConfig(), consts, NormStats(), probe)
    _, grads, aux = step(params, probe.init(params), batch, jax.random.PRNGKey(int(sys.argv[2])))
    flat = {}
    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            flat["/".join(path)] = np.asarray(t)
    walk(grads, ())
    assert all(v.dtype == np.float64 for v in flat.values())
    np.savez(root + "/jax64.npz", loss=np.asarray(aux["optimization_loss"]), **flat)
""")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


@contextlib.contextmanager
def _float64_kept():
    """``Tensor.float`` leaves a float64 tensor as it is (the port casts to
    float32 by that name, for integer S2 and for its outputs)."""
    narrow = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 else narrow(self, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = narrow


def _port_grads(params, consts, crop, mask, dtype):
    stats = NormStats(device="cpu")
    for k, v in vars(stats).items():
        if isinstance(v, torch.Tensor):
            setattr(stats, k, v.to(dtype))
    tcfg = TrainConfig()
    step = make_train_step(ModelConfig(pretrained=False, biasinit=0.9407), tcfg,
                           _cast(consts, dtype), stats, make_optimizer(tcfg))
    batch = {k: _cast(torch.from_numpy(v), dtype) for k, v in crop.items()}
    grads, aux = step.grads(_cast(params, dtype), batch, mask=mask)
    return {"/".join(p): g for p, g in tree_flatten(grads)}, float(aux["optimization_loss"])


def _worst_leaf(got, ref):
    """The largest norm-relative difference over the leaves with a gradient."""
    return max(float((got[k].double() - ref[k]).norm() / ref[k].norm())
               for k in ref if float(ref[k].norm()) > 0)


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    root = tmp_path_factory.mktemp("float64_step")
    jmcfg = JModelConfig(pretrained=False, fused_head=False, layout="plain", biasinit=0.9407)
    jparams, jconsts = j_init(jax.random.PRNGKey(0), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    crop = _crop(*CROPS["b"])
    mask = _jax_mask(jconsts, crop)
    np.save(root / "mask.npy", mask)
    np.savez(root / "crop.npz", **crop)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", JAX_F64, str(root), str(KEY)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        tmask = torch.from_numpy(mask.copy())
        port32, loss32 = _port_grads(params, consts, crop, tmask, torch.float32)
        with _float64_kept():
            port64, loss64 = _port_grads(params, consts, crop, tmask, torch.float64)
        probe = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                             lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
        jstep = j_make_train_step(jmcfg, JTrainConfig(), jconsts, JNormStats(), probe)
        _, jg, jaux = jstep(jparams, probe.init(jparams), crop, jax.random.PRNGKey(KEY))
        jax32 = {"/".join(p): torch.from_numpy(np.asarray(g).copy())
                 for p, g in tree_flatten(jax.tree.map(np.asarray, jg))}
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    j64 = np.load(root / "jax64.npz")
    jax64 = {k: torch.from_numpy(j64[k]) for k in j64.files if k != "loss"}
    return {"port32": port32, "port64": port64, "jax32": jax32, "jax64": jax64,
            "losses": {"port32": loss32, "port64": loss64,
                       "jax32": float(jaux["optimization_loss"]), "jax64": float(j64["loss"])}}


def test_float64_steps_agree(grads):
    """The port's and the JAX package's steps in float64 compute the same
    gradients: the backward is the same function."""
    assert grads["port64"]["unet/opt/inc/conv1/w"].dtype == torch.float64
    assert grads["port64"].keys() == grads["jax64"].keys() == grads["port32"].keys()
    # the losses: 9.3e-10 apart (the statistics' float32 rounding)
    np.testing.assert_allclose(grads["losses"]["port64"], grads["losses"]["jax64"], rtol=1e-8)
    assert _worst_leaf(grads["port64"], grads["jax64"]) <= F64_AGREE


def test_float32_steps_against_float64(grads):
    """Each float32 step's gradients from the float64 ones: the port's no
    further off than twice the JAX package's, and both within the pinned
    bounds."""
    port = _worst_leaf(grads["port32"], grads["port64"])
    jax_ = _worst_leaf(grads["jax32"], grads["port64"])
    assert port <= PORT_F32, port
    assert jax_ <= JAX_F32, jax_
    assert port <= 2 * jax_, (port, jax_)
    for name in ("port32", "jax32"):
        np.testing.assert_allclose(grads["losses"][name], grads["losses"]["port64"], rtol=1e-6)

"""Port kernel A (DoubleConv), plain version on the CPU, against the JAX
package's Pallas fused_double_conv (interpret mode on the CPU) and its
XLA unet.double_conv, on the same seeded NHWC inputs.

Tolerance rtol=atol=2e-5: both sides compute in float32 with different
summation orders, the bound tests/test_pallas_conv.py uses for the same
block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.nn import unet as junet
from popcorn_tpu.nn.pallas_conv import fused_double_conv
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.nn import double_conv as dc

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _block(rng, cin, cm, cout):
    def n(shape, s):
        return (rng.normal(size=shape) * s).astype(np.float32)

    p = {
        "conv1": {"w": n((3, 3, cin, cm), 0.3), "b": n((cm,), 1.0)},
        "conv2": {"w": n((3, 3, cm, cout), 0.3), "b": n((cout,), 1.0)},
    }
    bn = {
        "bn1": {"scale": n((cm,), 1.0), "shift": n((cm,), 1.0)},
        "bn2": {"scale": n((cout,), 1.0), "shift": n((cout,), 1.0)},
    }
    return p, bn


@pytest.mark.parametrize(
    "shape,cm,cout", [((2, 24, 40, 2), 8, 8), ((1, 19, 37, 16), 16, 16)]
)
def test_double_conv_matches_jax(shape, cm, cout):
    rng = np.random.default_rng(11)
    p, bn = _block(rng, shape[-1], cm, cout)
    x = rng.normal(size=shape).astype(np.float32)
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()}
    jbn = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in bn.items()}
    pallas = fused_double_conv(
        jnp.asarray(x), jp["conv1"]["w"], jp["conv1"]["b"], jbn["bn1"],
        jp["conv2"]["w"], jp["conv2"]["b"], jbn["bn2"],
    )
    xla = junet.double_conv(jp, jbn, jnp.asarray(x))
    got = dc.double_conv(to_torch(p), to_torch(bn), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


def test_fold_affine_matches_unfolded():
    """The (s, t) fold the kernel applies equals (conv + b) * scale + shift."""
    rng = np.random.default_rng(12)
    p, bn = _block(rng, 4, 8, 8)
    tp, tbn = to_torch(p), to_torch(bn)
    s, t = dc.fold_affine(tp["conv1"]["b"], tbn["bn1"])
    conv = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    ref = (conv + tp["conv1"]["b"]) * tbn["bn1"]["scale"] + tbn["bn1"]["shift"]
    np.testing.assert_allclose((conv * s + t).numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.default_rng(13)
    p, bn = _block(rng, 2, 8, 8)
    before = dc.launches
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 2)).astype(np.float32))
    out = dc.double_conv(to_torch(p), to_torch(bn), x)
    assert out.shape == (1, 8, 8, 8) and out.device.type == "cpu"
    assert dc.launches == before

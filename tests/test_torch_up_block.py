"""Port kernel B (Up block), plain version on the CPU, against the JAX
package: unet._up_block for even and odd skips (odd skips exercise
pad_to_match), and the whole UNet stream against the JAX packed stream
with every block a Pallas kernel (interpret mode on the CPU).

Tolerances as tests/test_pallas_conv.py: 2e-5 for one block, rtol 2e-4 /
atol 2e-5 for the five-block stream (float32, different summation
orders, errors compound through the blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.nn import packed as K
from popcorn_tpu.nn import unet as junet
from popcorn_tpu.nn.init import init_popcorn
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.nn import unet, up_block

torch.set_num_threads(1)


def _up_params(rng, c1, cs, cm):
    def n(shape, s):
        return (rng.normal(size=shape) * s).astype(np.float32)

    p = {
        "tconv": {"w": n((c1, 2, 2, c1), 0.3), "b": n((c1,), 1.0)},
        "conv": {
            "conv1": {"w": n((3, 3, cs + c1, cm), 0.3), "b": n((cm,), 1.0)},
            "conv2": {"w": n((3, 3, cm, cm), 0.3), "b": n((cm,), 1.0)},
        },
    }
    bn = {
        "bn1": {"scale": n((cm,), 1.0), "shift": n((cm,), 1.0)},
        "bn2": {"scale": n((cm,), 1.0), "shift": n((cm,), 1.0)},
    }
    return p, bn


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


@pytest.mark.parametrize(
    "skip,coarse",
    [((2, 24, 40, 16), (2, 12, 20, 16)), ((1, 19, 37, 8), (1, 9, 18, 16))],
)
def test_up_block_matches_jax(skip, coarse):
    rng = np.random.default_rng(21)
    p, bn = _up_params(rng, coarse[-1], skip[-1], 8)
    x1 = rng.normal(size=coarse).astype(np.float32)
    x2 = rng.normal(size=skip).astype(np.float32)
    ref = junet._up_block(_jax_tree(p), _jax_tree(bn), jnp.asarray(x1), jnp.asarray(x2))
    got = up_block.up_block(to_torch(p), to_torch(bn), torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == skip[:3] + (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_unet_stream_matches_jax_pallas_stream():
    params, consts = init_popcorn(jax.random.PRNGKey(2), JModelConfig(pretrained=False))
    jp, jbn = params["unet"]["sar"], consts["unet_bn"]["sar"]
    rng = np.random.default_rng(22)
    x = rng.normal(size=(1, 64, 96, 2)).astype(np.float32)
    f = 4
    ref = K.unpack(
        K.packed_unet_stream(jp, jbn, K.pack(jnp.asarray(x), f), f, use_pallas=True),
        f, 8,
    )
    got = unet.unet_stream(
        to_torch(jax.tree.map(np.asarray, jp)), to_torch(jax.tree.map(np.asarray, jbn)),
        torch.from_numpy(x),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)

"""The port's popcorn_forward (eval, occupancy model, sentinel buildings,
the repo's DDA weights and a seeded head) against the JAX package's
popcorn_forward in its default configuration, on one seeded input.

Tolerance rtol 2e-4 / atol 2e-5 for the maps and rtol 2e-4 for popcount:
float32 through two 10-conv UNets and the head, with the JAX side on its
packed engine (a different but equivalent summation order), the bound
tests/test_pallas_conv.py uses for whole-model comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.nn.popcorn import create_building_score as j_score
from popcorn_tpu.nn.popcorn import popcorn_forward as j_forward
from popcorn_tpu_torch.compat.weights import from_jax
from popcorn_tpu_torch.config import ModelConfig
from popcorn_tpu_torch.nn.popcorn import create_building_score, popcorn_forward, reorder_to_dda

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jparams, jconsts = load_popcorn_from_dda(
        JModelConfig(biasinit=0.9407), head_key=jax.random.PRNGKey(9)
    )
    tparams, tconsts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    x = np.random.default_rng(41).normal(size=(1, 64, 64, 6)).astype(np.float32)
    return jparams, jconsts, tparams, tconsts, x


def test_reorder_to_dda():
    x = torch.arange(6, dtype=torch.float32).reshape(1, 1, 1, 6)
    assert reorder_to_dda(x, s1=True, s2=True, nir=True).flatten().tolist() == [4, 5, 2, 1, 0, 3]
    assert reorder_to_dda(x, s1=True, s2=False, nir=False).flatten().tolist() == [0, 1, 0, 0, 0, 0]


def test_building_score_matches_jax(setup):
    jparams, jconsts, tparams, tconsts, x = setup
    ref = j_score(jconsts["builder"], jnp.asarray(x), s1=True, s2=True, nir=True)
    got = create_building_score(tconsts["builder"], torch.from_numpy(x), s1=True, s2=True, nir=True)
    assert got.shape == (1, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_popcorn_forward_matches_jax(setup):
    jparams, jconsts, tparams, tconsts, x = setup
    ref = j_forward(
        jparams, jconsts, {"input": jnp.asarray(x)}, JModelConfig(biasinit=0.9407),
        train=False, padding=False, sparse=False,
    )
    got = popcorn_forward(
        tparams, tconsts, {"input": torch.from_numpy(x)}, ModelConfig(biasinit=0.9407),
        padding=False,
    )
    np.testing.assert_allclose(got["popdensemap"].numpy(), np.asarray(ref["popdensemap"]), **TOL)
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(ref["scale"]), **TOL)
    np.testing.assert_allclose(got["popcount"].numpy(), np.asarray(ref["popcount"]), rtol=2e-4)
    assert float(got["popcount"][0]) > 0

"""Weights carried across between the JAX package and the port: the DDA
checkpoint loads bit for bit the same in both, and POPCORN members saved
by either package load into the other with the same arrays."""

import jax
import numpy as np
import pytest
import torch

from popcorn_tpu.compat import torch_convert as tc
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu_torch.compat import weights as W
from popcorn_tpu_torch.config import ModelConfig, find_dda_checkpoint

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)}


def _assert_same(a, b, exact=True):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].shape == lb[k].shape, k
        if exact:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
        else:
            np.testing.assert_allclose(la[k], lb[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def jax_dda():
    return tc.load_popcorn_from_dda(JModelConfig(), head_key=jax.random.PRNGKey(4))


def test_dda_checkpoint_is_found_beside_the_package():
    path = find_dda_checkpoint()
    assert path is not None and path.endswith("fusionda_newAug8_16_checkpoint30_lossweight0.5.pt")


def test_from_jax_equals_direct_load_bit_for_bit(jax_dda):
    jparams, jconsts = jax.tree.map(np.asarray, jax_dda)
    tparams, tconsts = W.from_jax(jparams, jconsts)
    unet, unet_bn = W.load_dda()
    _assert_same(tparams["unet"], unet)
    _assert_same(tconsts["unet_bn"], unet_bn)
    _assert_same(tconsts["builder"]["params"], unet)
    _assert_same(tconsts["builder"]["bn"], unet_bn)
    _assert_same(tparams["head"], jparams["head"])


def test_port_member_loads_in_jax(tmp_path):
    params, consts = W.load_popcorn_from_dda(ModelConfig(biasinit=0.9407), head_seed=5)
    path = str(tmp_path / "m.pth")
    W.save_popcorn_checkpoint(path, params, consts)
    jparams, jconsts = tc.load_popcorn_checkpoint(path)
    _assert_same(jparams, params)
    # BN is exported as an equivalent eval-mode BN (running_var = 1 - eps),
    # so the refolded scale is equal to float32 rounding, not bit for bit
    _assert_same(jconsts, consts, exact=False)


def test_jax_member_loads_in_port(tmp_path, jax_dda):
    jparams, jconsts = jax_dda
    path = str(tmp_path / "j.pth")
    tc.save_popcorn_checkpoint(path, jparams, jconsts)
    tparams, tconsts = W.load_popcorn_checkpoint(path)
    j2params, j2consts = tc.load_popcorn_checkpoint(path)
    _assert_same(tparams, jax.tree.map(np.asarray, j2params))
    _assert_same(tconsts, jax.tree.map(np.asarray, j2consts))
    _assert_same(tparams, jax.tree.map(np.asarray, jparams))

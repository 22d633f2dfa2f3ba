"""Reflect padding wider than the side it pads (ROADMAP Queue 3, fault 7).

The reference's padding reflects a frame or patch up to a multiple of 64
(and the building extractor's by 14 px); jnp.pad reflects a pad wider than
the side again, as numpy does, where torch's F.pad raises. So the port's
whole-frame path raised for a frame under 22 rows or columns, such as the
JAX dry run's 16-row frame at two ranks, which the JAX package maps.
nn/ops.py::reflect_pad_hw pads as numpy does; these tests hold it to
np.pad, the port's add_padding to the JAX package's, and the port's
whole-frame map of small frames to the JAX package's (rtol 1e-5 / atol
1e-6, tests/test_torch_spatial.py's bound against its single-device
forward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh
from popcorn_tpu.infer import spatial as jsp
from popcorn_tpu.nn.init import init_popcorn as j_init
from popcorn_tpu.nn.ops import add_padding as j_add_padding
from popcorn_tpu_torch.compat.weights import from_jax
from popcorn_tpu_torch.config import ModelConfig
from popcorn_tpu_torch.infer import spatial as sp
from popcorn_tpu_torch.nn.ops import add_padding, reflect_pad_hw

torch.set_num_threads(1)


@pytest.mark.parametrize("h,w,pads", [(1, 5, (3, 2, 0, 4)), (3, 4, (7, 9, 11, 2)), (16, 64, (24, 24, 0, 0)),
                                      (5, 6, (4, 4, 5, 5)), (9, 9, (0, 0, 0, 0))])
def test_reflect_pad_hw_is_numpy_reflect(h, w, pads):
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    top, bottom, left, right = pads
    got = reflect_pad_hw(torch.from_numpy(x), top, bottom, left, right).numpy()
    want = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,force", [((1, 16, 20, 3), False), ((2, 10, 12, 6), True),
                                         ((1, 40, 33, 2), False)])
def test_add_padding_matches_jax(shape, force):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got, pad = add_padding(torch.from_numpy(x), force=force)
    want, jpad = j_add_padding(jnp.asarray(x), force=force)
    assert tuple(pad) == tuple(jpad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def model():
    jmcfg = JModelConfig(pretrained=False, fused_head=False)
    jparams, jconsts = j_init(jax.random.PRNGKey(0), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    return jmcfg, jparams, jconsts, params, consts


@pytest.mark.parametrize("h,w", [(16, 64), (20, 21)])
def test_small_frame_density_matches_jax(model, h, w):
    jmcfg, jparams, jconsts, params, consts = model
    rng = np.random.default_rng(h + w)
    s2 = rng.uniform(0, 4000, (h, w, 4)).astype(np.float32)
    s1 = rng.uniform(-25, 0, (h, w, 2)).astype(np.float32)
    ref, ref_cnt = jsp.spatial_density_map(jparams, jconsts, jmcfg, s2, s1, j_make_mesh(1))
    got, cnt = sp.spatial_density_map(params, consts, ModelConfig(pretrained=False), s2, s1,
                                      device="cpu")
    assert got.shape == (h, w)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cnt, float(ref_cnt), rtol=1e-5)

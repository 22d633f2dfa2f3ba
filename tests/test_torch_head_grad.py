"""The port's training head (nn/head.py::head_train, plain versions of
kernels C and D on the CPU) against jax.grad through the JAX package's
fused_head, whose backward is the Pallas _bwd_kernel in interpret mode on
the CPU.

Tolerance rtol 1e-4 / atol 1e-5, as tests/test_pallas_head.py holds the
fused gradients: float32 chains of depth 64, summed over every pixel in a
different order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.nn.init import init_head
from popcorn_tpu.nn.pallas_head import fused_head
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.nn import head as H

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _case(seed, shape):
    head = init_head(jax.random.PRNGKey(seed), biasinit=0.42)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(shape).astype(np.float32)
    return head, feats


def _jax_grads(head, feats):
    def loss(p, x):
        return jnp.sum(jnp.tanh(fused_head(p, x)))

    gp, gx = jax.grad(loss, argnums=(0, 1))(head, jnp.asarray(feats))
    return jax.tree.map(np.asarray, gp), np.asarray(gx)


def _torch_grads(head, feats, need_dx=True):
    p = {k: {n: v.requires_grad_(True) for n, v in d.items()}
         for k, d in to_torch(jax.tree.map(np.asarray, head)).items()}
    x = torch.from_numpy(feats).requires_grad_(need_dx)
    out = H.head_train(p, x)
    assert out.shape == (*feats.shape[:-1], 2)
    torch.sum(torch.tanh(out)).backward()
    return p, x


@pytest.mark.parametrize("shape", [(1, 32, 36, 16), (1, 7, 13, 16), (2, 5, 3, 16)],
                         ids=["tile", "ragged_1x7x13", "batch2"])
def test_head_train_grads_match_jax_fused_head(shape):
    head, feats = _case(sum(shape), shape)
    ref_p, ref_x = _jax_grads(head, feats)
    p, x = _torch_grads(head, feats)
    np.testing.assert_allclose(x.grad.numpy(), ref_x, **TOL)
    for layer in H.HEAD_LAYERS:
        for k in ("w", "b"):
            np.testing.assert_allclose(p[layer][k].grad.numpy(), ref_p[layer][k],
                                       err_msg=f"{layer}.{k}", **TOL)


def test_head_train_forward_matches_fused_head():
    head, feats = _case(5, (2, 8, 9, 16))
    ref = fused_head(head, jnp.asarray(feats))
    got = H.head_train(to_torch(jax.tree.map(np.asarray, head)), torch.from_numpy(feats))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_head_train_frozen_features_take_no_dx():
    """With features that need no gradient (the unet_no_grad tier) the
    weights still get theirs and no dx is formed."""
    head, feats = _case(9, (1, 6, 10, 16))
    ref_p, _ = _jax_grads(head, feats)
    p, x = _torch_grads(head, feats, need_dx=False)
    assert x.grad is None
    np.testing.assert_allclose(p["l1"]["w"].grad.numpy(), ref_p["l1"]["w"], **TOL)


def test_head_bwd_plain_is_the_autograd_of_head_plain():
    """The plain version of kernel D returns dx and the eight weight
    gradients in [w1, b1, ..., w4, b4] order."""
    head, feats = _case(11, (1, 4, 5, 16))
    thead = to_torch(jax.tree.map(np.asarray, head))
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((1, 4, 5, 2)).astype(np.float32))
    dx, grads = H.head_bwd_plain(thead, torch.from_numpy(feats), g)
    assert dx.shape == feats.shape
    shapes = [tuple(thead[n][k].shape) for n in H.HEAD_LAYERS for k in ("w", "b")]
    assert [tuple(t.shape) for t in grads] == shapes
    # db4 is the column sum of g
    np.testing.assert_allclose(grads[-1].numpy(), g.reshape(-1, 2).sum(0).numpy(), rtol=1e-6)

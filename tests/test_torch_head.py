"""Port kernel C (head), plain version on the CPU, against the JAX
package's Pallas heads (interpret mode on the CPU): the 2-channel
fused_head, and the channel-0 output against fused_packed_head over the
[sar | opt] packed lane split the member fold feeds it
(popcorn_tpu/nn/popcorn.py:464). Tolerance 1e-5, as
tests/test_pallas_head.py (float32 matmul chains of depth 64)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from popcorn_tpu.nn import packed as K
from popcorn_tpu.nn.init import init_head
from popcorn_tpu.nn.pallas_head import fused_head
from popcorn_tpu.nn.pallas_packed_head import fused_packed_head
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.nn import head as H

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed):
    head = init_head(jax.random.PRNGKey(seed), biasinit=0.9407)
    rng = np.random.default_rng(seed)
    feats = np.abs(rng.normal(size=(2, 8, 16, 16))).astype(np.float32)
    return head, to_torch(jax.tree.map(np.asarray, head)), feats


def test_head_two_channels_matches_fused_head():
    head, thead, feats = _inputs(31)
    ref = fused_head(head, jnp.asarray(feats))
    got = H.head_apply(thead, torch.from_numpy(feats), n_out=2)
    assert got.shape == (2, 8, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_head_channel0_matches_fused_packed_head():
    head, thead, feats = _inputs(32)
    f = 4
    fj = jnp.asarray(feats)
    feats_p = jnp.concatenate([K.pack(fj[..., :8], f), K.pack(fj[..., 8:], f)], -1)
    ref = K.unpack_scalar(fused_packed_head(head, feats_p, f, two_stream=True), f)
    got = H.head_apply(thead, torch.from_numpy(feats), n_out=1)[..., 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_head_ragged_pixel_count():
    """A pixel count that is no multiple of any tile size."""
    head, thead, _ = _inputs(33)
    rng = np.random.default_rng(33)
    feats = rng.normal(size=(1, 7, 13, 16)).astype(np.float32)
    ref = fused_head(head, jnp.asarray(feats))
    got = H.head_apply(thead, torch.from_numpy(feats), n_out=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

"""Kernel G's bf16 route on the CPU (its plain version) against the JAX
package's quantized DoubleConv at bfloat16, in every channel combination
of the DDA UNet's DoubleConvs (2/4 -> 8 -> 8, 8 -> 16 -> 16, 16 -> 16 -> 16)
and at an odd size with batch 2.

Bound: test_torch_int8_io.py::test_up_block_q_bf16_close_to_jax_interpret's
(max error < 0.05 x the output's max, correlation > 0.999). The JAX
package scales per 8-row slab of the padded image, the port per 16x16
tile: two valid quantizations of the same block, not the same one. The
JAX side runs fused_double_conv(dtype=bfloat16, quantized=True) in
interpret mode on the unpacked input (pack factor 1, where the lifted
weights are the block's own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.nn.pallas_conv import fused_double_conv
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.nn import double_conv as dc
from popcorn_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _n(rng, shape, s):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _dc_block(rng, cin, cm, cout):
    p = {
        "conv1": {"w": _n(rng, (3, 3, cin, cm), 0.3), "b": _n(rng, (cm,), 0.3)},
        "conv2": {"w": _n(rng, (3, 3, cm, cout), 0.3), "b": _n(rng, (cout,), 0.3)},
    }
    bn = {
        "bn1": {"scale": 1 + _n(rng, (cm,), 0.2), "shift": _n(rng, (cm,), 0.3)},
        "bn2": {"scale": 1 + _n(rng, (cout,), 0.2), "shift": _n(rng, (cout,), 0.3)},
    }
    return p, bn


def _jax_q_bf16(p, bn, x):
    j = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in p.items()}
    jb = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in bn.items()}
    ref = fused_double_conv(jnp.asarray(x).astype(jnp.bfloat16), j["conv1"]["w"], j["conv1"]["b"],
                            jb["bn1"], j["conv2"]["w"], j["conv2"]["b"], jb["bn2"],
                            dtype=jnp.bfloat16, quantized=True)
    assert ref.dtype == jnp.bfloat16
    return np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize(
    "shape,cm,cout",
    [((1, 24, 40, 2), 8, 8), ((1, 24, 40, 4), 8, 8), ((1, 20, 36, 8), 16, 16),
     ((1, 16, 24, 16), 16, 16), ((2, 37, 19, 4), 8, 8)],
    ids=["inc_sar", "inc_opt", "down1", "down2", "odd_batch2"],
)
def test_double_conv_q_bf16_close_to_jax_interpret(shape, cm, cout):
    """double_conv_q on a bf16 tensor (the int8 eval's default route):
    bf16 out, no launch counted on the CPU, close to the Pallas kernel."""
    rng = np.random.default_rng(401 + shape[-1] + shape[1])
    p, bn = _dc_block(rng, shape[-1], cm, cout)
    x = _n(rng, shape, 1.0)
    ref = _jax_q_bf16(p, bn, x)
    before = COUNTERS.summary()
    got = dc.double_conv_q(to_torch(p), to_torch(bn), torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16 and COUNTERS.since(before, "launches/") == {}
    assert got.shape == ref.shape
    a, b = ref.ravel(), got.float().numpy().ravel()
    assert float(np.abs(a - b).max()) < 0.05 * float(np.abs(a).max())
    assert np.corrcoef(a, b)[0, 1] > 0.999


def test_double_conv_q_cpu_route_rounds_the_float32_block():
    """The CPU route of a bf16 input: the plain version on the input
    widened to float32, its output rounded to bf16 once (what kernel G's
    bf16 mode computes on the card)."""
    rng = np.random.default_rng(411)
    p, bn = _dc_block(rng, 8, 16, 16)
    x = torch.from_numpy(_n(rng, (1, 21, 35, 8), 1.0)).to(BF16)
    tp, tbn = to_torch(p), to_torch(bn)
    got = dc.double_conv_q(tp, tbn, x)
    want = dc.double_conv_q_plain(*dc.q_args(tp, tbn), x.float()).to(BF16)
    assert got.dtype == BF16 and torch.equal(got, want)
    assert dc.double_conv_q(tp, tbn, x.float()).dtype == torch.float32

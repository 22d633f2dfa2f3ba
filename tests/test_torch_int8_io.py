"""The int8 Up blocks' bf16 I/O and their host plumbing, on the CPU (plain
versions of kernels F and H), against the JAX package at bfloat16, plus the
library yardstick chip_smoke.py times beside kernels E-H.

Bounds:
- up_block_q on bf16 tensors against fused_up_block(dtype=bfloat16,
  quantized=True) in interpret mode: test_torch_quant.py::
  test_up_block_q_close_to_f32's bound (max error < 0.05 x the output's
  max, correlation > 0.999). The two take their dynamic scales over
  different slabs (a 16x16 CUDA tile, an 8-row TPU slab), so they are two
  valid quantizations, not the same one.
- up_block_qs against fused_up_block_qs(dtype=bfloat16) with the same
  scales: the int8 codes equal, the bf16 features within one bf16 ulp of
  the JAX package's (both round the same float32 value to bf16, and that
  value may differ in its last float32 bits: XLA may fuse the affine).
- the static stream in bf16: the float32 stream's features rounded to
  bf16, bit for bit (the CPU route rounds once, at the end), and the JAX
  package's bf16 stream at test_torch_quant_stream.py's correlation bound.
- the library chains (torch._int_mm products) equal the plain versions
  bit for bit: integer sums are exact in both."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.nn import packed as K
from popcorn_tpu.nn.init import init_popcorn
from popcorn_tpu.nn.pallas_conv import fused_up_block, fused_up_block_qs
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.nn import double_conv as dc
from popcorn_tpu_torch.nn import quant, unet
from popcorn_tpu_torch.nn import up_block as ub
from popcorn_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(1)
BF16 = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _n(rng, shape, s):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _up_params(rng, c1, cs, cm=8):
    cin = cs + c1
    p = {
        "tconv": {"w": _n(rng, (c1, 2, 2, c1), 0.3), "b": _n(rng, (c1,), 0.3)},
        "conv": {"conv1": {"w": _n(rng, (3, 3, cin, cm), 0.3), "b": _n(rng, (cm,), 0.3)},
                 "conv2": {"w": _n(rng, (3, 3, cm, cm), 0.3), "b": _n(rng, (cm,), 0.3)}},
    }
    bn = {"bn1": {"scale": 1 + _n(rng, (cm,), 0.2), "shift": _n(rng, (cm,), 0.3)},
          "bn2": {"scale": 1 + _n(rng, (cm,), 0.2), "shift": _n(rng, (cm,), 0.3)}}
    return p, bn


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _t(v):
    return torch.tensor(np.float32(v))


def _lifted(jp, jbn, cs, f):
    """The packed Up block's weights at pack factor f (packed.py::_packed_up)."""
    w1 = jp["conv"]["conv1"]["w"]

    def lv(v):
        return K.lift_vec(v, f)

    return (K.lift_tconv(jp["tconv"]["w"], f), lv(jp["tconv"]["b"]),
            K.lift_conv3x3(w1[:, :, :cs], f), K.lift_conv3x3(w1[:, :, cs:], f),
            lv(jp["conv"]["conv1"]["b"]), {k: lv(v) for k, v in jbn["bn1"].items()},
            K.lift_conv3x3(jp["conv"]["conv2"]["w"], f), lv(jp["conv"]["conv2"]["b"]),
            {k: lv(v) for k, v in jbn["bn2"].items()})


@pytest.mark.parametrize("c1,cs,hw", [(16, 16, (12, 20)), (8, 8, (10, 14))], ids=["up2", "up1"])
def test_up_block_q_bf16_close_to_jax_interpret(c1, cs, hw):
    """Kernel H's bf16 route (plain version on the CPU) against the Pallas
    kernel at bf16 in interpret mode, both at pack factor 2 on the JAX
    side, as packed_unet_stream runs up2."""
    rng = np.random.default_rng(301 + c1)
    p, bn = _up_params(rng, c1, cs)
    h, w = hw
    x1 = np.abs(_n(rng, (1, h, w, c1), 1.0))
    x2 = np.abs(_n(rng, (1, 2 * h, 2 * w, cs), 1.0))
    f = 2
    jp, jbn = _jax(p), _jax(bn)
    ref = fused_up_block(jnp.asarray(x1), K.pack(jnp.asarray(x2), f), *_lifted(jp, jbn, cs, f),
                         dtype=jnp.bfloat16, quantized=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(K.unpack(ref, f, 8).astype(jnp.float32))
    before = COUNTERS.summary()
    got = ub.up_block_q(to_torch(p), to_torch(bn), torch.from_numpy(x1).to(BF16),
                        torch.from_numpy(x2).to(BF16))
    assert got.dtype == BF16 and COUNTERS.since(before, "launches/") == {}
    a, b = ref.ravel(), got.float().numpy().ravel()
    assert got.shape == ref.shape
    assert float(np.abs(a - b).max()) < 0.05 * float(np.abs(a).max())
    assert np.corrcoef(a, b)[0, 1] > 0.999


@pytest.mark.parametrize("float_out", [False, True], ids=["int8_out", "bf16_out"])
@pytest.mark.parametrize("c1,cs,hw", [(16, 16, (12, 20)), (8, 8, (10, 14))], ids=["up2", "up1"])
def test_up_block_qs_bf16_matches_jax(c1, cs, hw, float_out):
    """Kernel F's bf16 features (and its int8 codes in the same bf16 run)
    against fused_up_block_qs at dtype=bfloat16 with the same scales."""
    rng = np.random.default_rng(311 + c1)
    p, bn = _up_params(rng, c1, cs)
    h, w = hw
    x1 = np.abs(_n(rng, (1, h, w, c1), 1.0))
    x2 = np.abs(_n(rng, (1, 2 * h, 2 * w, cs), 1.0))
    s_x1, s_x2 = np.float32(x1.max() / 127), np.float32(x2.max() / 127)
    x1q = np.clip(np.round(x1 / s_x1), -127, 127).astype(np.int8)
    x2q = np.clip(np.round(x2 / s_x2), -127, 127).astype(np.int8)
    s_up, s_y1 = np.float32(0.02), np.float32(0.03)
    s_out = None if float_out else np.float32(0.025)
    f = 2
    jp, jbn = _jax(p), _jax(bn)
    ref = fused_up_block_qs(
        jnp.asarray(x1q), K.pack(jnp.asarray(x2q), f), *_lifted(jp, jbn, cs, f),
        jnp.float32(s_x1), jnp.float32(s_x2), jnp.float32(s_up), jnp.float32(s_y1),
        None if s_out is None else jnp.float32(s_out), dtype=jnp.bfloat16)
    ref = K.unpack(ref, f, 8)
    got = ub.up_block_qs(to_torch(p), to_torch(bn), torch.from_numpy(x1q), torch.from_numpy(x2q),
                         _t(s_x1), _t(s_x2), _t(s_up), _t(s_y1),
                         None if s_out is None else _t(s_out), dtype=BF16)
    if not float_out:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got != 0).float().mean() > 0.1
        return
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    a = np.asarray(ref.astype(jnp.float32))
    b = got.float().numpy()
    ulp = np.abs(a) * 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value
    assert np.all(np.abs(a - b) <= ulp), float(np.abs(a - b).max())
    assert (b != 0).mean() > 0.1


def test_static_stream_bf16_cpu_route():
    """unet_stream_qs at bf16 on the CPU: the float32 stream rounded once,
    at up1's output (the kernels' codes do not depend on the dtype), and
    close to the JAX package's bf16 static stream."""
    params, consts = init_popcorn(jax.random.PRNGKey(5), JModelConfig(pretrained=False))
    jp, jbn = params["unet"]["sar"], consts["unet_bn"]["sar"]
    tp, tbn = to_torch(jax.tree.map(np.asarray, jp)), to_torch(jax.tree.map(np.asarray, jbn))
    x = np.random.default_rng(321).normal(size=(1, 64, 96, 2)).astype(np.float32)
    f = 4
    jsc = K.calibrate_packed_stream(jp, jbn, K.pack(jnp.asarray(x), f), f)
    scales = {k: torch.tensor(np.float32(v)) for k, v in jsc.items()}
    xt = torch.from_numpy(x)
    before = COUNTERS.summary()
    got = unet.unet_stream_qs(tp, tbn, xt, scales, 8, BF16)
    f32 = unet.unet_stream_qs(tp, tbn, xt, scales, 8)
    assert COUNTERS.since(before, "launches/") == {}
    assert got.dtype == BF16 and f32.dtype == torch.float32
    assert torch.equal(got, f32.to(BF16))
    ref = np.asarray(K.unpack(K.packed_unet_stream_qs(jp, jbn, K.pack(jnp.asarray(x), f), f, jsc,
                                                      dtype=jnp.bfloat16), f, 8).astype(jnp.float32))
    assert np.corrcoef(ref.ravel(), got.float().numpy().ravel())[0, 1] > 0.9999


def test_qs_out_dtype():
    assert ub.qs_out_dtype(False) == torch.int8
    assert ub.qs_out_dtype(False, BF16) == torch.int8  # int8 codes whatever the dtype
    assert ub.qs_out_dtype(True) == torch.float32
    assert ub.qs_out_dtype(True, torch.float32) == torch.float32
    assert ub.qs_out_dtype(True, BF16) == BF16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ub.qs_out_dtype(True, torch.float16)


@pytest.mark.parametrize("d1,d2,want", [
    (BF16, BF16, BF16), (torch.float32, torch.float32, torch.float32),
    (BF16, torch.float32, torch.float32), (torch.float32, BF16, torch.float32),
    (torch.float16, torch.float16, torch.float32)])
def test_q_io_dtype(d1, d2, want):
    """Kernel H takes two bf16 inputs as they are; any other pair is
    widened to float32 (exactly) for its float32 mode."""
    assert ub.q_io_dtype(torch.zeros(1, dtype=d1), torch.zeros(1, dtype=d2)) == want


def test_up_block_q_cpu_route_keeps_x2_dtype():
    rng = np.random.default_rng(331)
    p, bn = _up_params(rng, 8, 8)
    x1 = torch.from_numpy(np.abs(_n(rng, (1, 9, 7, 8), 1.0)))
    x2 = torch.from_numpy(np.abs(_n(rng, (1, 19, 15, 8), 1.0)))
    tp, tbn = to_torch(p), to_torch(bn)
    got = ub.up_block_q(tp, tbn, x1.to(BF16), x2)
    assert got.dtype == torch.float32
    assert torch.equal(got, ub.up_block_q(tp, tbn, x1.to(BF16).float(), x2))
    got = ub.up_block_q(tp, tbn, x1.to(BF16), x2.to(BF16))
    assert got.dtype == BF16
    assert torch.equal(got, ub.up_block_q(tp, tbn, x1.to(BF16).float(), x2.to(BF16).float()).to(BF16))


@pytest.mark.parametrize("same", [True, False], ids=["same", "valid"])
@pytest.mark.parametrize("cin", [2, 8, 16])
def test_int_mm_conv_matches_codes_conv(cin, same):
    """chip_smoke.py's im2col on torch._int_mm: K = 9 Cin padded to 8."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(cin)
    xq = torch.randint(-127, 128, (2, 9, 11, cin), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, cin, 8), generator=g, dtype=torch.int8)
    assert torch.equal(cs.int_mm_conv3x3(xq, wq, same), quant.conv3x3_codes(xq, wq, same))


def test_int8_library_chains_match_plain_versions():
    """The yardstick chip_smoke.py times for E-H computes what the plain
    versions compute, bit for bit."""
    cs = _chip_smoke()
    rng = np.random.default_rng(341)
    p, bn = _up_params(rng, 16, 16)
    tp, tbn = to_torch(p), to_torch(bn)
    x1 = torch.from_numpy(np.abs(_n(rng, (2, 9, 10, 16), 1.0)))
    x2 = torch.from_numpy(np.abs(_n(rng, (2, 19, 21, 16), 1.0)))
    s = _t(0.02)
    for fo in (False, True):
        a = ub.qs_args(tp, tbn, s, s, s, s, None if fo else s)
        x1q, x2q = quant.quantize_static(x1, s), quant.quantize_static(x2, s)
        assert torch.equal(cs.up_qs_library(*a, x1q, x2q, fo), ub.up_block_qs_plain(*a, x1q, x2q, fo))
    a = ub.q_args(tp, tbn)
    assert torch.equal(cs.up_q_library(*a, x1, x2), ub.up_block_q_plain(*a, x1, x2))
    dp = {"conv1": p["conv"]["conv1"], "conv2": p["conv"]["conv2"]}
    tdp = to_torch({"conv1": {k: v[:, :, :16] if k == "w" else v for k, v in dp["conv1"].items()},
                    "conv2": dp["conv2"]})
    x = x2[..., :16]
    for fo in (False, True):
        a = dc.qs_args(tdp, tbn, s, s, None if fo else s)
        xq = quant.quantize_static(x, s)
        assert torch.equal(cs.dc_qs_library(*a, xq, fo), dc.double_conv_qs_plain(*a, xq, fo))
    a = dc.q_args(tdp, tbn)
    assert torch.equal(cs.dc_q_library(*a, x), dc.double_conv_q_plain(*a, x))

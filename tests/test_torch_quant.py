"""The port's int8 blocks (kernels E, F, G, H, plain versions on the CPU)
and quantization helpers against the JAX package, on the same seeded
inputs.

- Weight codes and scales: exact (the same float32 divisions and
  roundings). The tconv's scales are per (tap, channel), as the JAX
  package's per-column scales of the lifted tconv (packed.py::lift_tconv).
- Calibration: calibrate_stream against calibrate_packed_stream at rtol
  1e-5 (float32 maxima through convs summed in different orders).
- Static blocks E and F against the Pallas kernels (interpret mode) with
  the same scales injected: int8 codes equal on >= 99.9% of elements and
  never more than 1 apart (a code can flip where a requant lands within
  float32 rounding of a half); float outputs at rtol/atol 1e-5.
- Dynamic blocks G and H take one activation scale per CUDA tile, the
  JAX package one per TPU slab, so they are held to the float32 block at
  tests/test_pallas_conv.py::test_int8_double_conv_close_to_f32's bounds
  (max error < 0.05 x the output's max, correlation > 0.999).
- Member maps at test_int8_static_member_maps_close's bounds
  (correlation > 0.99, max error < 0.1 x the map's max)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.nn import packed as K
from popcorn_tpu.nn import unet as junet
from popcorn_tpu.nn.init import init_popcorn
from popcorn_tpu.nn.pallas_conv import _quantize_weight, fused_double_conv_qs, fused_up_block_qs
from popcorn_tpu.nn.popcorn import calibrate_member_scales as j_calibrate_member_scales
from popcorn_tpu.nn.popcorn import popcorn_forward as j_popcorn_forward
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.config import ModelConfig
from popcorn_tpu_torch.nn import double_conv as dc
from popcorn_tpu_torch.nn import quant
from popcorn_tpu_torch.nn import up_block as ub
from popcorn_tpu_torch.nn.popcorn import calibrate_member_scales, popcorn_forward, reorder_to_dda
from popcorn_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(1)
CODE_AGREE = 0.999


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


def _up_params(rng, c1, cs, cm):
    conv, bn = _dc_block(rng, cs + c1, cm, cm)
    p = {"tconv": {"w": _n(rng, (c1, 2, 2, c1), 0.3), "b": _n(rng, (c1,), 0.3)}, "conv": conv}
    return p, bn


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _t(v):
    return torch.tensor(np.float32(v))


def _codes(x, s):
    return np.clip(np.round(x / s), -127, 127).astype(np.int8)


def _assert_codes(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (d == 0).mean() >= CODE_AGREE, (d == 0).mean()
    assert d.max() <= 1, d.max()
    assert (ref != 0).mean() > 0.1  # the test sees real codes, not a ReLU'd zero map


def _close_to_f32(got, ref, err_share, corr_min):
    a, b = np.asarray(ref).ravel(), np.asarray(got).ravel()
    scale = float(np.abs(a).max())
    assert float(np.abs(a - b).max()) < err_share * scale
    assert np.corrcoef(a, b)[0, 1] > corr_min


@pytest.mark.parametrize("wbits", [8, 4])
def test_quantize_weight_matches_jax(wbits):
    w = _n(np.random.default_rng(1), (3, 3, 6, 16), 0.3)
    jq, js = _quantize_weight(jnp.asarray(w.reshape(9, 6, 16)), wbits=wbits)
    tq, ts = quant.quantize_conv_weight(torch.from_numpy(w), wbits)
    assert tq.dtype == torch.int8 and int(tq.abs().max()) == (127 if wbits == 8 else 7)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).reshape(3, 3, 6, 16))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("wbits", [8, 4])
def test_tconv_scales_per_tap_match_jax_lifted(wbits):
    """The JAX package quantizes the lifted tconv per column; at f=2 column
    (dy*2 + dx)*Cout + c holds w[:, dy, dx, c], so its scale is the port's
    (dy, dx, c) scale, and its codes the port's."""
    c1, cout = 16, 8
    w = _n(np.random.default_rng(2), (c1, 2, 2, cout), 0.3)
    jq, js = _quantize_weight(K.lift_tconv(jnp.asarray(w), 2)[None], wbits=wbits)
    tq, ts = quant.quantize_tconv_weight(torch.from_numpy(w), wbits)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(2, 2, cout))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq)[0].reshape(c1, 2, 2, cout))
    # and a per-channel scale would not do: the taps' maxima differ
    assert not np.allclose(ts.numpy()[0, 0], ts.numpy()[1, 1])


def test_calibrate_stream_matches_jax():
    params, consts = init_popcorn(jax.random.PRNGKey(5), JModelConfig(pretrained=False))
    jp, jbn = params["unet"]["opt"], consts["unet_bn"]["opt"]
    x = _n(np.random.default_rng(4), (1, 32, 48, 4), 1.0)
    ref = K.calibrate_packed_stream(jp, jbn, K.pack(jnp.asarray(x), 4), 4)
    got = quant.calibrate_stream(to_torch(jax.tree.map(np.asarray, jp)),
                                 to_torch(jax.tree.map(np.asarray, jbn)), torch.from_numpy(x))
    assert set(got) == set(ref) == set(quant.SCALE_KEYS)
    for k in quant.SCALE_KEYS:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("float_out", [False, True], ids=["int8_out", "float_out"])
@pytest.mark.parametrize("shape,cm,cout", [((1, 24, 40, 2), 8, 8), ((2, 19, 37, 16), 16, 16)])
def test_double_conv_qs_matches_jax(shape, cm, cout, float_out):
    rng = np.random.default_rng(11 + shape[-1])
    p, bn = _dc_block(rng, shape[-1], cm, cout)
    x = _n(rng, shape, 1.0)
    s_x = np.float32(np.abs(x).max() / 127)
    xq = _codes(x, s_x)
    s_y1, s_out = np.float32(0.03), None if float_out else np.float32(0.02)
    jp, jbn = _jax(p), _jax(bn)
    ref = np.asarray(fused_double_conv_qs(
        jnp.asarray(xq), jp["conv1"]["w"], jp["conv1"]["b"], jbn["bn1"],
        jp["conv2"]["w"], jp["conv2"]["b"], jbn["bn2"],
        jnp.float32(s_x), jnp.float32(s_y1), None if s_out is None else jnp.float32(s_out),
    ))
    got = dc.double_conv_qs(to_torch(p), to_torch(bn), torch.from_numpy(xq), _t(s_x), _t(s_y1),
                            None if s_out is None else _t(s_out)).numpy()
    if float_out:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert got.dtype == np.int8
        _assert_codes(got, ref)


@pytest.mark.parametrize("float_out", [False, True], ids=["int8_out", "float_out"])
@pytest.mark.parametrize("c1,cs,hw", [(16, 16, (12, 20)), (8, 8, (10, 14))])
def test_up_block_qs_matches_jax_packed(c1, cs, hw, float_out):
    """Against fused_up_block_qs at pack factor 2, as packed_unet_stream_qs
    runs up2: the skip packed, the tconv and both conv1 parts lifted, the
    output unpacked."""
    rng = np.random.default_rng(21 + c1)
    p, bn = _up_params(rng, c1, cs, 8)
    h, w = hw
    x1 = np.abs(_n(rng, (1, h, w, c1), 1.0))
    x2 = np.abs(_n(rng, (1, 2 * h, 2 * w, cs), 1.0))
    s_x1, s_x2 = np.float32(x1.max() / 127), np.float32(x2.max() / 127)
    x1q, x2q = _codes(x1, s_x1), _codes(x2, s_x2)
    s_up, s_y1 = np.float32(0.02), np.float32(0.03)
    s_out = None if float_out else np.float32(0.025)
    f = 2
    jp, jbn = _jax(p), _jax(bn)
    w1 = jp["conv"]["conv1"]["w"]

    def lv(v):
        return K.lift_vec(v, f)

    ref = fused_up_block_qs(
        jnp.asarray(x1q), K.pack(jnp.asarray(x2q), f),
        K.lift_tconv(jp["tconv"]["w"], f), lv(jp["tconv"]["b"]),
        K.lift_conv3x3(w1[:, :, :cs], f), K.lift_conv3x3(w1[:, :, cs:], f),
        lv(jp["conv"]["conv1"]["b"]), {k: lv(v) for k, v in jbn["bn1"].items()},
        K.lift_conv3x3(jp["conv"]["conv2"]["w"], f), lv(jp["conv"]["conv2"]["b"]),
        {k: lv(v) for k, v in jbn["bn2"].items()},
        jnp.float32(s_x1), jnp.float32(s_x2), jnp.float32(s_up), jnp.float32(s_y1),
        None if s_out is None else jnp.float32(s_out),
    )
    ref = np.asarray(K.unpack(ref, f, 8))
    got = ub.up_block_qs(to_torch(p), to_torch(bn), torch.from_numpy(x1q), torch.from_numpy(x2q),
                         _t(s_x1), _t(s_x2), _t(s_up), _t(s_y1),
                         None if s_out is None else _t(s_out)).numpy()
    if float_out:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        _assert_codes(got, ref)


@pytest.mark.parametrize("shape,cm,cout", [
    ((1, 24, 40, 2), 8, 8), ((2, 37, 19, 4), 8, 8), ((1, 33, 48, 16), 16, 16)])
def test_double_conv_q_close_to_f32(shape, cm, cout):
    rng = np.random.default_rng(31 + shape[1])
    p, bn = _dc_block(rng, shape[-1], cm, cout)
    x = _n(rng, shape, 1.0)
    ref = junet.double_conv(_jax(p), _jax(bn), jnp.asarray(x))
    got = dc.double_conv_q(to_torch(p), to_torch(bn), torch.from_numpy(x))
    assert got.shape == ref.shape
    _close_to_f32(got.numpy(), ref, 0.05, 0.999)


@pytest.mark.parametrize("c1,cs,skip,coarse", [
    (16, 16, (2, 24, 40), (12, 20)), (8, 8, (1, 37, 19), (18, 9)), (8, 8, (1, 40, 22), (18, 9))])
def test_up_block_q_close_to_f32(c1, cs, skip, coarse):
    """Even shapes, and odd skips with pad_to_match rings (also with a
    top/left offset)."""
    rng = np.random.default_rng(41 + skip[1])
    p, bn = _up_params(rng, c1, cs, 8)
    x1 = _n(rng, (skip[0], *coarse, c1), 1.0)
    x2 = _n(rng, (*skip, cs), 1.0)
    ref = junet._up_block(_jax(p), _jax(bn), jnp.asarray(x1), jnp.asarray(x2))
    got = ub.up_block_q(to_torch(p), to_torch(bn), torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == ref.shape
    _close_to_f32(got.numpy(), ref, 0.05, 0.999)


def test_dynamic_plain_versions_quantize_per_tile():
    """Kernel G's plain version takes one scale a TILE x TILE tile: a tile
    of small values keeps its resolution beside a tile of large ones."""
    rng = np.random.default_rng(51)
    p, bn = _dc_block(rng, 4, 8, 8)
    t = quant.TILE
    x = _n(rng, (1, 3 * t, t, 4), 1e-3)
    x[:, 2 * t:] *= 1e4  # beyond the first tile's 2-row halo
    got = dc.double_conv_q(to_torch(p), to_torch(bn), torch.from_numpy(x)).numpy()
    ref = np.asarray(junet.double_conv(_jax(p), _jax(bn), jnp.asarray(x)))
    _close_to_f32(got[:, :t], ref[:, :t], 0.05, 0.999)
    # one scale for the whole image would leave the small tile nothing
    xq, _ = quant.quantize_tiles(torch.from_numpy(x).reshape(1, 3 * t, t, 4))
    assert int(xq[0, :t].abs().max()) == 0


def test_cpu_tensors_take_plain_versions_without_launch():
    rng = np.random.default_rng(61)
    p, bn = _dc_block(rng, 2, 8, 8)
    up, ubn = _up_params(rng, 8, 8, 8)
    before = COUNTERS.summary()
    x = torch.from_numpy(_n(rng, (1, 8, 8, 2), 1.0))
    xq = quant.quantize_static(x, _t(0.01))
    s = _t(0.02)
    assert dc.double_conv_qs(to_torch(p), to_torch(bn), xq, s, s, s).dtype == torch.int8
    assert dc.double_conv_q(to_torch(p), to_torch(bn), x).device.type == "cpu"
    x1 = torch.from_numpy(_n(rng, (1, 4, 4, 8), 1.0))
    x2 = torch.from_numpy(_n(rng, (1, 8, 8, 8), 1.0))
    x1q, x2q = quant.quantize_static(x1, s), quant.quantize_static(x2, s)
    assert ub.up_block_qs(to_torch(up), to_torch(ubn), x1q, x2q, s, s, s, s).dtype == torch.float32
    assert ub.up_block_q(to_torch(up), to_torch(ubn), x1, x2).shape == (1, 8, 8, 8)
    assert COUNTERS.since(before, "launches/") == {}


def test_static_member_maps_close():
    """The eval fold's static member maps (popcorn_forward with calibrated
    scales) against the JAX package's float32 member forward."""
    mcfg = JModelConfig(pretrained=False, occupancy_model=True)
    params, consts = init_popcorn(jax.random.PRNGKey(6), mcfg)
    rng = np.random.default_rng(71)
    x = _n(rng, (1, 64, 96, 6), 1.0)
    score = np.abs(_n(rng, (1, 64, 96), 0.5))
    dense_ref = np.asarray(j_popcorn_forward(
        params, consts, {"input": jnp.asarray(x), "building_counts": jnp.asarray(score)},
        mcfg, padding=False)["popdensemap"])
    tp, tc = to_torch(jax.tree.map(np.asarray, params)), to_torch(jax.tree.map(np.asarray, consts))
    inputs = {"input": torch.from_numpy(x), "building_counts": torch.from_numpy(score)}
    cfg = ModelConfig(pretrained=False, occupancy_model=True, quantize="int8s")
    scales = calibrate_member_scales(tp, tc, inputs["input"], cfg)
    # the port's scales are the JAX package's on the same patch
    f = 4
    x6 = reorder_to_dda(inputs["input"], s1=True, s2=True, nir=True).numpy()
    sar_p, opt_p = K.pack(jnp.asarray(x6[..., :2]), f), K.pack(jnp.asarray(x6[..., 2:]), f)
    jsc = j_calibrate_member_scales(params, consts, sar_p, opt_p, f)
    for stream in ("sar", "opt"):
        for k in quant.SCALE_KEYS:
            np.testing.assert_allclose(float(scales[stream][k]), float(jsc[stream][k]), rtol=1e-5)
    with torch.no_grad():
        got = popcorn_forward(tp, tc, inputs, cfg, padding=False, scales=scales)["popdensemap"]
        flt = popcorn_forward(tp, tc, inputs, dataclasses.replace(cfg, quantize=None),
                              padding=False)["popdensemap"]
    a, b = dense_ref.ravel(), got.numpy().ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.99
    assert float(np.abs(a - b).max()) < 0.1 * max(float(np.abs(a).max()), 1e-6)
    # without scales (popcorn_predict outside the fold) int8s runs float
    with torch.no_grad():
        unscaled = popcorn_forward(tp, tc, inputs, cfg, padding=False)["popdensemap"]
    assert torch.equal(unscaled, flt)
    assert not torch.equal(got, flt)

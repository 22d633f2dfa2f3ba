"""The port's CUDA kernels against their plain versions on the card, at
odd sizes and batch 2 that the main path's shapes do not reach: ragged
tiles, pad_to_match rings (also with a top/left offset), a pixel count no
multiple of the head's block, the head backward (kernel D) at pixel
counts of 1, one tile plus one and ragged shapes, the int8 kernels E-H at
the same odd sizes (int8 outputs bit-equal to their plain versions), and
the wrappers' refusals, including of tensors that need a gradient. The
tensor-core tilings of kernels A (TH x 30 output tiles, TH 14 in float32
at 16 intermediate channels and 30 otherwise), B (TH x 30, TH 14 at 32
conv1 channels and 28 at 16) and D (64-pixel tiles on a persistent grid
of at most 264 blocks) are held at ragged last tiles in both dimensions,
pad rings with a top/left offset, the builder's odd 519^2 (-> 1038^2), one
tile plus and minus one, more tiles than blocks, and (A) an input view
off the alignment of its vector loads.

Needs a CUDA card and skips without one. The repo's conftest imports jax,
which the GPU machine lacks, so run it there as
    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol=atol=1e-4, as chip_smoke.py: float32 on both sides with
different summation orders (TF32 off for the plain versions). The bf16
modes of kernels A, B and C are held to their plain versions, which round
in the same places, at chip_smoke.py's BF16_ULP bound: |got - ref| <=
2^-7 (|ref| + max|ref|), fewer than 1% of the values differing (float32
sums in another order can flip a bf16 rounding). Kernel C's persistent
grid of 16-pixel warp strips is held at 1, 15, 16 and 17 pixels and at
more strips than its warps."""

import pytest
import torch

from popcorn_tpu_torch.nn import double_conv as A
from popcorn_tpu_torch.nn import head as C
from popcorn_tpu_torch.nn import quant
from popcorn_tpu_torch.nn import up_block as B
from popcorn_tpu_torch.nn.ops import conv3x3, conv_transpose_2x2, frozen_bn, pad_to_match

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _n(g, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dev)


def _dc_params(g, dev, cin, cm, cout):
    p = {
        "conv1": {"w": _n(g, dev, 3, 3, cin, cm, scale=0.3), "b": _n(g, dev, cm)},
        "conv2": {"w": _n(g, dev, 3, 3, cm, cout, scale=0.3), "b": _n(g, dev, cout)},
    }
    bn = {
        "bn1": {"scale": _n(g, dev, cm), "shift": _n(g, dev, cm)},
        "bn2": {"scale": _n(g, dev, cout), "shift": _n(g, dev, cout)},
    }
    return p, bn


@pytest.mark.parametrize("cin,cm,cout", [(2, 8, 8), (4, 8, 8), (8, 16, 16), (16, 16, 16)])
def test_double_conv_kernel_odd_batch(dev, cin, cm, cout):
    g = torch.Generator().manual_seed(cin)
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, 2, 37, 19, cin)
    before = A.launches
    got = A.double_conv(p, bn, x)
    assert A.launches == before + 1
    torch.testing.assert_close(got, A.double_conv_plain(p, bn, x), **TOL)


@pytest.mark.parametrize(
    "c1,cs,skip_hw,coarse_hw",
    [(16, 16, (37, 19), (18, 9)), (8, 8, (37, 19), (18, 9)), (8, 8, (40, 22), (18, 9))],
)
def test_up_block_kernel_pad_ring(dev, c1, cs, skip_hw, coarse_hw):
    g = torch.Generator().manual_seed(c1 + skip_hw[0])
    conv, bn = _dc_params(g, dev, cs + c1, 8, 8)
    p = {"tconv": {"w": _n(g, dev, c1, 2, 2, c1, scale=0.3), "b": _n(g, dev, c1)}, "conv": conv}
    x1 = _n(g, dev, 2, *coarse_hw, c1)
    x2 = _n(g, dev, 2, *skip_hw, cs)
    before = B.launches
    got = B.up_block(p, bn, x1, x2)
    assert B.launches == before + 1
    torch.testing.assert_close(got, B.up_block_plain(p, bn, x1, x2), **TOL)


@pytest.mark.parametrize(
    "c,skip_hw,coarse_hw",
    [(16, (43, 67), (21, 33)), (8, (61, 91), (30, 45)), (16, (47, 64), (20, 29)),
     (8, (57, 33), (25, 13)), (16, (3, 5), (1, 2)), (16, (1038, 1038), (519, 519)),
     (8, (1038, 1038), (519, 519))],
    ids=["up2_ragged", "up1_ragged", "up2_offset", "up1_offset", "tiny", "builder_odd",
         "up1_odd"],
)
def test_up_block_kernel_tensor_core_tiling(dev, c, skip_hw, coarse_hw):
    """Kernel B's TH x 30 tiles in both channel instantiations: ragged last
    tiles in both dimensions, pad rings with oy/ox > 0, a single partial
    tile, and the builder's odd 519^2 -> 1038^2."""
    g = torch.Generator().manual_seed(800 + c + skip_hw[1])
    p, bn, x1, x2 = _up_case(g, dev, c, c, skip_hw, coarse_hw)
    before = B.launches
    got = B.up_block(p, bn, x1, x2)
    assert B.launches == before + 1
    torch.testing.assert_close(got, B.up_block_plain(p, bn, x1, x2), **TOL)


@pytest.mark.parametrize("n_out", [1, 2])
def test_head_kernel_ragged(dev, n_out):
    g = torch.Generator().manual_seed(n_out)
    dims = C.DIMS
    head = {
        name: {"w": _n(g, dev, ci, co, scale=ci**-0.5), "b": _n(g, dev, co, scale=0.1)}
        for name, ci, co in zip(C.HEAD_LAYERS, dims[:-1], dims[1:])
    }
    feats = _n(g, dev, 3, 11, 31, 16).relu()
    before = C.launches
    got = C.head_apply(head, feats, n_out)
    assert C.launches == before + 1
    torch.testing.assert_close(got, C.head_plain(head, feats, n_out), **TOL)


def _head(g, dev):
    dims = C.DIMS
    return {
        name: {"w": _n(g, dev, ci, co, scale=ci**-0.5), "b": _n(g, dev, co, scale=0.1)}
        for name, ci, co in zip(C.HEAD_LAYERS, dims[:-1], dims[1:])
    }


def _bf16_close(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    assert bool((err <= 2.0**-7 * (ref.abs() + ref.abs().max())).all()), float(err.max())
    assert float((got != ref).float().mean()) < 0.01


@pytest.mark.parametrize("cin,cm,cout", [(2, 8, 8), (4, 8, 8), (8, 16, 16), (16, 16, 16)])
def test_double_conv_kernel_bf16_odd_batch(dev, cin, cm, cout):
    g = torch.Generator().manual_seed(40 + cin)
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, 2, 37, 19, cin).to(torch.bfloat16)
    before = A.launches_bf16
    got = A.double_conv(p, bn, x)
    assert A.launches_bf16 == before + 1
    _bf16_close(got, A.double_conv_plain(p, bn, x))


def _dc_close(got, ref):
    if got.dtype == torch.bfloat16:
        _bf16_close(got, ref)
    else:
        torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize(
    "cin,cm,cout,shape",
    [(2, 8, 8, (2, 37, 61)), (4, 8, 8, (2, 37, 61)), (8, 16, 16, (2, 37, 61)),
     (16, 16, 16, (2, 37, 61)), (16, 16, 16, (1, 519, 519)), (8, 16, 16, (1, 15, 31)),
     (2, 8, 8, (1, 3, 5))],
    ids=["inc_sar", "inc_opt", "down1", "down2", "builder_odd", "tile_plus_1", "tiny"],
)
def test_double_conv_kernel_tensor_core_tiling(dev, dtype, cin, cm, cout, shape):
    """Kernel A's TH x 30 tiles (TH 14 in float32 at 16 intermediate
    channels, else 30) in every instantiation and both modes: ragged last
    tiles in both dimensions, the builder's odd 519^2, one tile plus one
    (15 rows and 31 columns) and a single partial tile."""
    g = torch.Generator().manual_seed(900 + cin + shape[1])
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, *shape, cin).to(dtype)
    counter = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = getattr(A, counter)
    got = A.double_conv(p, bn, x)
    assert getattr(A, counter) == before + 1
    _dc_close(got, A.double_conv_plain(p, bn, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("cin,cm,cout", [(2, 8, 8), (16, 16, 16)])
def test_double_conv_kernel_takes_a_misaligned_view(dev, dtype, cin, cm, cout):
    """An input whose view starts one element off the alignment of the
    kernel's vector loads is staged element by element: the same result
    as a copy."""
    g = torch.Generator().manual_seed(cin)
    p, bn = _dc_params(g, dev, cin, cm, cout)
    shape = (2, 21, 33, cin)
    buf = _n(g, dev, 2 * 21 * 33 * cin + 1).to(dtype)
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    got = A.double_conv_cuda(p, bn, x)
    assert torch.equal(got, A.double_conv_cuda(p, bn, x.clone()))
    _dc_close(got, A.double_conv_plain(p, bn, x))


@pytest.mark.parametrize(
    "c1,cs,skip_hw,coarse_hw",
    [(16, 16, (37, 19), (18, 9)), (8, 8, (37, 19), (18, 9)), (8, 8, (40, 22), (18, 9)),
     (16, 16, (1038, 1038), (519, 519))],
)
def test_up_block_kernel_bf16_pad_ring(dev, c1, cs, skip_hw, coarse_hw):
    g = torch.Generator().manual_seed(50 + c1 + skip_hw[0])
    conv, bn = _dc_params(g, dev, cs + c1, 8, 8)
    p = {"tconv": {"w": _n(g, dev, c1, 2, 2, c1, scale=0.3), "b": _n(g, dev, c1)}, "conv": conv}
    x1 = _n(g, dev, 2, *coarse_hw, c1).relu().to(torch.bfloat16)
    x2 = _n(g, dev, 2, *skip_hw, cs).relu().to(torch.bfloat16)
    before = B.launches_bf16
    got = B.up_block(p, bn, x1, x2)
    assert B.launches_bf16 == before + 1
    _bf16_close(got, B.up_block_plain(p, bn, x1, x2))


@pytest.mark.parametrize("lead", [(1,), (15,), (16,), (17,), (3, 11, 31), (132 * 2 * 8 * 16 * 3 + 5,)],
                         ids=["n1", "strip_minus_1", "one_strip", "strip_plus_1", "3x11x31",
                              "more_strips_than_warps"])
def test_head_kernel_strips(dev, lead):
    """Kernel C's warp strips in both modes: float32 with one and two
    channels, bf16 with one."""
    g = torch.Generator().manual_seed(60 + lead[0])
    head = _head(g, dev)
    feats = _n(g, dev, *lead, 16).relu()
    for n_out in (1, 2):
        torch.testing.assert_close(C.head_cuda(head, feats, n_out), C.head_plain(head, feats, n_out),
                                   **TOL)
    fb = feats.to(torch.bfloat16)
    before = C.launches_bf16
    got = C.head_apply(head, fb, 1)
    assert C.launches_bf16 == before + 1
    _bf16_close(got, C.head_plain(head, fb, 1))


def test_head_kernel_takes_a_misaligned_view(dev):
    """Features whose view starts 8 bytes off the 16-byte alignment of the
    kernel's loads give the same result as a copy."""
    g = torch.Generator().manual_seed(8)
    head = _head(g, dev)
    buf = _n(g, dev, 333 * 16 + 2)
    feats = buf[2:].view(333, 16)
    assert feats.data_ptr() % 16 == 8
    assert torch.equal(C.head_cuda(head, feats, 2), C.head_cuda(head, feats.clone(), 2))


@pytest.mark.parametrize("lead", [(1,), (1023,), (1, 7, 13), (65,), (2, 64, 97)],
                         ids=["n1", "n1023", "1x7x13", "tile_plus_1", "2x64x97"])
def test_head_bwd_kernel_odd_sizes(dev, lead):
    """Kernel D against autograd through head_plain: dx elementwise, the
    weight gradients (sums over all pixels) norm-relative 1e-5."""
    g = torch.Generator().manual_seed(sum(lead))
    head = _head(g, dev)
    feats = _n(g, dev, *lead, 16)
    cot = _n(g, dev, *lead, 2)
    before = C.bwd_launches
    dx, grads = C.head_bwd_cuda(head, feats, cot)
    assert C.bwd_launches == before + 1
    dx_ref, grads_ref = C.head_bwd_plain(head, feats, cot)
    torch.testing.assert_close(dx, dx_ref, **TOL)
    for got, ref in zip(grads, grads_ref):
        assert got.shape == ref.shape
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-5
    # without dx the weight gradients are the same bits
    none, grads2 = C.head_bwd_cuda(head, feats, cot, need_dx=False)
    assert none is None
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


BOUNDARY = 1e-4


def _relu_boundary(head, feats):
    """Pixels with a hidden pre-activation within BOUNDARY of 0."""
    h = feats.reshape(-1, 16)
    near = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    for k in C.HEAD_LAYERS[:-1]:
        z = torch.addmm(head[k]["b"], h, head[k]["w"])
        near |= (z.abs() < BOUNDARY).any(1)
        h = torch.relu(z)
    return near.reshape(feats.shape[:-1])


@pytest.mark.parametrize("lead", [(2,), (63,), (64,), (264 * 64 * 3 + 5,)],
                         ids=["n2", "tile_minus_1", "one_tile", "more_tiles_than_blocks"])
def test_head_bwd_kernel_persistent_tiling(dev, lead):
    """Kernel D's 64-pixel tiles and persistent grid: ragged last tiles
    (zero-filled by cp.async), exactly one tile, and blocks that walk
    several tiles each; the weight gradients are the same bits on a rerun
    (per-block partials, ordered reduction, no atomics). As in
    chip_smoke.py, the cotangent is zeroed on the pixels whose hidden
    pre-activations come within BOUNDARY of 0: among 50k pixels some lie
    within float32 rounding of it, and there two float32 forwards may take
    different ReLU masks."""
    g = torch.Generator().manual_seed(700 + lead[0])
    head = _head(g, dev)
    feats = _n(g, dev, *lead, 16)
    cot = _n(g, dev, *lead, 2) * (~_relu_boundary(head, feats))[..., None]
    dx, grads = C.head_bwd_cuda(head, feats, cot)
    dx_ref, grads_ref = C.head_bwd_plain(head, feats, cot)
    torch.testing.assert_close(dx, dx_ref, **TOL)
    for got, ref in zip(grads, grads_ref):
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-5
    _, again = C.head_bwd_cuda(head, feats, cot)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


def test_head_bwd_kernel_takes_a_misaligned_cotangent_view(dev):
    """A contiguous view that starts one pixel into its storage (8 bytes
    off the 16-byte cp.async alignment) gives the same result as a copy."""
    g = torch.Generator().manual_seed(9)
    head = _head(g, dev)
    feats = _n(g, dev, 333, 16)
    cot = _n(g, dev, 334, 2)[1:]
    assert cot.is_contiguous() and cot.data_ptr() % 16 == 8
    dx, grads = C.head_bwd_cuda(head, feats, cot)
    dx2, grads2 = C.head_bwd_cuda(head, feats, cot.clone())
    assert torch.equal(dx, dx2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


def test_head_train_backward_launches_kernel_d(dev):
    g = torch.Generator().manual_seed(3)
    head = {k: {n: v.requires_grad_(True) for n, v in d.items()} for k, d in _head(g, dev).items()}
    feats = _n(g, dev, 2, 9, 11, 16).requires_grad_(True)
    fwd, bwd = C.launches, C.bwd_launches
    torch.tanh(C.head_train(head, feats)).sum().backward()
    assert (C.launches, C.bwd_launches) == (fwd + 1, bwd + 1)
    assert feats.grad is not None and head["l1"]["w"].grad is not None


def test_kernel_wrappers_refuse_tensors_that_need_a_gradient(dev):
    """A kernel launched through ctypes has no backward here: with grad
    mode on, A, B and C raise rather than cut the gradient."""
    g = torch.Generator().manual_seed(1)
    p, bn = _dc_params(g, dev, 2, 8, 8)
    x = _n(g, dev, 1, 8, 8, 2).requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        A.double_conv(p, bn, x)
    conv, bn2 = _dc_params(g, dev, 16, 8, 8)
    up = {"tconv": {"w": _n(g, dev, 8, 2, 2, 8).requires_grad_(True), "b": _n(g, dev, 8)},
          "conv": conv}
    with pytest.raises(RuntimeError, match="requires a gradient"):
        B.up_block(up, bn2, _n(g, dev, 1, 4, 4, 8), _n(g, dev, 1, 8, 8, 8))
    head = _head(g, dev)
    head["l2"]["w"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        C.head_apply(head, _n(g, dev, 1, 4, 4, 16))
    with torch.no_grad():
        A.double_conv(p, bn, x)
        C.head_apply(head, _n(g, dev, 1, 4, 4, 16))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(0)
    p, bn = _dc_params(g, dev, 2, 8, 8)
    x = _n(g, dev, 1, 8, 8, 2)
    with pytest.raises(TypeError):
        A.double_conv(p, bn, x.double())
    with pytest.raises(ValueError):
        A.double_conv(p, bn, x.transpose(1, 2))
    p3, bn3 = _dc_params(g, dev, 3, 8, 8)
    with pytest.raises(ValueError):
        A.double_conv(p3, bn3, _n(g, dev, 1, 8, 8, 3))


# ----------------------------------------------------------- int8 kernels E-H


def _amax_scale(t):
    return t.abs().amax().clamp_min(1e-6) / quant.const(t, 127.0)


def _dc_scales(p, bn, x):
    """Static scales of one DoubleConv from its float run: input, y1, out."""
    y1 = torch.relu(frozen_bn(conv3x3(x, p["conv1"]), bn["bn1"]))
    return _amax_scale(x), _amax_scale(y1), _amax_scale(A.double_conv_plain(p, bn, x))


def _up_case(g, dev, c1, cs, skip_hw, coarse_hw):
    conv, bn = _dc_params(g, dev, cs + c1, 8, 8)
    p = {"tconv": {"w": _n(g, dev, c1, 2, 2, c1, scale=0.3), "b": _n(g, dev, c1)}, "conv": conv}
    x1 = _n(g, dev, 2, *coarse_hw, c1).relu()
    x2 = _n(g, dev, 2, *skip_hw, cs).relu()
    return p, bn, x1, x2


UP_SHAPES = [(16, 16, (37, 19), (18, 9)), (8, 8, (37, 19), (18, 9)), (8, 8, (40, 22), (18, 9))]


@pytest.mark.parametrize("float_out", [False, True], ids=["int8_out", "float_out"])
@pytest.mark.parametrize("cin,cm,cout", [(2, 8, 8), (4, 8, 8), (8, 16, 16), (16, 16, 16)])
def test_double_conv_qs_kernel_odd_batch(dev, cin, cm, cout, float_out):
    g = torch.Generator().manual_seed(100 + cin)
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, 2, 37, 19, cin)
    s_x, s_y1, s_out = _dc_scales(p, bn, x)
    args = A.qs_args(p, bn, s_x, s_y1, None if float_out else s_out)
    xq = quant.quantize_static(x, s_x)
    before = A.launches_qs
    got = A.double_conv_qs_cuda(*args, xq, float_out)
    assert A.launches_qs == before + 1
    ref = A.double_conv_qs_plain(*args, xq, float_out)
    if float_out:
        torch.testing.assert_close(got, ref, **TOL)
    else:
        assert got.dtype == torch.int8 and torch.equal(got, ref) and bool(ref.any())


@pytest.mark.parametrize("float_out", [False, True], ids=["int8_out", "float_out"])
@pytest.mark.parametrize("c1,cs,skip_hw,coarse_hw", UP_SHAPES)
def test_up_block_qs_kernel_pad_ring(dev, c1, cs, skip_hw, coarse_hw, float_out):
    g = torch.Generator().manual_seed(200 + c1 + skip_hw[0])
    p, bn, x1, x2 = _up_case(g, dev, c1, cs, skip_hw, coarse_hw)
    s_x1, s_x2 = _amax_scale(x1), _amax_scale(x2)
    up = pad_to_match(conv_transpose_2x2(x1, p["tconv"]), x2)
    y1 = torch.relu(frozen_bn(conv3x3(torch.cat([x2, up], -1), p["conv"]["conv1"]), bn["bn1"]))
    s_out = None if float_out else _amax_scale(B.up_block_plain(p, bn, x1, x2))
    args = B.qs_args(p, bn, s_x1, s_x2, _amax_scale(up), _amax_scale(y1), s_out)
    x1q, x2q = quant.quantize_static(x1, s_x1), quant.quantize_static(x2, s_x2)
    before = B.launches_qs
    got = B.up_block_qs_cuda(*args, x1q, x2q, float_out)
    assert B.launches_qs == before + 1
    ref = B.up_block_qs_plain(*args, x1q, x2q, float_out)
    if float_out:
        torch.testing.assert_close(got, ref, **TOL)
    else:
        assert got.dtype == torch.int8 and torch.equal(got, ref) and bool(ref.any())


@pytest.mark.parametrize("cin,cm,cout", [(2, 8, 8), (4, 8, 8), (8, 16, 16), (16, 16, 16)])
def test_double_conv_q_kernel_odd_batch(dev, cin, cm, cout):
    g = torch.Generator().manual_seed(300 + cin)
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, 2, 37, 19, cin)
    args = A.q_args(p, bn)
    before = A.launches_q
    got = A.double_conv_q_cuda(*args, x)
    assert A.launches_q == before + 1
    torch.testing.assert_close(got, A.double_conv_q_plain(*args, x), **TOL)


@pytest.mark.parametrize("c1,cs,skip_hw,coarse_hw", UP_SHAPES)
def test_up_block_q_kernel_pad_ring(dev, c1, cs, skip_hw, coarse_hw):
    g = torch.Generator().manual_seed(400 + c1 + skip_hw[0])
    p, bn, x1, x2 = _up_case(g, dev, c1, cs, skip_hw, coarse_hw)
    args = B.q_args(p, bn)
    before = B.launches_q
    got = B.up_block_q_cuda(*args, x1, x2)
    assert B.launches_q == before + 1
    torch.testing.assert_close(got, B.up_block_q_plain(*args, x1, x2), **TOL)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(5)
    p, bn = _dc_params(g, dev, 2, 8, 8)
    x = _n(g, dev, 1, 8, 8, 2)
    s = quant.const(x, 0.05)
    with pytest.raises(TypeError):  # kernel E takes int8 codes
        A.double_conv_qs_cuda(*A.qs_args(p, bn, s, s, s), x, False)
    with pytest.raises(ValueError):
        A.double_conv_q_cuda(*A.q_args(p, bn), x.transpose(1, 2))
    with pytest.raises(RuntimeError, match="requires a gradient"):
        A.double_conv_q_cuda(*A.q_args(p, bn), x.clone().requires_grad_(True))
    p3, bn3 = _dc_params(g, dev, 3, 8, 8)
    with pytest.raises(ValueError):
        A.double_conv_q(p3, bn3, _n(g, dev, 1, 8, 8, 3))

"""The port's CUDA kernels against their plain versions on the card, at
odd sizes and batch 2 that the main path's shapes do not reach: ragged
tiles, pad_to_match rings (also with a top/left offset), a pixel count no
multiple of the head's block, the head backward (kernel D) at pixel
counts of 1, one tile plus one and ragged shapes, the int8 kernels E-H at
the same odd sizes (int8 outputs bit-equal to their plain versions), and
the wrappers' refusals, including of tensors that need a gradient. Kernels
E-H run on the int8 tensor cores, E and F in 32x32 regions, G and H in
16x32 (two 16x16 scale tiles): they are held at ragged regions and tiles,
offset pad rings, the builder's odd 519^2 (-> 1038^2), batch 2 and views
off the alignment of their loads, in every channel combination and output
mode (E: int8, float32; F: int8, float32, bf16; G and H: float32 and bf16
I/O). The
tensor-core tilings of kernels A (TH x 30 output tiles, TH 14 in float32
at 16 intermediate channels and 30 otherwise), B (TH x 30, TH 14 at 32
conv1 channels and 28 at 16) and D (64-pixel tiles on a persistent grid
of at most 264 blocks) are held at ragged last tiles in both dimensions,
pad rings with a top/left offset, the builder's odd 519^2 (-> 1038^2), one
tile plus and minus one, more tiles than blocks, and (A) an input view
off the alignment of its vector loads. The optimizer update (csrc/adam.cu)
is held to Optimizer.update_plain on the same card tensors at rtol 1e-5
(only its norm sums in another order), over the member's 62 leaves and
odd ones.

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
    # int8 codes and float32 outputs bit for bit
    assert got.dtype == ref.dtype and torch.equal(got, ref) and bool(ref.any())


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


# Kernels F (32x32 output regions) and H (16x32: two 16x16 scale tiles)
# on the int8 tensor cores, in both instantiations: one region exactly,
# one region plus one pixel both ways (ragged last regions), a region
# whose second scale tile is ragged (H) or lies past the image, pad rings
# with oy/ox > 0 (even and odd), the builder's odd 519^2 -> 1038^2 and a
# single partial region.
INT8_TC_SHAPES = [((32, 32), (16, 16)), ((33, 33), (16, 16)), ((16, 40), (8, 20)),
                  ((40, 22), (18, 9)), ((103, 69), (50, 33)), ((1038, 1038), (519, 519)),
                  ((3, 5), (1, 2))]
INT8_TC_IDS = ["region", "region_plus_1", "ragged_tile", "offset", "odd_offset", "builder_odd",
               "tiny"]


def _f_case(g, dev, c, skip_hw, coarse_hw, int8_out):
    p, bn, x1, x2 = _up_case(g, dev, c, c, skip_hw, coarse_hw)
    s_x1, s_x2 = _amax_scale(x1), _amax_scale(x2)
    up = pad_to_match(conv_transpose_2x2(x1, p["tconv"]), x2)
    y1 = torch.relu(frozen_bn(conv3x3(torch.cat([x2, up], -1), p["conv"]["conv1"]), bn["bn1"]))
    s_out = _amax_scale(B.up_block_plain(p, bn, x1, x2)) if int8_out else None
    args = B.qs_args(p, bn, s_x1, s_x2, _amax_scale(up), _amax_scale(y1), s_out)
    return args, quant.quantize_static(x1, s_x1), quant.quantize_static(x2, s_x2)


def _off_alignment(t):
    """A contiguous copy of t whose data starts 8 bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8, device=t.device)
    v = buf[8:8 + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == 8 and v.is_contiguous()
    return v


@pytest.mark.parametrize("out", ["int8", "float32", "bf16"])
@pytest.mark.parametrize("c", [16, 8], ids=["up2", "up1"])
@pytest.mark.parametrize("skip_hw,coarse_hw", INT8_TC_SHAPES, ids=INT8_TC_IDS)
def test_up_block_qs_kernel_tensor_core_tiling(dev, skip_hw, coarse_hw, c, out):
    """Kernel F: int8 codes and float32 features bit-equal to the plain
    version's; bf16 features equal to its float32 features rounded to
    bf16 (the integer sums are exact and the epilogue rounds as the plain
    version does, so the float32 value before the rounding is equal too)."""
    g = torch.Generator().manual_seed(900 + c + skip_hw[0])
    args, x1q, x2q = _f_case(g, dev, c, skip_hw, coarse_hw, out == "int8")
    fo = out != "int8"
    odt = torch.bfloat16 if out == "bf16" else None
    counter = "launches_qs_bf16" if out == "bf16" else "launches_qs"
    before = getattr(B, counter)
    got = B.up_block_qs_cuda(*args, x1q, x2q, fo, odt)
    assert getattr(B, counter) == before + 1
    ref = B.up_block_qs_plain(*args, x1q, x2q, fo)
    if odt is not None:
        ref = ref.to(odt)
    assert got.dtype == ref.dtype and torch.equal(got, ref) and bool(ref.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("c", [16, 8], ids=["up2", "up1"])
@pytest.mark.parametrize("skip_hw,coarse_hw", INT8_TC_SHAPES, ids=INT8_TC_IDS)
def test_up_block_q_kernel_tensor_core_tiling(dev, skip_hw, coarse_hw, c, dtype):
    """Kernel H in both I/O modes against the plain version on the inputs
    widened to float32, its output rounded to the mode's dtype: float32 at
    TOL (as the first design was), bf16 at chip_smoke.py's BF16_ULP bound (a
    float32 difference within TOL can flip a bf16 rounding)."""
    g = torch.Generator().manual_seed(1000 + c + skip_hw[0])
    p, bn, x1, x2 = _up_case(g, dev, c, c, skip_hw, coarse_hw)
    x1, x2 = x1.to(dtype), x2.to(dtype)
    args = B.q_args(p, bn)
    counter = "launches_q_bf16" if dtype == torch.bfloat16 else "launches_q"
    before = getattr(B, counter)
    got = B.up_block_q_cuda(*args, x1, x2)
    assert getattr(B, counter) == before + 1
    ref = B.up_block_q_plain(*args, x1.float(), x2.float()).to(dtype)
    if dtype == torch.bfloat16:
        _bf16_close(got, ref)
    else:
        torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("c", [16, 8], ids=["up2", "up1"])
def test_int8_up_kernels_take_misaligned_views(dev, c):
    """F and H on inputs 8 bytes off 16-byte alignment: F stages them
    word by word (at 16 bytes a pixel) or by 8-byte pieces, H element by
    element; the results are those of aligned inputs."""
    g = torch.Generator().manual_seed(1100 + c)
    args, x1q, x2q = _f_case(g, dev, c, (37, 19), (18, 9), True)
    want = B.up_block_qs_cuda(*args, x1q, x2q, False)
    got = B.up_block_qs_cuda(*args, _off_alignment(x1q), _off_alignment(x2q), False)
    assert torch.equal(got, want) and torch.equal(got, B.up_block_qs_plain(*args, x1q, x2q, False))
    p, bn, x1, x2 = _up_case(g, dev, c, c, (37, 19), (18, 9))
    qa = B.q_args(p, bn)
    for dt in (torch.float32, torch.bfloat16):
        a1, a2 = x1.to(dt), x2.to(dt)
        want = B.up_block_q_cuda(*qa, a1, a2)
        assert torch.equal(B.up_block_q_cuda(*qa, _off_alignment(a1), _off_alignment(a2)), want)


def test_int8_up_wrappers_route_bf16_without_conversion(dev):
    """The eval's bf16 route: up_block_q passes two bf16 tensors to H's
    bf16 mode (no float32 mode launch), mixed dtypes to its float32 mode;
    up_block_qs writes bf16 features from kernel F's bf16 mode."""
    g = torch.Generator().manual_seed(1200)
    p, bn, x1, x2 = _up_case(g, dev, 8, 8, (32, 32), (16, 16))
    n16, n32 = B.launches_q_bf16, B.launches_q
    out = B.up_block_q(p, bn, x1.to(torch.bfloat16), x2.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and (B.launches_q_bf16, B.launches_q) == (n16 + 1, n32)
    out = B.up_block_q(p, bn, x1.to(torch.bfloat16), x2)
    assert out.dtype == torch.float32 and (B.launches_q_bf16, B.launches_q) == (n16 + 1, n32 + 1)
    s = _amax_scale(x2)
    x1q, x2q = quant.quantize_static(x1, s), quant.quantize_static(x2, s)
    n16 = B.launches_qs_bf16
    feats = B.up_block_qs(p, bn, x1q, x2q, s, s, s, s, None, dtype=torch.bfloat16)
    assert feats.dtype == torch.bfloat16 and B.launches_qs_bf16 == n16 + 1


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


# Kernels E (32x32 output regions) and G (16x32: two 16x16 scale tiles) on
# the int8 tensor cores, in every channel combination (the inc's one-word
# pixels on a k32 and a k16 step, 8 and 16 channels): one region exactly,
# one region plus one pixel both ways (ragged last regions and tiles), a
# block whose second scale tile is ragged or lies past the image, batch 2
# at ragged sizes, a single partial region, and the builder's odd 519^2.
DC_TC_SHAPES = [(1, 32, 32), (1, 33, 33), (1, 16, 40), (1, 16, 16), (2, 37, 61), (1, 3, 5),
                (1, 519, 519)]
DC_TC_IDS = ["region", "region_plus_1", "ragged_tile", "tile_past_image", "batch2_ragged",
             "tiny", "builder_odd"]
DC_CHANNELS = [(2, 8, 8), (4, 8, 8), (8, 16, 16), (16, 16, 16)]
DC_CHANNEL_IDS = ["inc_sar", "inc_opt", "down1", "down2"]


def _e_case(g, dev, shape, cin, cm, cout, int8_out):
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, *shape, cin)
    s_x, s_y1, s_out = _dc_scales(p, bn, x)
    return A.qs_args(p, bn, s_x, s_y1, s_out if int8_out else None), quant.quantize_static(x, s_x)


@pytest.mark.parametrize("out", ["int8", "float32"])
@pytest.mark.parametrize("cin,cm,cout", DC_CHANNELS, ids=DC_CHANNEL_IDS)
@pytest.mark.parametrize("shape", DC_TC_SHAPES, ids=DC_TC_IDS)
def test_double_conv_qs_kernel_tensor_core_tiling(dev, shape, cin, cm, cout, out):
    """Kernel E: int8 codes and float32 outputs bit-equal to the plain
    version's (the integer sums are exact and the epilogue rounds as the
    plain version does)."""
    g = torch.Generator().manual_seed(1300 + cin + shape[1])
    fo = out == "float32"
    args, xq = _e_case(g, dev, shape, cin, cm, cout, not fo)
    before = A.launches_qs
    got = A.double_conv_qs_cuda(*args, xq, fo)
    assert A.launches_qs == before + 1
    ref = A.double_conv_qs_plain(*args, xq, fo)
    assert got.dtype == ref.dtype and torch.equal(got, ref) and bool(ref.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("cin,cm,cout", DC_CHANNELS, ids=DC_CHANNEL_IDS)
@pytest.mark.parametrize("shape", DC_TC_SHAPES, ids=DC_TC_IDS)
def test_double_conv_q_kernel_tensor_core_tiling(dev, shape, cin, cm, cout, dtype):
    """Kernel G in both I/O modes against the plain version on the input
    widened to float32, its output rounded to the mode's dtype: float32 at
    TOL, bf16 at chip_smoke.py's BF16_ULP bound (a float32 difference
    within TOL can flip a bf16 rounding)."""
    g = torch.Generator().manual_seed(1400 + cin + shape[1])
    p, bn = _dc_params(g, dev, cin, cm, cout)
    x = _n(g, dev, *shape, cin).to(dtype)
    args = A.q_args(p, bn)
    counter = "launches_q_bf16" if dtype == torch.bfloat16 else "launches_q"
    before = getattr(A, counter)
    got = A.double_conv_q_cuda(*args, x)
    assert getattr(A, counter) == before + 1
    ref = A.double_conv_q_plain(*args, x.float()).to(dtype)
    _dc_close(got, ref)


def _shifted(t, nbytes):
    """A contiguous copy of t whose data starts nbytes past a 16-byte
    boundary (a view into a larger buffer)."""
    size = t.numel() * t.element_size()
    buf = torch.empty(size + 16, dtype=torch.uint8, device=t.device)
    v = buf[nbytes:nbytes + size].view(t.dtype).view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == nbytes and v.is_contiguous()
    return v


@pytest.mark.parametrize("cin,cm,cout", DC_CHANNELS, ids=DC_CHANNEL_IDS)
def test_int8_double_conv_kernels_take_misaligned_views(dev, cin, cm, cout):
    """E and G on inputs off the alignment of their pieces: E one byte off
    (byte loads) and 8 bytes off (word loads at 16 channels, cp.async of
    smaller pixels), G one element and 8 bytes off in both modes; the
    results are those of aligned inputs."""
    g = torch.Generator().manual_seed(1500 + cin)
    args, xq = _e_case(g, dev, (2, 37, 19), cin, cm, cout, True)
    want = A.double_conv_qs_cuda(*args, xq, False)
    assert torch.equal(want, A.double_conv_qs_plain(*args, xq, False))
    for off in (1, 8):
        assert torch.equal(A.double_conv_qs_cuda(*args, _shifted(xq, off), False), want)
    p, bn = _dc_params(g, dev, cin, cm, cout)
    qa = A.q_args(p, bn)
    x = _n(g, dev, 2, 37, 19, cin)
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        want = A.double_conv_q_cuda(*qa, xd)
        for off in (xd.element_size(), 8):
            assert torch.equal(A.double_conv_q_cuda(*qa, _shifted(xd, off)), want)


def test_double_conv_q_wrapper_routes_bf16_without_conversion(dev):
    """The eval's bf16 route: double_conv_q passes a bf16 tensor to G's
    bf16 mode (no float32 mode launch, no float32 tensor made), a float32
    one to its float32 mode."""
    g = torch.Generator().manual_seed(1600)
    p, bn = _dc_params(g, dev, 4, 8, 8)
    x = _n(g, dev, 1, 64, 96, 4)
    xb = x.to(torch.bfloat16)
    n16, n32 = A.launches_q_bf16, A.launches_q
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = A.double_conv_q(p, bn, xb)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and (A.launches_q_bf16, A.launches_q) == (n16 + 1, n32)
    # no float32 copy of the input or the output: above what was allocated
    # before, the call's peak (the bf16 output, the weights' codes and
    # vectors) stays below the size of a float32 output
    assert torch.cuda.max_memory_allocated(dev) - base < out.numel() * 4
    _dc_close(out, A.double_conv_q_plain(*A.q_args(p, bn), x.to(torch.bfloat16).float())
              .to(torch.bfloat16))
    out = A.double_conv_q(p, bn, x)
    assert out.dtype == torch.float32 and (A.launches_q_bf16, A.launches_q) == (n16 + 1, n32 + 1)


# ------------------------------------------------- the optimizer update (adam.cu)


def _member(dev):
    """The member's 62 trainable leaves (39,333 parameters) on the card."""
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda, to_torch
    from popcorn_tpu_torch.config import ModelConfig

    params, _ = load_popcorn_from_dda(ModelConfig(biasinit=0.9407), head_seed=1)
    return to_torch(params, dev)


def _grads(params, g, scale, frozen=()):
    """Seeded gradients shaped as the train step's: a conv weight's as the
    permuted OIHW tensor autograd returns, and zeros on the leaves whose
    path holds a ``frozen`` key (a memory tier's frozen blocks)."""
    from popcorn_tpu_torch.train.state import tree_flatten, tree_unflatten

    out = []
    for path, v in tree_flatten(params):
        if any(k in path for k in frozen):
            d = torch.zeros_like(v)
        elif v.dim() == 4:
            s = v.shape
            d = (torch.randn(s[3], s[2], s[0], s[1], generator=g) * scale).to(v.device)
            d = d.permute(2, 3, 1, 0)
        else:
            d = (torch.randn(v.shape, generator=g) * scale).to(v.device)
        out.append((path, d))
    return tree_unflatten(out)


def _adam_close(got, ref, lr):
    """Every leaf of the kernel's params, mu and nu against the plain
    chain's: rtol 1e-5 (only the norm's sum runs in another order); the
    params absolute to 1e-5 of a step's size, mu and nu to 1e-6 of the
    leaf's largest value (moments summed over steps may cancel to 0)."""
    from popcorn_tpu_torch.train.state import tree_flatten

    (gp, gs), (rp, rs) = got, ref
    for tree, want, atol in ((gp, rp, lambda r: 1e-5 * lr), (gs["mu"], rs["mu"], None),
                             (gs["nu"], rs["nu"], None)):
        for (path, a), (_, b) in zip(tree_flatten(tree), tree_flatten(want)):
            tol = atol(b) if atol else 1e-6 * float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=1e-5, atol=tol, msg=str(path))


def _storages(tree):
    from popcorn_tpu_torch.train.state import tree_flatten

    return {v.untyped_storage().data_ptr() for _, v in tree_flatten(tree)}


@pytest.mark.parametrize("clip,wd,scale,frozen", [
    (0.01, 0.0, 1.0, ()),                 # the member's defaults: the clip engaged
    (0.01, 0.0, 1e-5, ()),                # a norm under the clip
    (0.01, 0.05, 1.0, ("sar", "opt")),    # decay (head.l4 undecayed), the UNet frozen
    (0.0, 0.05, 1e-3, ("fusion_out",)),   # no clip
], ids=["clipped", "under_clip", "decay_frozen", "no_clip"])
def test_adam_kernel_matches_plain_chain_over_the_member(dev, clip, wd, scale, frozen):
    """Three updates of the member's 62 leaves, the learning rate changed
    between them as StepLR does: each is one launch, leaves its inputs
    as they were, returns leaves that share no storage with them or with
    each other's buffers, at offsets of ALIGN elements, and agrees with the plain
    chain on the same card tensors."""
    from popcorn_tpu_torch.config import TrainConfig
    from popcorn_tpu_torch.train import adam
    from popcorn_tpu_torch.train.state import (make_optimizer, set_learning_rate, tree_flatten)

    g = torch.Generator().manual_seed(1700)
    params = _member(dev)
    assert len(tree_flatten(params)) == 62
    assert sum(v.numel() for _, v in tree_flatten(params)) == 39333
    opt = make_optimizer(TrainConfig(gradient_clip=clip, weight_decay=wd, learning_rate=1e-2))
    state = opt.init(params)
    for it, lr in enumerate((1e-2, 5e-3, 5e-3)):
        state = set_learning_rate(state, lr)
        grads = _grads(params, g, scale, frozen)
        inputs = (params, grads, state["mu"], state["nu"])
        kept = [[v.clone() for _, v in tree_flatten(t)] for t in inputs]
        launches = adam.launches
        got = opt.update(grads, state, params)
        torch.cuda.synchronize()
        assert adam.launches == launches + 1
        ref = opt.update_plain(grads, state, params)
        assert adam.launches == launches + 1
        _adam_close(got, ref, lr)
        for t, k in zip(inputs, kept):
            assert all(torch.equal(v, c) for (_, v), c in zip(tree_flatten(t), k))
        outs = [_storages(got[0]), _storages(got[1]["mu"]), _storages(got[1]["nu"])]
        assert all(len(s) == 1 for s in outs) and len(set.union(*outs)) == 3
        assert not set.union(*outs) & set.union(*(_storages(t) for t in inputs))
        for tree in (got[0], got[1]["mu"], got[1]["nu"]):
            assert all(v.storage_offset() % adam.ALIGN == 0 for _, v in tree_flatten(tree))
        assert got[1]["count"] == it + 1 and got[1]["lr"] == lr
        params, state = got


def test_adam_kernel_odd_leaves_and_determinism(dev):
    """Leaves of 1 element and odd sizes, 0 to 4 dimensions, strided and
    contiguous gradients, more elements than one pass of the block
    (1024 threads x 4), a zero leaf: against the plain chain, and the same
    bits on a repeat."""
    from popcorn_tpu_torch.config import TrainConfig
    from popcorn_tpu_torch.train import adam
    from popcorn_tpu_torch.train.state import make_optimizer, tree_flatten, tree_unflatten

    g = torch.Generator().manual_seed(1701)
    shapes = [(), (1,), (3,), (1023,), (1025,), (5, 7, 3), (3, 3, 5, 7), (4097,), (9001,),
              (1, 1), (3, 3, 1, 1), (2, 2, 13, 3)]
    def rand(shape):
        return torch.randn(shape, generator=g).to(dev)

    params = tree_unflatten(((f"l{i:02d}", "w"), rand(s)) for i, s in enumerate(shapes))
    params = {**params, "head": {"l4": {"w": rand((5, 2))}}}
    flat = tree_flatten(params)
    grads = tree_unflatten(
        (p, (rand(v.shape[::-1]).permute(*range(v.dim() - 1, -1, -1)) if v.dim() > 1
             else torch.zeros_like(v) if v.numel() == 1023 else rand(v.shape)))
        for p, v in flat)
    assert sum(not d.is_contiguous() for _, d in tree_flatten(grads)) == 5
    opt = make_optimizer(TrainConfig(gradient_clip=0.01, weight_decay=0.05, learning_rate=1e-2))
    state = opt.init(params)
    got = opt.update(grads, state, params)
    _adam_close(got, opt.update_plain(grads, state, params), 1e-2)
    launches = adam.launches
    again = opt.update(grads, state, params)
    assert adam.launches == launches + 1
    for a, b in ((got[0], again[0]), (got[1]["mu"], again[1]["mu"]),
                 (got[1]["nu"], again[1]["nu"])):
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)))
    # an update on the last update's outputs (the table takes their
    # pointers from its buffers), then on an earlier update's (views of
    # other buffers, checked and read leaf by leaf)
    for state_, params_ in ((again[1], again[0]), (got[1], got[0])):
        _adam_close(opt.update(grads, state_, params_), opt.update_plain(grads, state_, params_),
                    1e-2)


def test_adam_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from popcorn_tpu_torch.config import TrainConfig
    from popcorn_tpu_torch.train import adam
    from popcorn_tpu_torch.train.state import make_optimizer

    g = torch.Generator().manual_seed(1702)
    opt = make_optimizer(TrainConfig())
    params = {"a": {"w": _n(g, dev, 4, 3)}, "b": {"w": _n(g, dev, 5)}}
    state = opt.init(params)
    grads = {"a": {"w": _n(g, dev, 4, 3)}, "b": {"w": _n(g, dev, 5)}}
    launches = adam.launches
    with pytest.raises(TypeError):
        opt.update({**grads, "b": {"w": grads["b"]["w"].double()}}, state, params)
    with pytest.raises(ValueError, match="not contiguous"):
        opt.update(grads, state, {**params, "a": {"w": _n(g, dev, 3, 4).t()}})
    with pytest.raises(ValueError, match="not contiguous"):
        opt.update(grads, {**state, "mu": {**state["mu"], "a": {"w": _n(g, dev, 3, 4).t()}}},
                   params)
    with pytest.raises(ValueError, match="expected"):
        opt.update({**grads, "b": {"w": grads["b"]["w"].cpu()}}, state, params)
    with pytest.raises(ValueError, match="gradient"):
        opt.update({**grads, "b": {"w": _n(g, dev, 6)}}, state, params)
    assert adam.launches == launches


def test_adam_outputs_checkpoint_as_separate_tensors(dev, tmp_path):
    """Leaves that are views of the update's flat buffers go into a .pth
    as tensors of their own (no storage shared between leaves in the
    file) and come back equal."""
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda, to_torch
    from popcorn_tpu_torch.config import ModelConfig, TrainConfig
    from popcorn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from popcorn_tpu_torch.train.state import make_optimizer, tree_flatten

    params, consts = (to_torch(t, dev) for t in
                      load_popcorn_from_dda(ModelConfig(biasinit=0.9407), head_seed=1))
    opt = make_optimizer(TrainConfig())
    params, state = opt.update(_grads(params, torch.Generator().manual_seed(1703), 1.0),
                               opt.init(params), params)
    path = str(tmp_path / "member.pth")
    save_checkpoint(path, params, consts, state, epoch=1, iteration=1)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    saved = [*ck["model"].values(), *ck["optimizer"]["mu"].values(),
             *ck["optimizer"]["nu"].values()]
    assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size() for t in saved)
    back = restore_checkpoint(path, dev)
    for tree, ref in ((back["params"], params), (back["opt_state"]["mu"], state["mu"]),
                      (back["opt_state"]["nu"], state["nu"])):
        got = dict(tree_flatten(tree))
        assert all(torch.equal(got[p], v) for p, v in tree_flatten(ref))

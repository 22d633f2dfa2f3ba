"""The port's CUDA kernels against their plain versions on the card, at
odd sizes and batch 2 that the main path's shapes do not reach: ragged
tiles, pad_to_match rings (also with a top/left offset), a pixel count no
multiple of the head's block, and the wrappers' refusals.

Needs a CUDA card and skips without one. The repo's conftest imports jax,
which the GPU machine lacks, so run it there as
    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol=atol=1e-4, as chip_smoke.py: float32 on both sides with
different summation orders (TF32 off for the plain versions)."""

import pytest
import torch

from popcorn_tpu_torch.nn import double_conv as A
from popcorn_tpu_torch.nn import head as C
from popcorn_tpu_torch.nn import up_block as B

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

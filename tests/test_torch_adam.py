"""The optimizer update's CPU side: ``Optimizer.update`` on CPU tensors
runs the plain chain and launches nothing; the leaf table that
train/adam.py hands csrc/adam.cu follows tree_flatten's order, with each
leaf's sizes, offsets, decay flag and gradient strides, and takes the last
update's outputs' pointers from their buffers; the kernel's chunks spread
a small member over the card and cap a large one's; its layout is kept while
the structure is; the wrapper refuses what the kernel does not take
before anything is built. The
kernel itself is held to the plain chain on the card
(tests/test_torch_cuda.py)."""

import pytest
import torch

from popcorn_tpu_torch.config import TrainConfig
from popcorn_tpu_torch.train import adam
from popcorn_tpu_torch.train.state import decay_mask, leaves_at, make_optimizer, tree_flatten

SHAPES = {
    "head": {"l1": {"w": (16, 64), "b": (64,)}, "l4": {"w": (64, 2), "b": (2,)}},
    "unet": {"fusion_out": {"w": (16, 1), "b": (1,)},
             "sar": {"inc": {"conv1": {"w": (3, 3, 2, 8), "b": (8,)}}}},
}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _case(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = _tree(lambda s: torch.randn(s, generator=g))
    # a conv weight's gradient arrives as a permuted view (HWIO of an OIHW tensor)
    grads = _tree(lambda s: (torch.randn(s[3], s[2], s[0], s[1], generator=g).permute(2, 3, 1, 0)
                             if len(s) == 4 else torch.randn(s, generator=g)))
    return params, grads


def test_leaves_at_follow_the_paths():
    params, grads = _case()
    paths = [p for p, _ in tree_flatten(params)]
    assert [id(v) for v in leaves_at(params, paths)] == [id(v) for _, v in tree_flatten(params)]
    assert [id(v) for v in leaves_at(grads, paths)] == [id(v) for _, v in tree_flatten(grads)]
    with pytest.raises(KeyError):
        leaves_at({"head": grads["head"]}, paths)


@pytest.mark.parametrize("clip,wd", [(0.01, 0.0), (0.0, 0.05), (1e9, 0.05)])
def test_update_on_cpu_runs_the_plain_chain_and_launches_nothing(clip, wd):
    params, grads = _case(1)
    opt = make_optimizer(TrainConfig(gradient_clip=clip, weight_decay=wd, learning_rate=1e-3))
    state = opt.init(params)
    before = {p: v.clone() for p, v in tree_flatten(params)}
    launches = adam.launches
    new_p, new_state = opt.update(grads, state, params)
    ref_p, ref_state = opt.update_plain(grads, state, params)
    assert adam.launches == launches
    for tree, ref in ((new_p, ref_p), (new_state["mu"], ref_state["mu"]),
                      (new_state["nu"], ref_state["nu"])):
        got, want = tree_flatten(tree), tree_flatten(ref)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            assert torch.equal(a, b), p
    assert new_state["count"] == 1 and new_state["lr"] == 1e-3
    for p, v in tree_flatten(params):
        assert torch.equal(v, before[p]), p


@pytest.mark.parametrize("sizes", [[1], [64], [65, 1, 3], [1, 128, 63, 64, 4097]])
def test_out_offsets_align_every_leaf(sizes):
    offs, total = adam.out_offsets(sizes)
    assert offs[0] == 0 and total % adam.ALIGN == 0
    for o, n, nxt in zip(offs, sizes, offs[1:] + [total]):
        assert o % adam.ALIGN == 0 and o + n <= nxt < o + n + adam.ALIGN


@pytest.mark.parametrize("total,chunk,blocks", [
    (1, 2048, 1), (39_333, 2048, 20), (2048 * 264 + 1, 4096, 133), (308_090_194, 65536, 4702)])
def test_chunks_spread_a_small_member_and_cap_a_large_one(total, chunk, blocks):
    got = adam.chunk_for(total)
    assert got == chunk and -(-total // got) == blocks and got % adam.CHUNK_STEP == 0
    assert adam.Layout([("a",)], [torch.Size([total])], [True]).chunk == chunk


def _leaves(seed):
    params, grads = _case(seed)
    flat = tree_flatten(params)
    paths = [q for q, _ in flat]
    p = [v for _, v in flat]
    return paths, p, leaves_at(grads, paths)


def test_table_rows_follow_tree_flatten():
    paths, p, g = _leaves(2)
    mu = [torch.zeros_like(v) for v in p]
    nu = [torch.ones_like(v) for v in p]
    rows, lay = adam.AdamKernel().table(paths, p, g, mu, nu, decay_mask)
    rows = list(rows)
    assert len(rows) == adam.TABLE_COLS * len(p)
    assert lay.total == sum(v.numel() for v in p)
    assert (lay.offs, lay.padded) == adam.out_offsets([v.numel() for v in p])
    start = 0
    for i, q in enumerate(paths):
        row = rows[i * adam.TABLE_COLS:(i + 1) * adam.TABLE_COLS]
        assert row[:4] == [p[i].data_ptr(), g[i].data_ptr(), mu[i].data_ptr(), nu[i].data_ptr()]
        assert row[4:7] == [start, p[i].numel(), lay.offs[i]], q
        strided = not g[i].is_contiguous()
        assert row[7] == (adam.DECAY if decay_mask(q) else 0) | (adam.STRIDED if strided else 0)
        lead = adam.MAX_DIM - p[i].dim()
        assert row[8:12] == [1] * lead + list(p[i].shape)
        # a contiguous gradient is read flat: its strides are left 0
        assert row[12:16] == ([0] * lead + list(g[i].stride()) if strided else [0] * 4)
        start += p[i].numel()
    # head.l4 alone is left undecayed, and the conv weight's gradient is strided
    assert [q for q, r in zip(paths, rows[7::adam.TABLE_COLS]) if not r & adam.DECAY] == [
        ("head", "l4", "b"), ("head", "l4", "w")]
    assert [q for q, r in zip(paths, rows[7::adam.TABLE_COLS]) if r & adam.STRIDED] == [
        ("unet", "sar", "inc", "conv1", "w")]


def test_layout_is_kept_while_the_structure_is():
    paths, p, g = _leaves(4)
    mu = [torch.zeros_like(v) for v in p]
    k = adam.AdamKernel()
    _, lay = k.table(paths, p, g, mu, mu, decay_mask)
    assert k.table(paths, p, g, mu, mu, decay_mask)[1] is lay
    views = [torch.empty(lay.padded).as_strided(*v) for v in lay.views]
    assert all(v.shape == t.shape and v.is_contiguous() for v, t in zip(views, p))
    # another shape at the same path: a new layout
    q = [torch.zeros(5) if i == 0 else t for i, t in enumerate(p)]
    gq = [torch.zeros(5) if i == 0 else t for i, t in enumerate(g)]
    assert k.table(paths, q, gq, q, q, decay_mask)[1] is not lay


def test_table_takes_the_last_outputs_pointers_from_their_buffers():
    paths, p, g = _leaves(5)
    mu = [torch.zeros_like(v) for v in p]
    k = adam.AdamKernel()
    _, lay = k.table(paths, p, g, mu, mu, decay_mask)
    bufs = tuple(torch.empty(lay.padded) for _ in range(3))
    k.last = adam.Outputs(bufs, *([b.as_strided(*v) for v in lay.views] for b in bufs))
    assert k.own(k.last.p, k.last.mu, k.last.nu) and not k.own(p, k.last.mu, k.last.nu)
    rows, again = k.table(paths, k.last.p, g, k.last.mu, k.last.nu, decay_mask)
    assert again is lay
    for col, leaves in ((0, k.last.p), (1, g), (2, k.last.mu), (3, k.last.nu)):
        assert list(rows[col::adam.TABLE_COLS]) == [t.data_ptr() for t in leaves]


def test_table_refuses_what_the_kernel_does_not_take():
    k = adam.AdamKernel()
    paths = [("a",)]
    p, g = [torch.zeros(4, 3)], [torch.zeros(4, 3)]
    mu, nu = [torch.zeros(4, 3)], [torch.zeros(4, 3)]
    with pytest.raises(ValueError, match="gradient"):
        k.table(paths, p, [torch.zeros(3, 4)], mu, nu, decay_mask)
    with pytest.raises(ValueError, match="not contiguous"):
        k.table(paths, [torch.zeros(3, 4).t()], g, mu, nu, decay_mask)
    with pytest.raises(ValueError, match="not contiguous"):
        k.table(paths, p, g, mu, [torch.zeros(3, 4).t()], decay_mask)
    with pytest.raises(ValueError, match="mu"):
        k.table(paths, p, g, [torch.zeros(12)], nu, decay_mask)
    with pytest.raises(TypeError):
        k.table(paths, p, [torch.zeros(4, 3, dtype=torch.float64)], mu, nu, decay_mask)
    with pytest.raises(ValueError, match="gradients"):
        k.table(paths, p, g + g, mu, nu, decay_mask)
    five = [torch.zeros(1, 1, 1, 4, 3)]
    with pytest.raises(ValueError, match="dimensions"):
        k.table(paths, five, five, five, five, decay_mask)


def test_update_refuses_cpu_leaves_before_any_build():
    paths, p, g = _leaves(3)
    mu = [torch.zeros_like(v) for v in p]
    launches = adam.launches
    kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, clip=0.01, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    with pytest.raises(ValueError, match="card"):
        adam.AdamKernel().update(paths, p, g, mu, mu, decay_mask, **kw)
    assert adam.launches == launches

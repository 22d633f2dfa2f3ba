"""The Prithvi-EO-2.0 member (nn/prithvi.py, ``-fe prithvi_eo2_300m``) at a
tiny preset that lives only here (hidden 64, 2 blocks, 4 heads, patch 4),
held to the benchmark's plain reference (port_bench/reference/prithvi.py)
on the CPU in float32: the encoder and neck's forward and every leaf's
gradient, the position table against its written formula, a sample in a
larger bucket at each of the 8 flips and rotations, three train steps in
each memory tier, the eval's member fold; the member's checkpoint under
Prithvi's names (strict both ways, a DDA member unchanged); the refused
options; the spans and counters. The update (csrc/adam.cu) at a small
size in many chunks is held to the plain chain on a card, and skips here."""

import math

import numpy as np
import pandas as pd
import pytest
import torch

from popcorn_tpu_torch.aug.augment import GeneralAugParams
from popcorn_tpu_torch.compat.weights import (
    load_popcorn_checkpoint,
    load_torch_state,
    save_popcorn_checkpoint,
    to_torch,
)
from popcorn_tpu_torch.config import ModelConfig, TrainConfig
from popcorn_tpu_torch.data.feed import extents_after
from popcorn_tpu_torch.data.normalize import NormStats
from popcorn_tpu_torch.nn import prithvi
from popcorn_tpu_torch.nn.init import init_prithvi_member
from popcorn_tpu_torch.nn.popcorn import check_config
from popcorn_tpu_torch.train.state import TrainStep, make_optimizer, tree_flatten
from popcorn_tpu_torch.utils import profiling

from port_bench.reference import prithvi as ref
from port_bench.reference.train import ORIENTATIONS, Region, TrainSettings, dihedral

torch.set_num_threads(1)

TINY = prithvi.PrithviSpec(depth=2, dim=64, heads=4, patch=4, mlp=256)
NAME = "prithvi_tiny"


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    monkeypatch.setitem(prithvi.PRESETS, NAME, TINY)


def _cfg(**kw):
    return ModelConfig(feature_extractor=NAME, compute_dtype="float32", biasinit=0.9407, **kw)


@pytest.fixture(scope="module")
def member(tmp_path_factory):
    """A tiny member drawn from a seed, written as a .pth: its path, its
    trees and its state dict as the reference reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(prithvi.PRESETS, NAME, TINY)
        params, consts = init_prithvi_member(7, _cfg())
    # move the head's output off its constant so the features matter
    params["head"]["l4"]["w"] = params["head"]["l4"]["w"] * 20
    path = str(tmp_path_factory.mktemp("prithvi") / "member.pth")
    save_popcorn_checkpoint(path, params, consts)
    sd = {k: torch.from_numpy(v) for k, v in load_torch_state(path).items()}
    return path, params, consts, sd


def _x6(seed, b, h, w):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, h, w, 6, generator=g)


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def test_encoder_and_neck_forward_match_the_reference(member):
    _, params, _, sd = member
    x6 = _x6(1, 2, 21, 30)
    got = prithvi.features(params, x6, None, TINY, None)
    want = ref.PrithviMember(sd, heads=4).features(
        x6.permute(0, 3, 1, 2), torch.zeros(2, 21, 30), False, False)
    assert got.shape == (2, 21, 30, prithvi.NECK_OUT)
    assert _rel(got, want.permute(0, 2, 3, 1)) <= 1e-5


def test_every_leaf_gradient_matches_the_reference(member):
    _, params, _, sd = member
    x6 = _x6(2, 1, 17, 22)
    wts = torch.randn(1, 17, 22, 16, generator=torch.Generator().manual_seed(3))
    flat = [(p, v) for p, v in tree_flatten({k: params[k] for k in ("encoder", "neck")})]
    leaves = [v.clone().requires_grad_(True) for _, v in flat]
    tree = {}
    for (p, _), v in zip(flat, leaves):
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = v
    got = torch.autograd.grad((prithvi.features(tree, x6, None, TINY, None) * wts).sum(), leaves)
    rsd = {k: (v.clone().requires_grad_(True) if k.split(".")[0] in ("encoder", "neck") else v)
           for k, v in sd.items()}
    out = ref.PrithviMember(rsd, heads=4).features(x6.permute(0, 3, 1, 2),
                                                   torch.zeros(1, 17, 22), False, False)
    names = prithvi_names(flat)
    want = torch.autograd.grad((out.permute(0, 2, 3, 1) * wts).sum(), [rsd[n] for n in names])
    assert len(got) == len(want) == 2 + 1 + 12 * TINY.depth + 2 + 2
    for n, a, b in zip(names, got, want):
        assert _rel(a.reshape(b.shape), b) <= 1e-4, n


def prithvi_names(flat):
    from popcorn_tpu_torch.compat.weights import prithvi_names as names

    table = names(TINY.depth)
    return [table[p] for p, _ in flat]


def test_position_table_follows_the_written_formula():
    """h != w: channels [0, 24) the w position, [24, 48) the h position,
    [48, 64) the t position, each sin then cos of pos / 10000 ** (2i/d)."""
    dim, h, w = 64, 3, 5
    got = prithvi.pos_table(dim, 1, h, w)
    want = np.zeros((h * w, dim))
    for r in range(h):
        for c in range(w):
            for lo, d, pos in ((0, 24, c), (24, 24, r), (48, 16, 0)):
                for i in range(d // 2):
                    ang = pos / 10000 ** (i / (d / 2))
                    want[r * w + c, lo + i] = math.sin(ang)
                    want[r * w + c, lo + d // 2 + i] = math.cos(ang)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(ref.pos_embed(dim, h, w).numpy(), want, atol=1e-6)
    assert not torch.allclose(ref.pos_embed(dim, h, w, swap_hw=True), got)


@pytest.mark.parametrize("v,hf,k", ORIENTATIONS)
def test_sample_in_a_larger_bucket_equals_the_sample_alone(member, v, hf, k):
    """A 13 x 18 sample at the top left of a 32 x 32 bucket, flipped and
    rotated with it: the batch's features equal the transformed sample's
    own inside its extent (extents_after) and are zero outside."""
    _, params, _, _ = member
    h, w, bh, bw = 13, 18, 32, 32
    x = _x6(4, 1, h, w)
    pad = torch.zeros(1, bh, bw, 6)
    pad[:, :h, :w] = x
    g = GeneralAugParams(vflip=v, hflip=hf, rot_k=k)
    ext = extents_after([(h, w)], bh, bw, g)
    alone, bucket = dihedral(x, v, hf, k), dihedral(pad, v, hf, k)
    r0, r1, c0, c1 = ext[0]
    assert torch.equal(bucket[0, r0:r1, c0:c1], alone[0])
    got = prithvi.features(params, bucket, ext, TINY, None)
    want = prithvi.features(params, alone, None, TINY, None)
    torch.testing.assert_close(got[0, r0:r1, c0:c1], want[0], rtol=1e-6, atol=1e-6)
    outside = torch.ones(bh, bw, dtype=torch.bool)
    outside[r0:r1, c0:c1] = False
    assert torch.count_nonzero(got[0][outside]) == 0
    # attending to the padding gives other features
    whole = prithvi.features(params, bucket, None, TINY, None)
    assert not torch.allclose(whole[0, r0:r1, c0:c1], want[0], atol=1e-3)


class _Region(Region):
    """reference/train.py's Region over arrays held in memory: four
    seasons, a 2 x 2 grid of census regions."""

    def __init__(self, seed=5, h=44, w=52):
        g = np.random.default_rng(seed)
        self.s2 = [torch.from_numpy(g.integers(200, 3000, (h, w, 4)).astype(np.float32))
                   for _ in range(4)]
        self.s1 = [torch.from_numpy(g.normal(-12, 3, (h, w, 2)).astype(np.float32))
                   for _ in range(4)]
        ids = np.zeros((h, w), np.float32)
        rows, cols, bbox = (0, 19, h), (0, 27, w), []
        for i in range(2):
            for j in range(2):
                ids[rows[i]:rows[i + 1], cols[j]:cols[j + 1]] = 2 * i + j + 1
                bbox.append(f"[{rows[i]}, {rows[i + 1]}, {cols[j]}, {cols[j + 1]}]")
        self.ids = torch.from_numpy(ids)
        self.table = pd.DataFrame({"idx": [1, 2, 3, 4], "bbox": bbox,
                                   "POP20": [310.0, 95.0, 1200.0, 40.0]})
        self.h, self.w = h, w


def _batch(region, idxs, orient, photometric):
    """A batch as the feed assembles it: the samples padded to one bucket
    at the top left, flipped and rotated together, with their extents."""
    bh = bw = 64
    v, hf, k = orient
    samples = [region.sample(i, 0, (bh, bw)) for i in idxs]
    out = {key: dihedral(torch.stack([s[key] for s in samples]), v, hf, k)
           for key in ("S2", "S1", "admin_mask")}
    hw = []
    for i in idxs:
        (x0, x1, y0, y1), _ = region.window(i)
        hw.append((x1 - x0, y1 - y0))
    out["extent"] = extents_after(hw, bh, bw, GeneralAugParams(v, hf, k))
    out["census_idx"] = torch.tensor(idxs, dtype=torch.float32)
    out["y"] = torch.tensor([region.window(i)[1] for i in idxs], dtype=torch.float32)
    out["photometric"] = torch.tensor(photometric, dtype=torch.float32)
    return out


@pytest.mark.parametrize("tier", ["trained", "encoder_frozen", "encoder_and_neck_frozen"])
def test_three_train_steps_match_the_reference(member, tier):
    """TrainStep x 3 (the clip engaged) against reference/prithvi.py's
    run_steps on the same batches and sparsity draws: each step's loss and
    each leaf's change over the three steps."""
    path, params, consts, _ = member
    limits = {"trained": (10 ** 9, 10 ** 9), "encoder_frozen": (0, 10 ** 9),
              "encoder_and_neck_frozen": (0, 0)}[tier]
    region = _Region()
    batches = [_batch(region, [1, 4], (False, True, 1), [1, 1.2, 1, 0.8]),
               _batch(region, [2, 3], (True, False, 0), [0, 1, 1, 1.3]),
               _batch(region, [3, 1], (True, True, 3), [1, 0.9, 0, 1])]
    tcfg = TrainConfig(learning_rate=1e-3, gradient_clip=0.01, limit1=limits[0],
                       limit2=limits[1])
    opt = make_optimizer(tcfg)
    step = TrainStep(_cfg(), tcfg, consts, NormStats(), opt)
    gen = torch.Generator().manual_seed(11)
    p, state, losses, gens = params, opt.init(params), [], []
    for b in batches:
        npix = b["S2"].shape[0] * b["S2"].shape[1] * b["S2"].shape[2]
        gens.append(gen.get_state().clone())
        p, state, aux = step(p, state, b, gen, encoder_no_grad=npix > tcfg.limit1,
                             unet_no_grad=npix > tcfg.limit2)
        losses.append(float(aux["optimization_loss"]))
    want = ref.run_steps(region, path, batches, gens,
                         TrainSettings(learning_rate=1e-3, gradient_clip=0.01, limit1=limits[0],
                                       limit2=limits[1]), "cpu", heads=4)
    assert want["batch_misses"] == 0
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-5)
    p0, p3 = dict(tree_flatten(params)), dict(tree_flatten(p))
    for q, name in zip(p0, _all_names(params)):
        d = p3[q] - p0[q]
        d = d.t() if q[0] == "head" and d.dim() == 2 else d  # (in, out) -> (out, in, 1, 1)
        torch.testing.assert_close(d.reshape(want["change"][name].shape), want["change"][name],
                                   rtol=1e-3, atol=3e-6, msg=str(q))
    frozen_enc = tier != "trained"
    enc_moved = any(float((p3[q] - p0[q]).abs().max()) > 0 for q in p0 if q[0] == "encoder")
    assert enc_moved != frozen_enc


def _all_names(params):
    from popcorn_tpu_torch.compat.weights import prithvi_names as names

    table = names(TINY.depth)
    out = []
    for q, _ in tree_flatten(params):
        if q[0] == "head":
            out.append(f"head.{2 * (int(q[1][1]) - 1)}.{'weight' if q[2] == 'w' else 'bias'}")
        else:
            out.append(table[q])
    return out


def test_train_cli_trains_a_prithvi_member(tmp_path):
    """``cli.train -fe <preset>`` trains the member through the Trainer on
    the CPU, logs the extractor's spans and counters each epoch, writes
    its checkpoint under Prithvi's names, and a Trainer resumes from it."""
    import json
    import os

    from popcorn_tpu_torch.cli import train as train_cli
    from popcorn_tpu_torch.config import DataPaths
    from popcorn_tpu_torch.data.synthetic import make_synthetic_region
    from popcorn_tpu_torch.train.trainer import Trainer

    root = str(tmp_path / "data")
    make_synthetic_region(root, "rwa", height=96, width=128, n_regions=(2, 2), seed=3)
    flags = ["-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa", "-occmodel",
             "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse",
             "--compute_dtype", "float32", "-fe", NAME]
    trainer = train_cli.main(["--data_root", root, *flags, "-e", "1", "-lt", "1", "-ms", "2",
                              "-w", "1", "--device", "cpu", "--save_dir", str(tmp_path / "out")])
    assert set(trainer.params) == {"encoder", "neck", "head"}
    with open(os.path.join(trainer.experiment_folder, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    logged = set().union(*(r.keys() for r in recs))
    assert {"time/prithvi.encoder_ms", "time/prithvi.neck_ms", "tokens/encoder",
            "tokens/bucket"} <= logged
    enc = next(r for r in recs if "tokens/encoder" in r)
    assert 0 < enc["tokens/encoder"] < enc["tokens/bucket"]
    path = os.path.join(trainer.experiment_folder, "last_model.pth")
    assert "encoder.blocks.1.attn.qkv.weight" in torch.load(path, weights_only=True)["model"]
    back = Trainer(DataPaths(root), _cfg(), TrainConfig(save_dir=str(tmp_path / "out2")),
                   resume=path, device="cpu")
    for (q, a), (_, b) in zip(tree_flatten(trainer.params), tree_flatten(back.params)):
        assert torch.equal(a, b), q


def test_eval_fold_takes_a_prithvi_member(member):
    """infer/sliding.py::make_patch_forward with the member: one patch's
    density and scale against the reference's forward of the member."""
    from popcorn_tpu_torch.infer.sliding import make_patch_forward

    _, params, consts, sd = member
    g = np.random.default_rng(9)
    s2 = torch.from_numpy(g.integers(200, 3000, (1, 36, 40, 4)).astype(np.float32))
    s1 = torch.from_numpy(g.normal(-12, 3, (1, 36, 40, 2)).astype(np.float32))
    cfg = _cfg()
    fn = make_patch_forward(cfg, consts, NormStats(), 1)
    res = fn([params], {"S2": s2, "S1": s1, "mask": torch.ones(1, 36, 40, dtype=torch.bool),
                        "valid": torch.ones(1, dtype=torch.bool)})
    stats = ref.load_stats("cpu")
    x6 = ref.dda_input(s2.permute(0, 3, 1, 2), s1.permute(0, 3, 1, 2), stats)
    dense, scale = ref.member_maps(sd, x6, heads=4)
    assert _rel(res["dense_sum"], dense) <= 1e-5
    assert _rel(res["scale_sum"], scale) <= 1e-5


def test_checkpoint_round_trip_under_prithvis_names(member, tmp_path):
    path, params, consts, sd = member
    names = set(sd)
    assert {"encoder.cls_token", "encoder.patch_embed.proj.weight", "encoder.norm.weight",
            "encoder.blocks.1.attn.qkv.weight", "encoder.blocks.0.mlp.fc2.bias", "neck.weight",
            "head.6.bias"} <= names
    assert sd["encoder.patch_embed.proj.weight"].shape == (64, 6, 1, 4, 4)
    assert not any(k.startswith("unetmodel.") for k in names)
    p2, c2 = load_popcorn_checkpoint(path)
    for (q, a), (q2, b) in zip(tree_flatten(params), tree_flatten(p2)):
        assert q == q2 and torch.equal(a, b), q
    for (q, a), (_, b) in zip(tree_flatten(consts), tree_flatten(c2)):
        assert torch.equal(a, b), q
    # strict: a key left over or missing raises; the published pos_embed buffer is read past
    for extra, drop in (({"encoder.blocks.0.attn.bias": torch.zeros(3)}, None),
                        ({}, "encoder.blocks.1.norm2.bias"),
                        ({"encoder.pos_embed": torch.zeros(1, 5, 64)}, None)):
        bad = {k: v for k, v in sd.items() if k != drop}
        bad.update(extra)
        p = str(tmp_path / "bad.pth")
        torch.save({"model": bad}, p)
        if "encoder.pos_embed" in extra:
            load_popcorn_checkpoint(p)
        else:
            with pytest.raises(KeyError):
                load_popcorn_checkpoint(p)


def test_dda_member_still_loads_as_before(tmp_path):
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda

    params, consts = load_popcorn_from_dda(ModelConfig(biasinit=0.9407), head_seed=1)
    path = str(tmp_path / "dda.pth")
    save_popcorn_checkpoint(path, params, consts)
    p2, c2 = load_popcorn_checkpoint(path)
    assert set(p2) == {"unet", "head"} and set(c2) == {"unet_bn", "builder"}
    for (q, a), (_, b) in zip(tree_flatten(to_torch(params)), tree_flatten(p2)):
        assert torch.equal(a, b), q


@pytest.mark.parametrize("kw,flag", [({"quantize": "int8s"}, "--quantize"),
                                     ({"quantize": "int8"}, "--quantize")])
def test_refused_model_options(kw, flag):
    with pytest.raises(ValueError, match=flag):
        check_config(_cfg(**kw))


@pytest.mark.parametrize("kw,flag", [({"spatial": True}, "--spatial"),
                                     ({"spatial_train": True}, "--spatial_train")])
def test_refused_run_options(kw, flag):
    with pytest.raises(ValueError, match=flag):
        check_config(_cfg(), **kw)
    check_config(ModelConfig(), **kw)  # the DDA member runs them


def test_unknown_extractor_is_refused():
    with pytest.raises(ValueError, match="feature_extractor"):
        check_config(ModelConfig(feature_extractor="resnet50"))


def test_spans_and_counters(member):
    _, params, _, _ = member
    profiling.SPANS.reset()
    profiling.COUNTERS.reset()
    ext = np.asarray([[0, 9, 0, 13], [2, 20, 1, 11]])
    prithvi.features(params, _x6(6, 2, 20, 24), ext, TINY, None)
    c = profiling.COUNTERS.summary()
    assert c["tokens/encoder"] == (3 * 4 + 1) + (5 * 3 + 1)
    assert c["tokens/bucket"] == 2 * (5 * 6 + 1)
    s = profiling.SPANS.summary()
    assert s["prithvi.encoder"]["count"] == s["prithvi.embed"]["count"] == 2
    assert s["prithvi.neck"]["count"] == 2


# ---------------------------------------------------------- the update on a card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the update is a CUDA kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("blocks", [None, 1])
@pytest.mark.parametrize("clip,wd", [(0.01, 0.0), (0.0, 0.05), (1e9, 0.05)])
def test_grid_update_matches_the_plain_chain_and_repeats(dev, clip, wd, blocks, monkeypatch):
    """csrc/adam.cu's grid at a small size (odd leaves, strided gradients,
    leaves across chunk edges), in 76 chunks of 2,048 elements and, with
    ``GRID_BLOCKS`` 1, in 3 of GRID_CHUNK, against Optimizer.update_plain,
    and the same bits on a second run. The clip engaged is read without
    decay: a norm one rounding apart moves a step by more than the
    tolerance where the decayed gradient cancels to about eps."""
    from popcorn_tpu_torch.train import adam
    from popcorn_tpu_torch.train.state import tree_unflatten

    g = torch.Generator().manual_seed(1800)
    shapes = [(), (3,), (1023,), (5, 7, 3), (3, 3, 5, 7), (70001,), (64, 6, 4, 4), (300, 257)]
    params = tree_unflatten(((f"l{i}", "w"), torch.randn(s, generator=g).to(dev))
                            for i, s in enumerate(shapes))
    grads = tree_unflatten(
        (q, torch.randn(v.shape[::-1], generator=g).to(dev).permute(*range(v.dim() - 1, -1, -1))
         if v.dim() > 1 and i % 2 else torch.randn(v.shape, generator=g).to(dev))
        for i, (q, v) in enumerate(tree_flatten(params)))
    opt = make_optimizer(TrainConfig(gradient_clip=clip, weight_decay=wd, learning_rate=1e-2))
    if blocks is not None:
        monkeypatch.setattr(adam, "GRID_BLOCKS", blocks)
    state = opt.init(params)
    got = opt.update(grads, state, params)
    want = opt.update_plain(grads, state, params)
    for a, b in ((got[0], want[0]), (got[1]["mu"], want[1]["mu"]), (got[1]["nu"], want[1]["nu"])):
        for (q, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7, msg=str(q))
    launches = adam.launches
    again = opt.update(grads, state, params)
    assert adam.launches == launches + 1
    for a, b in ((got[0], again[0]), (got[1]["mu"], again[1]["mu"]),
                 (got[1]["nu"], again[1]["nu"])):
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)))

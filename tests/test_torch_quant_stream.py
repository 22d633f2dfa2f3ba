"""The quantized eval as a whole on the CPU (plain versions of kernels
E-H): the static int8 stream against the JAX package's, the dynamic
path's block routing, the eval CLI in each ``--quantize`` mode, and the
train CLI's ``--quantize_eval``.

Bounds:
- the static stream against packed_unet_stream_qs with the same scales:
  correlation > 0.9999 (a code may flip by one where a requant lands on a
  half, and the flip travels through the later blocks);
- the static stream against the float32 stream: tests/test_pallas_conv.py::
  test_int8_static_stream_close_to_f32's max error < 0.08 x the output's
  max and correlation > 0.995;
- census r2 of a quantized eval within 0.02 of the float run: the JAX
  package's QUANT_R2_BOUND (tests/test_quantize_acceptance.py:27)."""

import csv
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import save_popcorn_checkpoint as j_save_checkpoint
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.nn import packed as K
from popcorn_tpu.nn.init import init_popcorn
from popcorn_tpu_torch.cli import eval as eval_cli
from popcorn_tpu_torch.cli.args import eval_parser, model_config_from_args, train_parser
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.config import DataPaths, EvalConfig, ModelConfig, TrainConfig
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.infer import sliding
from popcorn_tpu_torch.infer.evaluator import Evaluator
from popcorn_tpu_torch.io.geotiff import GeoTIFF
from popcorn_tpu_torch.nn import double_conv as dc
from popcorn_tpu_torch.nn import quant, unet
from popcorn_tpu_torch.nn import up_block as ub

torch.set_num_threads(1)
QUANT_R2_BOUND = 0.02
PATCH, OVERLAP = 96, 16
EVAL_FLAGS = ["-occmodel", "-senbuilds", "-S2", "-NIR", "-S1", "-treg", "rwa", "-tlevel",
              "coarse", "--device", "cpu", "-w", "1", "--patchsize", str(PATCH),
              "--patch_overlap", str(OVERLAP), "--compute_dtype", "float32"]


def _stream_params(key):
    params, consts = init_popcorn(jax.random.PRNGKey(key), JModelConfig(pretrained=False))
    jp, jbn = params["unet"]["sar"], consts["unet_bn"]["sar"]
    return jp, jbn, to_torch(jax.tree.map(np.asarray, jp)), to_torch(jax.tree.map(np.asarray, jbn))


def _x(seed, shape=(1, 64, 96, 2)):
    return (np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("wbits", [8, 4], ids=["int8s", "w4a8"])
def test_static_stream_matches_jax_static_stream(wbits):
    jp, jbn, tp, tbn = _stream_params(5)
    x = _x(81)
    f = 4
    jsc = K.calibrate_packed_stream(jp, jbn, K.pack(jnp.asarray(x), f), f)
    ref = np.asarray(K.unpack(
        K.packed_unet_stream_qs(jp, jbn, K.pack(jnp.asarray(x), f), f, jsc, wbits=wbits), f, 8))
    scales = {k: torch.tensor(np.float32(v)) for k, v in jsc.items()}
    got = unet.unet_stream_qs(tp, tbn, torch.from_numpy(x), scales, wbits).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.9999


def test_static_stream_close_to_f32():
    """int8s only: the int4 weight grid of w4a8 moves the JAX package's own
    stream far from float32 (on this input, 29% max error and correlation
    0.942 against float32, the port's the same to 7e-8), so w4a8 is held to
    the JAX w4a8 stream above and to the census bound below."""
    jp, jbn, tp, tbn = _stream_params(5)
    x = _x(82)
    f = 4
    ref = np.asarray(K.unpack(K.packed_unet_stream(jp, jbn, K.pack(jnp.asarray(x), f), f), f, 8))
    xt = torch.from_numpy(x)
    got = unet.unet_stream_qs(tp, tbn, xt, quant.calibrate_stream(tp, tbn, xt)).numpy()
    a, b = ref.ravel(), got.ravel()
    assert float(np.abs(a - b).max()) < 0.08 * float(np.abs(a).max())
    assert np.corrcoef(a, b)[0, 1] > 0.995


def test_static_stream_refuses_sides_not_multiples_of_4():
    _, _, tp, tbn = _stream_params(5)
    x = torch.from_numpy(_x(83, (1, 66, 96, 2)))
    with pytest.raises(ValueError, match="divisible by 4"):
        unet.unet_stream_qs(tp, tbn, x, quant.calibrate_stream(tp, tbn, x))


@pytest.mark.parametrize("hw,n_q_dc,n_q_up", [((64, 96), 3, 2), ((66, 98), 3, 1), ((65, 97), 0, 0)],
                         ids=["div4", "div2", "odd"])
def test_dynamic_stream_routes_blocks_as_the_jax_engine(monkeypatch, hw, n_q_dc, n_q_up):
    """All five blocks int8 when H % 4 == W % 4 == 0; up2 float when only
    H % 2 == W % 2 == 0 (the JAX package's plain XLA up2 at pack factor 2);
    all float otherwise (its plain engine). The quantized stream stays
    within int8 error of the float one."""
    _, _, tp, tbn = _stream_params(7)
    calls = {"q_dc": 0, "q_up": 0, "dc": 0, "up": 0}

    def counting(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(unet, "double_conv_q", counting("q_dc", unet.double_conv_q))
    monkeypatch.setattr(unet, "up_block_q", counting("q_up", unet.up_block_q))
    monkeypatch.setattr(unet, "_double_conv_kernel", counting("dc", unet._double_conv_kernel))
    monkeypatch.setattr(unet, "_up_block_kernel", counting("up", unet._up_block_kernel))
    x = torch.from_numpy(_x(84, (1, *hw, 2)))
    got = unet.unet_stream(tp, tbn, x, quantize=True)
    assert calls == {"q_dc": n_q_dc, "q_up": n_q_up, "dc": 3 - n_q_dc, "up": 2 - n_q_up}
    ref = unet.unet_stream(tp, tbn, x)
    a, b = ref.numpy().ravel(), got.numpy().ravel()
    assert float(np.abs(a - b).max()) < 0.08 * float(np.abs(a).max())
    assert np.corrcoef(a, b)[0, 1] > 0.995
    # training never quantizes
    calls.update(q_dc=0, q_up=0)
    unet.unet_stream(tp, tbn, x, quantize=True, train=True)
    assert calls["q_dc"] == calls["q_up"] == 0


# ------------------------------------------------------------------ eval CLI


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    """tests/test_quantize_acceptance.py's setup: its 192x256 synthetic
    region (seed 47), its two .pth members (one random init, scaled by 1
    and 1.01), and the port's float run of the eval CLI."""
    root = str(tmp_path_factory.mktemp("quant_region"))
    make_synthetic_region(root, "rwa", height=192, width=256, seed=47)
    mdir = tmp_path_factory.mktemp("quant_members")
    params, consts = init_popcorn(jax.random.PRNGKey(1601), JModelConfig(pretrained=False))
    members = []
    for s in range(2):
        member = jax.tree.map(lambda x, s=s: x * (1.0 + 0.01 * s), params)
        members.append(str(mdir / f"m{s + 1}.pth"))
        j_save_checkpoint(members[-1], member, consts, epoch=s, iteration=s)
    base = eval_cli.main(["--data_root", root, *EVAL_FLAGS, "-r", *members])
    return root, members, base


def _within_bound(base, quant_stats, tag):
    r2_keys = [k for k in base if k.endswith("/r2")]
    assert any("AdjCensus" in k for k in r2_keys) and any("MainCensus" in k for k in r2_keys)
    for k in r2_keys:
        assert np.isfinite(quant_stats[k]), (tag, k)
        assert abs(quant_stats[k] - base[k]) <= QUANT_R2_BOUND, (tag, k, quant_stats[k], base[k])


def _count_plain_calls(monkeypatch):
    calls = {"E": 0, "F": 0, "G": 0, "H": 0}
    for key, mod, name in (("E", dc, "double_conv_qs_plain"), ("F", ub, "up_block_qs_plain"),
                           ("G", dc, "double_conv_q_plain"), ("H", ub, "up_block_q_plain")):
        fn = getattr(mod, name)

        def run(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, run)
    return calls


@pytest.mark.parametrize("mode", ["int8s", "w4a8", "int8"])
def test_eval_cli_quantized_within_census_bound(region, monkeypatch, mode):
    root, members, base = region
    calls = _count_plain_calls(monkeypatch)
    stats = eval_cli.main(["--data_root", root, *EVAL_FLAGS, "-r", *members, "--quantize", mode])
    _within_bound(base, stats, mode)
    static = mode != "int8"
    assert (calls["E"] > 0, calls["F"] > 0) == (static, static), calls
    assert (calls["G"] > 0, calls["H"] > 0) == (not static, not static), calls
    # per member and patch: 3 DoubleConvs and 2 Up blocks a stream
    assert (calls["E"] + calls["G"]) * 2 == (calls["F"] + calls["H"]) * 3
    folder = sorted(glob.glob(os.path.join(os.path.dirname(members[0]), "eval_outputs_ensemble_*")))[-1]
    with GeoTIFF(os.path.join(folder, "rwa_predictions.tif")) as g:
        pred = g.read(1, squeeze=True)
    assert pred.shape == (192, 256) and np.isfinite(pred).all() and pred.max() > 0
    with open(os.path.join(folder, "args.csv")) as f:
        assert dict(csv.reader(f))["quantize"] == mode


def test_eval_int8_with_quantized_builder_within_census_bound(region, monkeypatch):
    """quantize='int8' with pallas_stream=True quantizes the building
    extractor too: 6 more DoubleConvs and 4 more Up blocks a patch batch."""
    root, members, base = region
    counts = {}
    for ps in (None, True):
        calls = _count_plain_calls(monkeypatch)
        mcfg = ModelConfig(quantize="int8", pallas_stream=ps)
        ecfg = EvalConfig(checkpoints=tuple(members), patchsize=PATCH, overlap=OVERLAP, num_workers=1)
        stats = Evaluator(DataPaths(root), mcfg, ecfg, device="cpu").test_target(save=False)
        counts[ps] = dict(calls)
    _within_bound(base, stats, "int8+builder")
    n_batches = counts[None]["G"] // 12  # 2 members x 2 streams x 3
    assert n_batches > 0 and counts[None]["G"] == 12 * n_batches
    assert counts[True]["G"] == counts[None]["G"] + 6 * n_batches
    assert counts[True]["H"] == counts[None]["H"] + 4 * n_batches


def test_eval_parser_takes_the_jax_quantize_modes():
    from popcorn_tpu.cli.args import eval_parser as j_eval_parser

    jq = next(a for a in j_eval_parser()._actions if a.dest == "quantize")
    q = next(a for a in eval_parser()._actions if a.dest == "quantize")
    assert list(q.choices) == list(jq.choices) and q.default is None
    for mode in q.choices:
        args = eval_parser().parse_args(["-r", "m.pth", "--quantize", mode])
        assert model_config_from_args(args).quantize == mode


# ------------------------------------------------------------------ train CLI


def test_train_quantize_eval_keeps_steps_float_and_tests_quantized(tmp_path, monkeypatch):
    """--quantize_eval: a train step's gradients are the same bits as
    without it, and the in-training target test runs the static int8 fold
    (its members' scales are calibrated, kernels E and F run)."""
    from popcorn_tpu_torch.train.trainer import TRAIN_KEYS, Trainer

    root = str(tmp_path / "data")
    make_synthetic_region(root, "rwa", height=256, width=384, n_regions=(3, 4), seed=11)
    args = train_parser().parse_args([
        "-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa", "-occmodel", "-senbuilds",
        "-pret", "-binit", "0.9407", "-tlevel", "coarse", "--quantize_eval", "int8s",
        "--compute_dtype", "float32",
    ])
    mcfg = model_config_from_args(args)
    assert mcfg.quantize == "int8s"
    trainers = {}
    for tag, cfg in (("quant", mcfg), ("float", dataclasses.replace(mcfg, quantize=None))):
        tcfg = TrainConfig(num_epochs=1, bucket_ladder=(128, 256, 512), max_samples=2,
                           num_workers=1, save_dir=str(tmp_path / tag))
        trainers[tag] = Trainer(DataPaths(root), cfg, tcfg, inference_patch=128,
                                inference_overlap=16, device="cpu")
    grads = {}
    for tag, tr in trainers.items():
        batch, flags = next((b, f) for b in tr.feed.epoch(0) if (f := tr._tier_flags(b)) is not None)
        dev_batch = sliding._upload(batch, tr.device, TRAIN_KEYS)
        grads[tag], _ = tr.step_fn.grads(tr.params, dev_batch, torch.Generator().manual_seed(0),
                                         **flags)
    from popcorn_tpu_torch.train.state import tree_flatten

    ref = dict(tree_flatten(grads["float"]))
    for path, g in tree_flatten(grads["quant"]):
        assert torch.equal(g, ref[path]), path
    calls = _count_plain_calls(monkeypatch)
    cal = []
    orig = sliding.calibrate_member_scales
    monkeypatch.setattr(sliding, "calibrate_member_scales",
                        lambda *a, **k: cal.append(1) or orig(*a, **k))
    out = trainers["quant"].test_target()
    assert cal == [1] and calls["E"] > 0 and calls["F"] > 0
    assert all(np.isfinite(v) for v in out.values())

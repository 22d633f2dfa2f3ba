"""bf16 compute (``compute_dtype='bfloat16'``, the CLIs' default) in the
port against the JAX package at bfloat16, on the CPU: the plain versions
of kernels A, B and C against the Pallas kernels they stand for (interpret
mode), the nn/ops.py ops against popcorn_tpu/nn/ops.py, one UNet stream,
the sliding-window fold, one train step, the int8s fold, and the CLI
defaults. Inputs come from numpy seeds and go to both packages.

Tolerances and why:
- one block or op: |got - ref| <= 2^-7 |ref| + 2^-7 max|ref|, about one
  bf16 ulp of the value plus one of the block's scale: both sides sum
  exact bf16 products in float32, in another order, and a float32 sum
  that lands on a bf16 rounding midpoint may round either way, which
  moves that value one ulp and its neighbours in the next conv a little.
  Fewer than DIFF_SHARE of the elements may differ at all.
- a stream, the maps and the train step: relative L2 <= 1e-2, and
  correlation >= 0.9999 against the JAX package's Pallas-route semantics
  (the rounding of the port's kernels), >= 0.999 against its XLA route,
  which rounds after every op. The fold's maps are held to the XLA route
  by correlation alone: the JAX package's own bf16 XLA fold lies 3.9%
  (relative L2) from its float32 fold and 3.8% from its Pallas-route bf16
  fold on this region, where the port's bf16 fold lies 0.5% from the
  latter (CPU runs of these tests' inputs). Census r2 within 1e-3 of the
  JAX Pallas-route run's.
- the int8s fold: correlation > 0.9999 against the JAX package's int8s
  fold with its builder on the Pallas route too, as in
  test_torch_fold_pad.py (a code may flip by one where a requant lands on
  a half)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda, save_popcorn_checkpoint
from popcorn_tpu.config import EvalConfig as JEvalConfig
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.config import TrainConfig as JTrainConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.normalize import NormStats as JNormStats
from popcorn_tpu.data.normalize import normalize_and_assemble as j_normalize
from popcorn_tpu.data.normalize import photometric_s2_traced as j_photometric
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.infer.evaluator import Evaluator as JEvaluator
from popcorn_tpu.infer.evaluator import load_member as j_load_member
from popcorn_tpu.infer.sliding import run_sliding_inference as j_run
from popcorn_tpu.nn import ops as jops
from popcorn_tpu.nn import packed as K
from popcorn_tpu.nn import unet as junet
from popcorn_tpu.nn.init import init_popcorn
from popcorn_tpu.nn.popcorn import create_building_score as j_score
from popcorn_tpu.nn.popcorn import sparsity_mask as j_sparsity_mask
from popcorn_tpu.nn.pallas_conv import fused_double_conv
from popcorn_tpu.nn.pallas_packed_head import fused_packed_head
from popcorn_tpu.train.state import make_train_step as j_make_train_step
from popcorn_tpu_torch.compat.weights import from_jax, init_head, to_torch
from popcorn_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.normalize import NormStats
from popcorn_tpu_torch.infer.evaluator import Evaluator, load_member
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from popcorn_tpu_torch.nn import double_conv as dc
from popcorn_tpu_torch.nn import head as hd
from popcorn_tpu_torch.nn import ops, quant, unet
from popcorn_tpu_torch.nn import up_block as ub
from popcorn_tpu_torch.nn.popcorn import check_config, compute_dtype
from popcorn_tpu_torch.train.state import make_optimizer, make_train_step, tree_flatten

torch.set_num_threads(1)
BF16, JBF16 = torch.bfloat16, jnp.bfloat16
ULP = 2.0 ** -7
DIFF_SHARE = 0.01
REL_L2 = 1e-2
CORR_PALLAS, CORR_XLA = 0.9999, 0.999
R2_TOL = 1e-3
INT8S_CORR = 0.9999


def _np(a) -> np.ndarray:
    """float32 numpy of a JAX array or a torch tensor, in any float dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_block_close(got, ref, what: str) -> float:
    """The per-block bound of the module docstring; returns the share of
    elements that differ."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    bound = ULP * np.abs(ref) + ULP * np.abs(ref).max()
    assert (err <= bound).all(), f"{what}: max err {err.max()} at bound {bound[err > bound].min()}"
    share = float((got != ref).mean())
    assert share < DIFF_SHARE, f"{what}: {share:.4%} of the elements differ"
    return share


def assert_maps_close(got, ref, corr_min: float, what: str, rel_l2=REL_L2) -> None:
    """Correlation >= corr_min and, unless ``rel_l2`` is None, relative L2
    <= rel_l2."""
    a, b = _np(ref).ravel().astype(np.float64), _np(got).ravel().astype(np.float64)
    rel = np.linalg.norm(b - a) / np.linalg.norm(a)
    corr = np.corrcoef(a, b)[0, 1]
    assert (rel_l2 is None or rel <= rel_l2) and corr >= corr_min, (
        f"{what}: relative L2 {rel}, correlation {corr}")


def _n(rng, shape, s):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _dc_params(rng, cin, cm, cout):
    p = {"conv1": {"w": _n(rng, (3, 3, cin, cm), 0.3), "b": _n(rng, (cm,), 1.0)},
         "conv2": {"w": _n(rng, (3, 3, cm, cout), 0.3), "b": _n(rng, (cout,), 1.0)}}
    bn = {"bn1": {"scale": _n(rng, (cm,), 1.0), "shift": _n(rng, (cm,), 1.0)},
          "bn2": {"scale": _n(rng, (cout,), 1.0), "shift": _n(rng, (cout,), 1.0)}}
    return p, bn


def _up_params(rng, c1, cs, cm):
    p = {"tconv": {"w": _n(rng, (c1, 2, 2, c1), 0.3), "b": _n(rng, (c1,), 1.0)}}
    p["conv"], bn = _dc_params(rng, cs + c1, cm, cm)
    return p, bn


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------------------- blocks, ops


@pytest.mark.parametrize("op", ["conv3x3", "conv1x1", "conv_transpose_2x2", "frozen_bn"])
def test_ops_bf16_match_jax_ops(op):
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 13, 17, 8)).astype(np.float32)
    p = {"conv3x3": {"w": _n(rng, (3, 3, 8, 16), 0.3), "b": _n(rng, (16,), 1.0)},
         "conv1x1": {"w": _n(rng, (8, 16), 0.3), "b": _n(rng, (16,), 1.0)},
         "conv_transpose_2x2": {"w": _n(rng, (8, 2, 2, 16), 0.3), "b": _n(rng, (16,), 1.0)},
         "frozen_bn": {"scale": _n(rng, (8,), 1.0), "shift": _n(rng, (8,), 1.0)}}[op]
    if op == "frozen_bn":
        xb = torch.from_numpy(x).to(BF16)
        got = ops.frozen_bn(xb, to_torch(p))
        ref = jops.frozen_bn(jnp.asarray(x).astype(JBF16), _jax(p))
    else:
        got = getattr(ops, op)(torch.from_numpy(x), to_torch(p), BF16)
        ref = getattr(jops, op)(jnp.asarray(x), _jax(p), JBF16)
    assert got.dtype == BF16 and ref.dtype == JBF16
    assert_block_close(got, ref, op)


@pytest.mark.parametrize("shape,cm,cout", [((2, 24, 40, 2), 8, 8), ((1, 19, 37, 16), 16, 16)])
def test_double_conv_bf16_matches_pallas(shape, cm, cout):
    """Kernel A's plain version against _double_conv_kernel at bf16, and
    the trainable composition against the XLA block, both at bf16."""
    rng = np.random.default_rng(32)
    p, bn = _dc_params(rng, shape[-1], cm, cout)
    x = rng.normal(size=shape).astype(np.float32)
    jp, jbn = _jax(p), _jax(bn)
    pallas = fused_double_conv(jnp.asarray(x), jp["conv1"]["w"], jp["conv1"]["b"], jbn["bn1"],
                               jp["conv2"]["w"], jp["conv2"]["b"], jbn["bn2"], dtype=JBF16)
    got = dc.double_conv(to_torch(p), to_torch(bn), torch.from_numpy(x), BF16)
    assert got.dtype == BF16
    assert_block_close(got, pallas, "double_conv vs Pallas")
    xla = junet.double_conv(jp, jbn, jnp.asarray(x), JBF16)
    assert_block_close(dc.double_conv_ops(to_torch(p), to_torch(bn), torch.from_numpy(x), BF16),
                       xla, "double_conv_ops vs XLA")


@pytest.mark.parametrize("hw", [(12, 20), (19, 37)], ids=["even", "odd_grid"])
def test_up_block_bf16_matches_pallas(hw):
    """Kernel B's plain version against _up_block_kernel at bf16: the JAX
    packed Up block at pack factor 2 (the skip packed at 2, the coarse
    input at 1), unpacked."""
    rng = np.random.default_rng(33)
    h, w = hw
    c1, cs, cm = 16, 8, 8
    p, bn = _up_params(rng, c1, cs, cm)
    x1 = rng.normal(size=(1, h, w, c1)).astype(np.float32)
    x2 = rng.normal(size=(1, 2 * h, 2 * w, cs)).astype(np.float32)
    ref = K._packed_up(_jax(p), _jax(bn), jnp.asarray(x1), K.pack(jnp.asarray(x2), 2), 2,
                       c_skip=cs, dtype=JBF16, use_pallas=True)
    ref = K.unpack(ref, 2, cm)
    got = ub.up_block(to_torch(p), to_torch(bn), torch.from_numpy(x1), torch.from_numpy(x2), BF16)
    assert got.dtype == BF16
    assert_block_close(got, ref, "up_block vs Pallas")


def test_up_block_bf16_odd_skip_matches_xla():
    """An odd skip (pad_to_match): the trainable composition against the
    JAX XLA block at the block bound, kernel B's plain version (which
    rounds in fewer places) at the XLA-route correlation."""
    rng = np.random.default_rng(34)
    p, bn = _up_params(rng, 16, 8, 8)
    x1 = rng.normal(size=(1, 9, 18, 16)).astype(np.float32)
    x2 = rng.normal(size=(1, 19, 37, 8)).astype(np.float32)
    ref = junet._up_block(_jax(p), _jax(bn), jnp.asarray(x1), jnp.asarray(x2), JBF16)
    tp, tbn, t1, t2 = to_torch(p), to_torch(bn), torch.from_numpy(x1), torch.from_numpy(x2)
    assert_block_close(ub.up_block_ops(tp, tbn, t1, t2, BF16), ref, "up_block_ops vs XLA")
    got = ub.up_block(tp, tbn, t1, t2, BF16)
    assert got.shape == (1, 19, 37, 8) and got.dtype == BF16
    assert_maps_close(got, ref, CORR_XLA, "up_block vs XLA")


def test_head_bf16_matches_fused_packed_head():
    """Kernel C's channel-0 plain version on bf16 features against the
    packed head's _blockdiag_kernel_cdt (flat, the eval fold's) at bf16."""
    rng = np.random.default_rng(35)
    head = init_head(3, biasinit=0.9407)
    feats = np.abs(rng.normal(size=(2, 16, 24, 16))).astype(np.float32)
    f = 4
    jf = jnp.asarray(feats)
    fp = jnp.concatenate([K.pack(jf[..., :8], f), K.pack(jf[..., 8:], f)], axis=-1)
    jhead = {k: {kk: jnp.asarray(v.numpy()) for kk, v in d.items()} for k, d in head.items()}
    out = fused_packed_head(jhead, fp, f, JBF16, two_stream=True, flat=True)
    assert out.dtype == JBF16
    ref = K.unpack_scalar(out.reshape(2, 16 // f, 24 // f, f * f), f)
    got = hd.head_apply(head, torch.from_numpy(feats).to(BF16), n_out=1)[..., 0]
    assert got.dtype == BF16
    assert_block_close(got, ref, "head vs fused_packed_head")


def test_head_train_takes_bf16_features_in_float32():
    """The training head is float32 whatever the features' dtype
    (fused_head): the same output and weight gradients as on the widened
    features, and dx comes back in bf16."""
    rng = np.random.default_rng(36)
    head = init_head(4, biasinit=0.9407)
    fb = torch.from_numpy(rng.normal(size=(1, 8, 8, 16)).astype(np.float32)).to(BF16)
    outs = []
    for x in (fb.clone().requires_grad_(True), fb.float().requires_grad_(True)):
        wts = {k: {kk: v.clone().requires_grad_(True) for kk, v in d.items()} for k, d in head.items()}
        out = hd.head_train(wts, x)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        outs.append((out, x.grad, wts["l1"]["w"].grad))
    (o_b, dx_b, dw_b), (o_f, dx_f, dw_f) = outs
    assert o_b.dtype == torch.float32 and dx_b.dtype == BF16
    assert torch.equal(o_b, o_f) and torch.equal(dw_b, dw_f)
    assert torch.equal(dx_b, dx_f.to(BF16))


# ------------------------------------------------------------------ streams


def test_unet_stream_bf16_matches_jax_streams():
    """One member stream (kernels A and B's plain versions) against the
    JAX packed stream at bf16 with every block a Pallas kernel, and
    against its XLA blocks."""
    params, consts = init_popcorn(jax.random.PRNGKey(2), JModelConfig(pretrained=False))
    jp, jbn = params["unet"]["sar"], consts["unet_bn"]["sar"]
    x = np.random.default_rng(37).normal(size=(1, 64, 96, 2)).astype(np.float32)
    f = 4
    xp = K.pack(jnp.asarray(x), f)
    got = unet.unet_stream(to_torch(jax.tree.map(np.asarray, jp)),
                           to_torch(jax.tree.map(np.asarray, jbn)), torch.from_numpy(x), dtype=BF16)
    assert got.dtype == BF16
    for use_pallas, corr in ((True, CORR_PALLAS), (False, CORR_XLA)):
        ref = K.unpack(K.packed_unet_stream(jp, jbn, xp, f, dtype=JBF16, use_pallas=use_pallas), f, 8)
        assert_maps_close(got, ref, corr, f"stream vs JAX (pallas={use_pallas})")


def test_dynamic_int8_wrappers_round_bf16_as_jax():
    """Kernels G and H read and write float32: at bf16 the wrappers widen
    the input and round the output, exactly the float32 result rounded."""
    params, consts = init_popcorn(jax.random.PRNGKey(5), JModelConfig(pretrained=False))
    tp = to_torch(jax.tree.map(np.asarray, params["unet"]["sar"]))
    tbn = to_torch(jax.tree.map(np.asarray, consts["unet_bn"]["sar"]))
    rng = np.random.default_rng(38)
    x = torch.from_numpy(np.abs(rng.normal(size=(1, 32, 48, 8))).astype(np.float32)).to(BF16)
    x1 = torch.from_numpy(np.abs(rng.normal(size=(1, 16, 24, 16))).astype(np.float32)).to(BF16)
    got = dc.double_conv_q(tp["down1"], tbn["down1"], x)
    assert got.dtype == BF16
    assert torch.equal(got, dc.double_conv_q(tp["down1"], tbn["down1"], x.float()).to(BF16))
    x2 = torch.from_numpy(np.abs(rng.normal(size=(1, 32, 48, 16))).astype(np.float32)).to(BF16)
    got = ub.up_block_q(tp["up2"], tbn["up2"], x1, x2)
    assert got.dtype == BF16
    assert torch.equal(got, ub.up_block_q(tp["up2"], tbn["up2"], x1.float(), x2.float()).to(BF16))
    # the static stream quantizes its float32 input and rounds only its
    # float features
    xs = torch.from_numpy(rng.normal(size=(1, 32, 48, 2)).astype(np.float32))
    s = quant.calibrate_stream(tp, tbn, xs)
    f32 = unet.unet_stream_qs(tp, tbn, xs, s)
    assert torch.equal(unet.unet_stream_qs(tp, tbn, xs, s, dtype=BF16), f32.to(BF16))


# --------------------------------------------------------------- eval fold

PATCH, OVERLAP = 96, 16


def _dataset(cls, paths, patch=PATCH):
    return cls(paths, "rwa", mode="test", patchsize=patch, overlap=OVERLAP,
               fourseasons=False, train_level="coarse")


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    """test_torch_eval.py's synthetic 192x256 region and two .pth members
    (the repo's DDA weights, seeded heads)."""
    root = str(tmp_path_factory.mktemp("bf16_data"))
    paths = j_make(root, "rwa", height=192, width=256, seed=21)
    mdir = tmp_path_factory.mktemp("bf16_members")
    cks = []
    for i in range(2):
        params, consts = load_popcorn_from_dda(JModelConfig(biasinit=0.9407),
                                               head_key=jax.random.PRNGKey(50 + i))
        cks.append(str(mdir / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    return paths, cks


def _port_run(paths, cks, mcfg, patch=PATCH):
    tm = [load_member(p) for p in cks]
    return run_sliding_inference([m[0] for m in tm], tm[0][1], mcfg,
                                 _dataset(PopulationDataset, paths, patch), device="cpu")


def _jax_run(paths, cks, jmcfg, patch=PATCH):
    jm = [j_load_member(p) for p in cks]
    return j_run([m[0] for m in jm], jm[0][1], jmcfg, _dataset(JDataset, paths, patch))


def test_sliding_inference_bf16_matches_jax(region):
    """The bf16 fold against the JAX package's: its default fold (XLA
    blocks and head) and its Pallas route (pallas_stream=True: every UNet
    block, the builder's too, and the packed head as Pallas kernels)."""
    paths, cks = region
    got = _port_run(paths, cks, ModelConfig(compute_dtype="bfloat16"))
    assert got["map"].max() > 0
    for ps, corr, rel in ((None, CORR_XLA, None), (True, CORR_PALLAS, REL_L2)):
        ref = _jax_run(paths, cks, JModelConfig(compute_dtype="bfloat16", pallas_stream=ps))
        for k in ("map", "scale"):
            assert_maps_close(got[k], ref[k], corr, f"{k} (pallas_stream={ps})", rel)
        np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))


def test_evaluator_bf16_census_matches_jax(region):
    """Census metrics of the bf16 Evaluator against the JAX package's on
    its Pallas route."""
    paths, cks = region
    jmcfg = JModelConfig(compute_dtype="bfloat16", pallas_stream=True)
    jev = JEvaluator(paths, jmcfg, JEvalConfig(checkpoints=tuple(cks)))
    jev.datasets = [_dataset(JDataset, paths)]
    ref = jev.test_target(save=False)
    ev = Evaluator(paths, ModelConfig(compute_dtype="bfloat16"), EvalConfig(checkpoints=tuple(cks)),
                   device="cpu")
    ev.datasets = [_dataset(PopulationDataset, paths)]
    out = ev.test_target(save=False)
    r2 = [k for k in ref if k.endswith("/r2")]
    assert r2 and out.keys() == ref.keys()
    for k in r2:
        assert abs(out[k] - ref[k]) <= R2_TOL, (k, out[k], ref[k])
    assert out["Population_AdjCensus_rwa_coarse/r2"] > 0.9


def test_int8s_fold_bf16_matches_jax(region, monkeypatch):
    """The static int8 fold at bf16 (patch 100: both packages quantize)
    runs kernels E/F's plain versions and matches JAX's int8s at bf16
    (``pallas_stream=True``: its builder rounds as the port's kernels do,
    not after every op)."""
    paths, cks = region
    calls = []
    orig = dc.double_conv_qs_plain
    monkeypatch.setattr(dc, "double_conv_qs_plain", lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _port_run(paths, cks, ModelConfig(compute_dtype="bfloat16", quantize="int8s"), 100)
    ref = _jax_run(paths, cks, JModelConfig(compute_dtype="bfloat16", quantize="int8s",
                                            pallas_stream=True), 100)
    assert calls
    a, b = np.asarray(ref["map"]).ravel(), got["map"].ravel()
    assert np.corrcoef(a, b)[0, 1] > INT8S_CORR
    np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))


# ------------------------------------------------------------------ training


def _batch(b, h, w, seed):
    rng = np.random.default_rng(seed)
    idx = np.arange(1, b + 1, dtype=np.float32)
    return {
        "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
        "admin_mask": np.where(rng.random((b, h, w)) < 0.7, idx[:, None, None], -1.0).astype(np.float32),
        "census_idx": idx,
        "y": rng.uniform(10, 1000, (b,)).astype(np.float32),
        "photometric": np.asarray([1.0, 0.9, 1.0, 1.1], np.float32),
    }


def _jax_mask(jconsts, batch, key):
    """The sparsity mask the JAX step draws from ``key`` (its bf16
    building score), to hand to the port's step."""
    s2 = j_photometric(jnp.asarray(batch["S2"]), jnp.asarray(batch["photometric"]))
    x = j_normalize({"S2": s2, "S1": jnp.asarray(batch["S1"])}, JNormStats())
    score = j_score(jconsts["builder"], x, s1=True, s2=True, nir=True, layout="plain", dtype=JBF16)
    return np.asarray(j_sparsity_mask(key, score, jnp.asarray(batch["admin_mask"]),
                                      jnp.asarray(batch["census_idx"]), occupancy=True))


@pytest.mark.parametrize("tier", ["full", "encoder_frozen"])
def test_train_step_bf16_matches_jax(tier):
    """One bf16 step (fixed mask) against the JAX step at bf16 (layout
    'plain', fused head): loss and popcount, and all gradient leaves as one
    vector, at the XLA-route bound (JAX's trainable and frozen blocks are
    XLA ops; the port's frozen blocks are kernels)."""
    flags = dict(encoder_no_grad=tier != "full", unet_no_grad=False)
    jmcfg = JModelConfig(pretrained=False, fused_head=True, layout="plain", biasinit=0.9407,
                         compute_dtype="bfloat16")
    jparams, jconsts = init_popcorn(jax.random.PRNGKey(0), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    batch = _batch(2, 64, 64, 2)

    # an optax transformation that applies nothing and keeps the incoming
    # gradients as its state: the JAX step's gradients, exactly
    probe = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    jstep = j_make_train_step(jmcfg, JTrainConfig(), jconsts, JNormStats(), probe)
    key = jax.random.PRNGKey(7)
    _, jgrads, jaux = jstep(jparams, probe.init(jparams), batch, key, **flags)
    mask = _jax_mask(jconsts, batch, key)
    mcfg = ModelConfig(pretrained=False, biasinit=0.9407, compute_dtype="bfloat16")
    step = make_train_step(mcfg, TrainConfig(), consts, NormStats(), make_optimizer(TrainConfig()))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, aux = step.grads(params, tb, mask=torch.from_numpy(mask.copy()), **flags)
    np.testing.assert_allclose(float(aux["optimization_loss"]), float(jaux["optimization_loss"]),
                               rtol=REL_L2)
    assert_maps_close(aux["popcount"], jaux["popcount"], 0.0, "popcount")
    ref = dict(tree_flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(tree_flatten(grads))
    assert got.keys() == ref.keys()
    assert all(g.dtype == torch.float32 for g in got.values())
    keys = sorted(ref, key=str)
    flat_ref = np.concatenate([np.ravel(ref[k]) for k in keys])
    flat_got = np.concatenate([got[k].numpy().ravel() for k in keys])
    assert_maps_close(flat_got, flat_ref, CORR_XLA, f"gradients ({tier})")


# --------------------------------------------------------------------- CLIs


def test_cli_default_compute_dtype_is_bfloat16_as_in_jax():
    from popcorn_tpu.cli.args import eval_parser as j_eval_parser
    from popcorn_tpu.cli.args import train_parser as j_train_parser
    from popcorn_tpu_torch.cli.args import eval_parser, model_config_from_args, train_parser

    for parser, j_parser in ((eval_parser, j_eval_parser), (train_parser, j_train_parser)):
        base = ["-r", "m.pth"] if parser is eval_parser else []
        mcfg = model_config_from_args(parser().parse_args(base))
        assert mcfg.compute_dtype == j_parser().parse_args(base).compute_dtype == "bfloat16"
        check_config(mcfg)
        assert compute_dtype(mcfg) is BF16
        mcfg = model_config_from_args(parser().parse_args([*base, "--compute_dtype", "float32"]))
        assert compute_dtype(mcfg) is None
    assert ModelConfig().compute_dtype == JModelConfig().compute_dtype == "float32"
    with pytest.raises(ValueError, match="compute_dtype"):
        check_config(dataclasses.replace(ModelConfig(), compute_dtype="float16"))

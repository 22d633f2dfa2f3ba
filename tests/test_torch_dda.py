"""DDA extractor training in the port (popcorn_tpu_torch/dda) against the
JAX package's popcorn_tpu/dda on the same numpy-seeded inputs and, where
weights enter, the same JAX-initialised weights carried across
(compat/weights.py::from_jax_dda).

Tolerances: the losses 1e-5 absolute (float32 sums over a few hundred
pixels); batch norm rtol 1e-5 / atol 1e-5; the train forward (two UNet
streams with live batch statistics) rtol 1e-4 / atol 1e-5; one epoch of
training (one step), loss rtol 1e-4 and every updated leaf rtol 1e-4 /
atol 2e-6 (an Adam step moves a leaf by about lr = 1e-4 whatever its
gradient's size, so the bound is 2% of a step; the conv biases before a
BatchNorm apart, see test_trainer_epoch_matches_jax); the augmentations, the sampler and
the copied datasets and metrics bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from popcorn_tpu.dda import losses as JL
from popcorn_tpu.dda.datasets import UrbanExtractionDataset as JDataset
from popcorn_tpu.dda.datasets import labeled_unlabeled_batches as j_batches
from popcorn_tpu.dda.datasets import make_synthetic_dda_manifest
from popcorn_tpu.dda.metrics import morphology_metrics as j_morph
from popcorn_tpu.dda.network import batch_norm as j_batch_norm
from popcorn_tpu.dda.network import dual_stream_train_forward as j_forward
from popcorn_tpu.dda.network import init_bn as j_init_bn
from popcorn_tpu.dda.network import to_frozen_consts as j_frozen
from popcorn_tpu.dda.train import DDAConfig as JDDAConfig
from popcorn_tpu.dda.train import DDATrainer as JDDATrainer
from popcorn_tpu.dda.train import dda_augment as j_augment
from popcorn_tpu.dda.train import model_testing as j_model_testing
from popcorn_tpu.nn.init import init_dual_stream as j_init_dual_stream
from popcorn_tpu_torch.compat.weights import from_jax_dda, load_dda, to_numpy
from popcorn_tpu_torch.dda import losses as L
from popcorn_tpu_torch.dda.datasets import UrbanExtractionDataset, labeled_unlabeled_batches
from popcorn_tpu_torch.dda.datasets import make_synthetic_dda_manifest as t_make_manifest
from popcorn_tpu_torch.dda.metrics import MultiThresholdMetric, morphology_metrics
from popcorn_tpu_torch.dda.network import batch_norm, dual_stream_train_forward, init_bn, to_frozen_consts
from popcorn_tpu_torch.dda.train import DDAConfig, DDATrainer, dda_augment, format_site_report, model_testing
from popcorn_tpu_torch.train.checkpoint import save_dda_checkpoint
from popcorn_tpu_torch.train.state import tree_flatten

torch.set_num_threads(1)
LOSS_ATOL = 1e-5
FWD = dict(rtol=1e-4, atol=1e-5)
LEAF = dict(rtol=1e-4, atol=2e-6)
GRAD_FLOOR = 2e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, ref, **tol):
    ref = dict(tree_flatten(_np_tree(ref)))
    got = dict(tree_flatten(to_numpy(got)))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=str(k), **tol)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dda_data"))
    return make_synthetic_dda_manifest(root, n_labeled=6, n_unlabeled=4, size=32)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised DDA trainer weights (seed 7, as DDATrainer draws
    them) and their port copies."""
    params = j_init_dual_stream(jax.random.PRNGKey(7), (8, 16))
    bn_params, bn_state = j_init_bn((8, 16))
    jw = _np_tree((params, bn_params, bn_state))
    return jw, from_jax_dda(*jw)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("name", sorted(JL._CRITERIA))
def test_criteria_match_jax(name):
    rng = np.random.default_rng(3)
    if name == "CrossEntropyLoss":
        logits = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
        y = (rng.random((2, 8, 8)) > 0.7).astype(np.int32)
        kw = dict(negative_weight=0.3, positive_weight=2.0)
    else:
        logits = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
        y = (rng.random((2, 8, 8, 1)) > 0.7).astype(np.float32)
        kw = {}
    ref = float(JL.get_criterion(name, **kw)(jnp.asarray(logits), jnp.asarray(y)))
    got = float(L.get_criterion(name, **kw)(torch.from_numpy(logits), torch.from_numpy(y)))
    assert abs(got - ref) < LOSS_ATOL, (name, got, ref)


def test_mse_prob_loss_and_unknown_criterion():
    rng = np.random.default_rng(4)
    p, q = rng.random((2, 8, 8, 1)).astype(np.float32), rng.random((2, 8, 8, 1)).astype(np.float32)
    ref = float(JL.mse_prob_loss(jnp.asarray(p), jnp.asarray(q)))
    assert abs(float(L.mse_prob_loss(torch.from_numpy(p), torch.from_numpy(q))) - ref) < LOSS_ATOL
    assert set(L._CRITERIA) == set(JL._CRITERIA)
    with pytest.raises(ValueError, match="unknown loss"):
        L.get_criterion("NoSuchLoss")


# ----------------------------------------------------------------- network


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(train):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 8, 8, 4)) * 3 + 5).astype(np.float32)
    bp = {"gamma": rng.uniform(0.5, 2, 4).astype(np.float32), "beta": rng.normal(size=4).astype(np.float32)}
    bs = {"mean": rng.normal(size=4).astype(np.float32), "var": rng.uniform(0.5, 2, 4).astype(np.float32)}
    y_ref, s_ref = j_batch_norm(jnp.asarray(x), _np_tree(bp), _np_tree(bs), train=train)
    y, s = batch_norm(torch.from_numpy(x), from_jax_dda(bp, {}, {})[0], from_jax_dda(bs, {}, {})[0],
                      train=train)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(s_ref[k]), rtol=1e-5, atol=1e-6)
    if train:
        # F.batch_norm's running-statistics rule: unbiased variance, momentum 0.1
        rm, rv = torch.from_numpy(bs["mean"].copy()), torch.from_numpy(bs["var"].copy())
        torch.nn.functional.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), rm, rv,
                                       training=True, momentum=0.1)
        np.testing.assert_allclose(s["mean"].numpy(), rm.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s["var"].numpy(), rv.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dual_stream_train_forward_matches_jax(weights, train):
    jw, tw = weights
    x = np.random.default_rng(6).normal(size=(2, 32, 40, 6)).astype(np.float32)
    ref = j_forward(*jw, jnp.asarray(x), train=train)
    got = dual_stream_train_forward(*tw, torch.from_numpy(x), train=train)
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)
    _assert_trees_close(got[3], ref[3], **FWD)


def test_to_frozen_consts_matches_jax(weights):
    rng = np.random.default_rng(8)
    _, bp, bs = weights[0]
    bp = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.1).astype(np.float32), bp)
    bs = jax.tree.map(lambda a: (np.abs(a) + rng.uniform(0, 1, a.shape)).astype(np.float32), bs)
    ref = j_frozen(bp, bs)
    got = to_frozen_consts(*from_jax_dda(bp, bs, {})[:2])
    _assert_trees_close(got, ref, rtol=1e-6, atol=1e-7)


def test_init_bn_matches_jax():
    ref, got = j_init_bn((8, 16)), init_bn((8, 16))
    _assert_trees_close(got[0], ref[0], rtol=0, atol=0)
    _assert_trees_close(got[1], ref[1], rtol=0, atol=0)


def test_from_jax_dda_round_trip(weights, tmp_path):
    """JAX trees -> the port's -> numpy equal leaf for leaf; an exported
    extractor saved as a DDA checkpoint loads back as the frozen trees
    that nn/popcorn.py::create_building_score reads."""
    jw, tw = weights
    for ref, got in zip(jw, tw):
        _assert_trees_close(got, ref, rtol=0, atol=0)
        assert all(v.dtype == torch.float32 for _, v in tree_flatten(got))
    params, bn_params, bn_state = tw
    frozen = to_frozen_consts(bn_params, bn_state)
    path = str(tmp_path / "dda.pt")
    save_dda_checkpoint(path, {"unet": params, "unet_bn": frozen})
    p2, bn2 = load_dda(path)
    _assert_trees_close(p2, _np_tree(to_numpy(params)), rtol=0, atol=0)
    _assert_trees_close(bn2, _np_tree(to_numpy(frozen)), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------- data and sampler


@pytest.mark.parametrize("crop", [0, 24])
def test_dda_augment_draws_bit_equal(crop):
    cfg_kw = dict(crop_size=crop)
    x = np.random.default_rng(9).uniform(0, 4000, (32, 32, 6)).astype(np.float32)
    x[..., :2] = -x[..., :2] / 200
    y = (np.random.default_rng(10).random((32, 32)) > 0.8).astype(np.float32)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(6):
        yy = y if i % 2 == 0 else None
        xr, yr = j_augment(jr, x, yy, JDDAConfig(**cfg_kw))
        xg, yg = dda_augment(tr, x, yy, DDAConfig(**cfg_kw))
        assert np.array_equal(xr, xg) and xr.dtype == xg.dtype
        assert (yr is None and yg is None) or np.array_equal(yr, yg)
    assert jr.bit_generator.state == tr.bit_generator.state


def test_labeled_unlabeled_batches_equal(manifest):
    jds, ds = JDataset(manifest), UrbanExtractionDataset(manifest)
    assert (jds.labeled_idx, jds.unlabeled_idx) == (ds.labeled_idx, ds.unlabeled_idx)
    ref = list(j_batches(jds, np.random.default_rng(0), labeled_per_batch=2, unlabeled_per_batch=3))
    got = list(labeled_unlabeled_batches(ds, np.random.default_rng(0), labeled_per_batch=2,
                                         unlabeled_per_batch=3))
    assert len(got) == len(ref) == 3
    for (rl, ru), (gl, gu) in zip(ref, got):
        assert np.array_equal(rl["x"], gl["x"]) and np.array_equal(rl["y"], gl["y"])
        assert np.array_equal(ru["x"], gu["x"])


def test_synthetic_manifest_and_metrics_copies_match(tmp_path, manifest):
    """The copied modules: the synthetic manifest writes the same tiles,
    and the metrics give the same numbers."""
    mine = t_make_manifest(str(tmp_path / "m"), n_labeled=6, n_unlabeled=4, size=32)
    a, b = JDataset(manifest), UrbanExtractionDataset(mine)
    for i in range(len(a)):
        ra, rb = a[i], b[i]
        assert np.array_equal(ra["x"], rb["x"]) and ra["site"] == rb["site"]
        assert ("y" in ra) == ("y" in rb) and ("y" not in ra or np.array_equal(ra["y"], rb["y"]))
    rng = np.random.default_rng(12)
    t = (rng.random((24, 24)) > 0.6).astype(np.float32)
    p = np.clip(t * 0.7 + rng.random((24, 24)) * 0.5, 0, 1)
    assert morphology_metrics(t, p) == pytest.approx(j_morph(t, p), nan_ok=True, rel=1e-12)
    m = MultiThresholdMetric(np.linspace(0, 1, 11))
    m.add_sample(t, p)
    from popcorn_tpu.dda.metrics import MultiThresholdMetric as JMetric

    jm = JMetric(np.linspace(0, 1, 11))
    jm.add_sample(t, p)
    assert m.best() == jm.best()


# ------------------------------------------------------------------- training


def test_adamw_matches_optax_adamw():
    """torch.optim.AdamW(lr, (0.9, 0.999), 1e-8, weight_decay=0.01) against
    optax.adamw(lr, weight_decay=0.01) over five steps of seeded
    gradients, on leaves whose gradients span six decades."""
    rng = np.random.default_rng(13)
    p0 = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    grads = [[(rng.normal(size=a.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32) for a in p0]
             for _ in range(5)]
    tx = optax.adamw(1e-3, weight_decay=0.01)
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    tp = [torch.from_numpy(a.copy()).requires_grad_(True) for a in p0]
    opt = torch.optim.AdamW(tp, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for t, a in zip(tp, g):
            t.grad = torch.from_numpy(a)
        opt.step()
    for t, a in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def _trainers(manifest, weights, **cfg):
    jtr = JDDATrainer(manifest, JDDAConfig(**cfg))
    jtr.params, jtr.bn_params, jtr.bn_state = jax.tree.map(jnp.asarray, weights[0])
    jtr.opt_state = jtr.tx.init((jtr.params, jtr.bn_params))
    return jtr, DDATrainer(manifest, DDAConfig(**cfg), device="cpu", init=weights[1])


def _pre_bn_bias(path) -> bool:
    """A DoubleConv's conv bias: a training-mode BatchNorm follows it and
    removes it, so its gradient is zero in exact arithmetic."""
    return path[-1] == "b" and path[-2] in ("conv1", "conv2")


def test_trainer_epoch_matches_jax(manifest, weights):
    """One epoch without augmentation in each package from the same
    weights: lr 1e-4, the 6 labeled samples and 2 unlabeled in one batch,
    so one optimizer step, the AdamW check. Adam moves an element by
    about lr * sign(g), so where the float32 gradient is rounding noise its
    sign, and the move, are noise in either package. Such elements are
    held apart, and both packages must move them by at most lr: the
    DoubleConvs' conv biases, whose gradients a training-mode BatchNorm
    cancels (~1e-9 here, near Adam's eps), and elements whose gradient
    (the port's, in the same step) is at most GRAD_FLOOR, where float32
    sums of cancelling terms leave the sign to rounding (gradients up to
    6e-7 take opposite signs in the two packages on this batch, against
    leaves' largest of 2e-4 to 0.2; 560 of 29,571 elements are held
    apart). test_adamw_matches_optax_adamw holds five steps of the update
    rule itself."""
    lr = 1e-4
    jtr, tr = _trainers(manifest, weights, labeled_per_batch=6, unlabeled_per_batch=2, lr=lr)
    jloss, loss = jtr.train_epoch(augment=False), tr.train_epoch(augment=False)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    held_apart = 0
    for jtree, ttree, init in ((jtr.params, tr.params, weights[0][0]),
                               (jtr.bn_params, tr.bn_params, weights[0][1])):
        ref, got = dict(tree_flatten(_np_tree(jtree))), dict(tree_flatten(to_numpy(ttree)))
        grad = {k: v.grad.numpy() for k, v in tree_flatten(ttree)}
        assert got.keys() == ref.keys()
        for k, p0 in tree_flatten(init):
            g = np.abs(grad[k])
            noise = np.ones_like(g, bool) if _pre_bn_bias(k) else g <= GRAD_FLOOR
            for moved in (ref[k] - p0, got[k] - p0):
                assert np.abs(moved[noise]).max(initial=0) <= lr * 1.01, k  # lr, weight decay
            np.testing.assert_allclose(got[k][~noise], ref[k][~noise], err_msg=str(k), **LEAF)
            held_apart += int(noise.sum()) if not _pre_bn_bias(k) else 0
    assert held_apart < 0.03 * sum(a.size for _, a in tree_flatten(weights[0][0]))
    _assert_trees_close(tr.bn_state, jtr.bn_state, **FWD)
    moved = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                zip(tree_flatten(to_numpy(tr.params)), tree_flatten(weights[0][0])))
    assert moved > 0.5e-4  # one Adam step moves a leaf by about lr
    assert jtr._rng.bit_generator.state == tr._rng.bit_generator.state


def test_evaluate_model_testing_and_export_match_jax(manifest, weights):
    """evaluate, model_testing and export_for_popcorn of both packages'
    trainers on the same (carried) weights and running statistics."""
    rng = np.random.default_rng(15)
    jw = jax.tree.map(lambda a: a, weights[0])
    jw = (jw[0], jw[1], jax.tree.map(lambda a: (a + rng.uniform(0, 0.5, a.shape)).astype(np.float32),
                                     jw[2]))
    jtr, tr = _trainers(manifest, (jw, from_jax_dda(*jw)))
    ref, got = jtr.evaluate(), tr.evaluate()
    assert got.keys() == ref.keys()
    assert got == pytest.approx(ref, rel=1e-4, abs=1e-4)
    jrep = j_model_testing(jtr.params, jtr.bn_params, jtr.bn_state, jtr.ds)
    rep = model_testing(tr.params, tr.bn_params, tr.bn_state, tr.ds)
    assert rep.keys() == jrep.keys() == {"a", "b", "test"}
    for site in rep:
        for head in rep[site]:
            assert rep[site][head] == pytest.approx(jrep[site][head], rel=1e-4, abs=1e-4,
                                                    nan_ok=True), (site, head)
    assert "fusion" in format_site_report(rep)
    jp, jbn = jtr.export_for_popcorn()
    p, bn = tr.export_for_popcorn()
    _assert_trees_close(p, jp, rtol=0, atol=0)
    _assert_trees_close(bn, jbn, rtol=1e-6, atol=1e-7)
    assert not any(v.requires_grad for _, v in tree_flatten(p))


def test_dda_cli_on_the_cpu(tmp_path, capsys):
    """python -m popcorn_tpu_torch.cli.dda_train on a tiny manifest with
    --device cpu: per-epoch losses, the eval line, the per-site report, and
    a checkpoint that loads into the port's building extractor."""
    from popcorn_tpu_torch.cli import dda_train
    from popcorn_tpu_torch.nn.popcorn import create_building_score

    m = t_make_manifest(str(tmp_path / "d"), n_labeled=4, n_unlabeled=2, size=32)
    out = str(tmp_path / "dda.pt")
    dda_train.main(["--manifest", m, "--epochs", "2", "--labeled-per-batch", "2",
                    "--unlabeled-per-batch", "1", "--out", out, "--test", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "epoch 1: loss" in text and "eval:" in text and "boundary_iou" in text
    assert os.path.exists(out)
    params, bn = load_dda(out)
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(1, 32, 32, 6)).astype(np.float32))
    score = create_building_score({"params": params, "bn": bn}, x, s1=True, s2=True, nir=True)
    assert score.shape == (1, 32, 32) and bool(((score >= 0) & (score <= 1)).all())
    if not torch.cuda.is_available():  # the default device is the card: no silent CPU run
        with pytest.raises(RuntimeError, match="CUDA"):
            dda_train.main(["--manifest", m, "--epochs", "1", "--out", out])

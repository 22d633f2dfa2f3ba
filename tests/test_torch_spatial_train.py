"""Spatial training (--spatial_train): one crop's rows over two gloo CPU
ranks (dist/mesh.py::shard_batch_spatial, dist/rows.py, train/state.py's
row blocks, the trainer and the train CLI), against the JAX package's
make_train_step on its 8-device CPU mesh (shard_batch_spatial) and on one
device, and against the port's one-rank step, on the same numpy-seeded
crops and the same JAX-initialised weights (compat/weights.py::from_jax).

One spawn of two ranks for the whole module (its fixture runs
tests/torch_rank_suites.py::spatial_train_suite); each test reads what the
ranks wrote. Tolerances: the JAX test's own for a row-sharded step against
one device (tests/test_spatial.py:210-217: loss rtol 1e-5, parameters
rtol 1e-4 / atol 1e-7) between the port's ranks and its one rank, with
the gradients at tests/test_torch_train_step.py's bound (rtol 1e-4, atol
1e-4 max|leaf|). Against the JAX package's step (row-sharded on its mesh,
or on one device): the loss and popcount at rtol 1e-5. The gradients and
stepped parameters of these 2e4-pixel crops are not held to the JAX
package's here: the port's one-rank step already differs from the JAX
step by up to 3.2e-4 norm-relative in a gradient leaf (the 300-row crop),
and Adam's first step, lr g / (|g| + eps), turns that into up to 1.5e-5
on a parameter whose gradient is near zero; tests/test_torch_train_step.py
holds the one-rank gradients to the JAX step's on 2x64x64."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.config import TrainConfig as JTrainConfig
from popcorn_tpu.data.normalize import NormStats as JNormStats
from popcorn_tpu.data.normalize import normalize_and_assemble as j_normalize
from popcorn_tpu.data.normalize import photometric_s2_traced as j_photometric
from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh
from popcorn_tpu.dist.mesh import shard_batch_spatial as j_shard_batch_spatial
from popcorn_tpu.nn.init import init_popcorn as j_init
from popcorn_tpu.nn.popcorn import create_building_score as j_score
from popcorn_tpu.nn.popcorn import sparsity_mask as j_sparsity_mask
from popcorn_tpu.train.state import make_optimizer as j_make_optimizer
from popcorn_tpu.train.state import make_train_step as j_make_train_step
from popcorn_tpu_torch.compat.weights import from_jax, load_popcorn_checkpoint
from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
from popcorn_tpu_torch.data.device_weaksup import Ineligible
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.dist.launch import spawn_ranks
from popcorn_tpu_torch.dist.mesh import shard_batch_spatial
from popcorn_tpu_torch.dist.rows import rank_rows
from popcorn_tpu_torch.nn.popcorn import sparsity_mask
from popcorn_tpu_torch.train.state import tree_flatten
from popcorn_tpu_torch.train.trainer import Trainer
from torch_rank_suites import CPU2, ROW_KEYS, spatial_step, spatial_train_suite, train_losses

torch.set_num_threads(1)
# tests/test_spatial.py:210-217, a row-sharded step against one device
SPATIAL_LOSS_RTOL = 1e-5
SPATIAL_PARAMS = dict(rtol=1e-4, atol=1e-7)
KEY = 5
TRAINER = dict(target_regions=[], target_regions_train=["rwa"], train_level=["coarse"],
               num_epochs=1, weak_batch_size=1, bucket_ladder=[128, 256, 512], logstep_train=1,
               seed=1600, max_samples=2, num_workers=1)
TRAIN_CLI_FLAGS = ["-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa", "-occmodel",
                   "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse",
                   "--compute_dtype", "float32", "-e", "1", "-lt", "1", "-ms", "2", "-wb", "1",
                   "-w", "1", "--spatial_train", "--device", "cpu"]
# the crops: (a) 320 rows, tall enough that each rank's context ends inside
# the crop; (b) 300 rows, which the reference pads by reflection and which
# splits into blocks of 152 and 148 rows; (c) a sparsity mask drawn on the
# ranks against the one-rank draw of the same generator seed
CROPS = {"a": (320, 4), "b": (300, 5), "c": (320, 6)}
STEPS = {"a": "a", "b": "b", "c": None}


def _crop(h, seed, w=64):
    """One crop whose admin mask holds two census ids in irregular parts
    and pads elsewhere; its sample is census id 1."""
    rng = np.random.default_rng(seed)
    u = rng.random((1, h, w))
    admin = np.where(u < 0.6, 1.0, np.where(u < 0.8, 2.0, -1.0)).astype(np.float32)
    return {
        "S2": rng.uniform(0, 4000, (1, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (1, h, w, 2)).astype(np.float32),
        "admin_mask": admin,
        "census_idx": np.ones((1,), np.float32),
        "y": np.asarray([400.0], np.float32),
        "photometric": np.asarray([1.0, 0.9, 1.0, 1.1], np.float32),
    }


def _jax_mask(jconsts, batch):
    """The sparsity mask the JAX step draws from PRNGKey(KEY)."""
    s2 = j_photometric(jnp.asarray(batch["S2"]), jnp.asarray(batch["photometric"]))
    x = j_normalize({"S2": s2, "S1": jnp.asarray(batch["S1"])}, JNormStats())
    score = j_score(jconsts["builder"], x, s1=True, s2=True, nir=True, layout="plain")
    return np.asarray(j_sparsity_mask(jax.random.PRNGKey(KEY), score,
                                      jnp.asarray(batch["admin_mask"]),
                                      jnp.asarray(batch["census_idx"]), occupancy=True))


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_train")
    jmcfg = JModelConfig(pretrained=False, fused_head=False, layout="plain", biasinit=0.9407)
    jparams, jconsts = j_init(jax.random.PRNGKey(0), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    crops = {n: _crop(h, seed) for n, (h, seed) in CROPS.items()}
    masks = {n: _jax_mask(jconsts, crops[n]) for n in ("a", "b")}
    for n, c in crops.items():
        np.savez(root / f"crop_{n}.npz", **c)
    torch.save({"params": params, "consts": consts,
                "masks": {n: torch.from_numpy(m.copy()) for n, m in masks.items()}},
               str(root / "state.pt"))
    spec = {"steps": STEPS, "trainer": TRAINER, "train_data": str(root / "train")}
    make_synthetic_region(spec["train_data"], "rwa", height=256, width=384, n_regions=(3, 4),
                          seed=11)
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    spawn_ranks(spatial_train_suite, 2, (str(root),), devices=CPU2)
    ranks = [torch.load(str(root / f"spatial_train_{r}.pt"), weights_only=False) for r in range(2)]
    return SimpleNamespace(root=root, spec=spec, jmcfg=jmcfg, jparams=jparams, jconsts=jconsts,
                           params=params, consts=consts, crops=crops, masks=masks, ranks=ranks)


def _assert_params(got, ref, **tol):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(r), err_msg=str(k), **tol)


def _numpy(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _assert_jax_step(sp, got, batch, mesh=None):
    """The port's step against the JAX step (row-sharded over ``mesh``, or
    on one device): loss and popcount at rtol 1e-5."""
    tcfg = JTrainConfig()
    opt = j_make_optimizer(tcfg)
    step = j_make_train_step(sp.jmcfg, tcfg, sp.jconsts, JNormStats(), opt)
    if mesh is not None:
        batch = j_shard_batch_spatial(batch, mesh, row_keys=("S2", "S1", "admin_mask"))
    _, _, aux = step(sp.jparams, opt.init(sp.jparams), batch, jax.random.PRNGKey(KEY))
    np.testing.assert_allclose(got[0], float(aux["optimization_loss"]), rtol=SPATIAL_LOSS_RTOL)
    np.testing.assert_allclose(got[1], np.asarray(aux["popcount"]), rtol=SPATIAL_LOSS_RTOL)


def test_two_rank_step_matches_jax_row_sharded_step(spatial):
    """tests/test_spatial.py::test_spatial_train_step_matches_single_device:
    the port's step with the 320-row crop's rows over two ranks (each
    rank's context clipped inside the crop) against the JAX step with the
    crop's rows sharded over its 8-device mesh, JAX's mask injected."""
    got = spatial.ranks[0]["a"]
    _assert_jax_step(spatial, got, spatial.crops["a"], j_make_mesh(8))
    # each rank logs the crop's loss and popcount, summed over both ranks'
    # rows, and holds the same summed gradients
    other = spatial.ranks[1]["a"]
    assert other[0] == got[0]
    np.testing.assert_array_equal(other[1], got[1])
    for k, g in got[2].items():
        assert torch.equal(g, other[2][k]), k


def test_unequal_blocks_with_reflect_rows_match_jax_single_device(spatial):
    """A 300-row crop: the reference reflect-pads it to 320 rows, which
    only the two ranks' crop edges see, and its rows split 152/148. The
    two-rank step against the JAX single-device step."""
    blocks = [spatial.ranks[r]["row_block_b_" + str(r)] for r in range(2)]
    assert blocks == [(300, 0, 152, 0, 280), (300, 152, 300, 24, 300)]
    _assert_jax_step(spatial, spatial.ranks[0]["b"], spatial.crops["b"])


@pytest.mark.parametrize("name", ["a", "b", "c"])
def test_two_rank_step_matches_one_rank(spatial, name):
    """The two ranks' step against the port's one-rank step, at the JAX
    test's bounds for a row-sharded step: with the injected mask (a, b),
    and with the mask drawn on each rank from the same generator seed as
    the one rank's (c), so each rank's lattice rows are the one rank's."""
    loss, pop, grads, params = spatial.ranks[0][name]
    mask = None if STEPS[name] is None else torch.from_numpy(spatial.masks[name].copy())
    one_loss, one_pop, one_grads, one_params = spatial_step(
        None, spatial.crops[name], spatial.params, spatial.consts, mask)
    np.testing.assert_allclose(loss, one_loss, rtol=SPATIAL_LOSS_RTOL)
    np.testing.assert_allclose(pop, one_pop, rtol=SPATIAL_LOSS_RTOL)
    assert grads.keys() == one_grads.keys()
    for k, r in _numpy(one_grads).items():
        g = grads[k].numpy()
        if not r.any():  # a leaf without a gradient: zero on the ranks too
            assert not g.any(), k
            continue
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=str(k))
    _assert_params(_numpy(params), _numpy(one_params), **SPATIAL_PARAMS)


def test_spatial_train_epoch(spatial, tmp_path):
    """tests/test_train_e2e.py::test_spatial_train_epoch: the trainer under
    two ranks builds the grid, takes the host feed, uploads each rank's rows
    of the crop (a 'row_block' batch; the memory tiers count the whole
    crop), runs an epoch to finite losses with the replicas equal, and
    matches the one-rank trainer's losses and parameters."""
    recs = [spatial.ranks[r][f"trainer_{r}"] for r in range(2)]
    for r, rec in enumerate(recs):
        assert rec["n_data"] == 2 and rec["feed"] == "host" and rec["same"]
        rows = rank_rows(rec["crop"], SimpleNamespace(n_data=2, data_index=r))
        assert rec["row_block"] == (rec["crop"], rows.k0, rows.k1, rows.u0, rows.u1)
        assert rec["rows"] == rows.u1 - rows.u0
    got = spatial.ranks[0]["trainer"]
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    tcfg = TrainConfig(**TRAINER, spatial_train=True, save_dir=str(tmp_path))
    one = Trainer(DataPaths(spatial.spec["train_data"]), ModelConfig(pretrained=False, biasinit=0.9407),
                  tcfg, inference_patch=128, inference_overlap=16, device="cpu")
    assert one.mesh is None and one.feed_choice == "host"
    one.train_epoch()
    np.testing.assert_allclose(got["losses"], train_losses(one), rtol=SPATIAL_LOSS_RTOL)
    _assert_params(_numpy(got["params"]), _numpy(dict(tree_flatten(one.params))),
                   **SPATIAL_PARAMS)


def test_trainer_device_feed_on_rejects_spatial(spatial, tmp_path):
    """tests/test_device_weaksup.py::test_trainer_device_feed_on_rejects_spatial:
    --device_feed on with --spatial_train raises; it does not fall back to
    the host feed."""
    tcfg = TrainConfig(target_regions=(), target_regions_train=("rwa",), train_level=("coarse",),
                       spatial_train=True, device_feed="on", save_dir=str(tmp_path))
    with pytest.raises(Ineligible, match="spatial"):
        Trainer(DataPaths(spatial.spec["train_data"]), ModelConfig(pretrained=False), tcfg,
                inference_patch=128, inference_overlap=16, device="cpu")


def test_train_cli_spatial_two_ranks_only_rank0_writes(spatial, tmp_path):
    """The train CLI with --spatial_train --data_parallel 2 --device cpu
    spawns two gloo ranks: rank 0 alone writes the one experiment folder,
    with the one-rank CLI's files, finite losses equal to the one-rank
    CLI's and its checkpoint at the sharded step's bound."""
    from popcorn_tpu_torch.cli import train as train_cli

    runs = {}
    for name, extra in (("one", []), ("sp", ["--data_parallel", "2"])):
        out = str(tmp_path / name)
        got = train_cli.main(["--data_root", spatial.spec["train_data"], *TRAIN_CLI_FLAGS,
                              "--save_dir", out, *extra])
        assert (got is None) == bool(extra)  # the parent of the spawned ranks
        (folder,) = os.listdir(out)
        runs[name] = os.path.join(out, folder)
    assert sorted(os.listdir(runs["sp"])) == sorted(os.listdir(runs["one"]))
    losses = train_losses(SimpleNamespace(experiment_folder=runs["sp"]))
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(
        losses, train_losses(SimpleNamespace(experiment_folder=runs["one"])), rtol=SPATIAL_LOSS_RTOL)
    got, ref = (dict(tree_flatten(load_popcorn_checkpoint(os.path.join(runs[n], "last_model.pth"))[0]))
                for n in ("sp", "one"))
    _assert_params(_numpy(got), _numpy(ref), **SPATIAL_PARAMS)


def test_spatial_train_without_a_card_raises(monkeypatch):
    """Asked for the card (the CLI's default device) where there is none,
    --spatial_train raises before it spawns or trains; it never runs on
    the CPU in silence."""
    from popcorn_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--spatial_train"])


@pytest.mark.parametrize("h,n", [(320, 2), (300, 2), (2304, 2), (36, 4), (100, 8), (64, 1)])
def test_row_blocks_tile_the_crop(h, n):
    """dist/rows.py::rank_rows and shard_batch_spatial: the blocks cover
    the crop once, in rank order, each starts on a multiple of 4, holds at
    most ceil(h / 4n) * 4 rows (the last ones fewer, or none) and reads two
    halos of context each side clipped to the crop; a frame whose height is
    a multiple of 4n splits evenly, as the whole-frame eval's always did."""
    per = -(-h // (4 * n)) * 4
    batch = {"S2": np.zeros((1, h, 8, 4), np.float32), "admin_mask": np.zeros((1, h, 8), np.float32),
             "census_idx": np.ones(1, np.float32), "photometric": np.ones(4, np.float32)}
    end = 0
    for d in range(n):
        mesh = SimpleNamespace(n_data=n, data_index=d)
        rows = rank_rows(h, mesh)
        assert rows.k0 == end and rows.k0 % 4 == 0 and rows.k1 - rows.k0 <= per
        assert (rows.u0, rows.u1) == (max(0, rows.k0 - 128), min(h, rows.k1 + 128))
        if h % (4 * n) == 0:
            assert rows.k1 - rows.k0 == h // n
        end = rows.k1
        got = shard_batch_spatial(batch, mesh, row_keys=ROW_KEYS)
        if n == 1:
            assert got is batch
            continue
        assert got["row_block"] == (h, rows.k0, rows.k1, rows.u0, rows.u1)
        assert got["S2"].shape[1] == got["admin_mask"].shape[1] == rows.u1 - rows.u0
        assert got["census_idx"] is batch["census_idx"] and got["photometric"] is batch["photometric"]
    assert end == h
    assert shard_batch_spatial(batch, None, row_keys=ROW_KEYS) is batch


def test_blocks_of_the_sparsity_mask_are_the_one_device_mask():
    """sparsity_mask(rows=): each block's lattice is drawn over the whole
    crop from the same generator state, rows then columns, so the blocks
    together are the one-device mask."""
    rng = np.random.default_rng(0)
    h, w = 300, 96
    admin = torch.from_numpy(np.where(rng.random((2, h, w)) < 0.7, 1.0, 2.0).astype(np.float32))
    idx = torch.tensor([1.0, 2.0])
    bc = torch.from_numpy(rng.random((2, h, w)).astype(np.float32)) - 0.5
    kw = dict(occupancy=True)
    whole = sparsity_mask(torch.Generator().manual_seed(9), bc, admin, idx, **kw)
    parts = []
    for k0, k1 in ((0, 152), (152, 300), (300, 300)):
        parts.append(sparsity_mask(torch.Generator().manual_seed(9), bc[:, k0:k1], admin[:, k0:k1],
                                   idx, rows=(h, k0, k1), **kw))
    assert torch.equal(torch.cat(parts, 1), whole)

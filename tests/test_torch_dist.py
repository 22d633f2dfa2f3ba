"""The port's rank layer and ranked paths (popcorn_tpu_torch/dist/,
infer/sliding.py(mesh=), train/trainer.py's data parallelism,
DeviceWeaksupFeed(mesh=), pop_timeseries(mesh=)) on two gloo CPU ranks,
against the JAX package's functions on its 8-virtual-device CPU mesh and
against the port's single-rank runs, on the same numpy-seeded inputs and
weights (the JAX package's, carried by compat/weights.py).

One spawn of two ranks for the whole module (its fixture runs
tests/torch_rank_suites.py::dist_suite); each test reads what the ranks
wrote. Tolerances are the JAX tests' own (tests/test_multichip.py,
tests/test_multihost_procs.py) for a sharded run against a single-device
run; the port against the JAX package on the same inputs takes the port's
established bound where the engines differ (MAP_TOL, tests/
test_torch_eval.py; the step at tests/test_torch_train_step.py's). The
ranks add their patches' maps in another order than one device, so a std
map, the square root of a cancelling difference, is held through its
variance (tests/test_torch_eval.py's rule with the JAX std rtol)."""

import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import save_popcorn_checkpoint
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.config import TrainConfig as JTrainConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.normalize import NormStats as JNormStats
from popcorn_tpu.data.normalize import normalize_and_assemble as j_normalize
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.dist.mesh import ensemble_size as j_ensemble_size
from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh
from popcorn_tpu.dist.mesh import make_multihost_mesh as j_make_multihost_mesh
from popcorn_tpu.dist.mesh import replicated as j_replicated
from popcorn_tpu.dist.mesh import shard_batch as j_shard_batch
from popcorn_tpu.dist.multihost import run_demo_eval as j_run_demo_eval
from popcorn_tpu.infer.sliding import run_sliding_inference as j_run
from popcorn_tpu.nn.init import init_popcorn as j_init
from popcorn_tpu.nn.popcorn import create_building_score as j_score
from popcorn_tpu.nn.popcorn import sparsity_mask as j_sparsity_mask
from popcorn_tpu.train.state import make_optimizer as j_make_optimizer
from popcorn_tpu.train.state import make_train_step as j_make_train_step
from popcorn_tpu_torch.compat.weights import from_jax, load_popcorn_checkpoint
from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.feed import WeaksupFeed
from popcorn_tpu_torch.dist import mesh as mesh_mod
from popcorn_tpu_torch.dist.launch import spawn_ranks
from popcorn_tpu_torch.dist.multihost import demo_batch, launch_workers, run_demo_eval, run_demo_step
from popcorn_tpu_torch.infer.pop_timeseries import run_population_timeseries
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from popcorn_tpu_torch.io.geotiff import GeoTIFF
from popcorn_tpu_torch.train.state import tree_flatten
from popcorn_tpu_torch.train.trainer import Trainer
from torch_feed_helpers import uploaded
from torch_rank_suites import CPU2, dist_suite, train_losses

torch.set_num_threads(1)
MAP_TOL = dict(rtol=2e-4, atol=2e-5)
# tests/test_multichip.py: a sharded run against one device
SHARD_MAP = dict(rtol=1e-4, atol=1e-6)
SHARD_STD_RTOL = 1e-3
STEP_PARAMS = dict(rtol=1e-4, atol=1e-6)
TRAINER = dict(target_regions=[], target_regions_train=["rwa"], train_level=["coarse"],
               num_epochs=1, weak_batch_size=4, bucket_ladder=[128, 256], logstep_train=1,
               seed=1600)


def _jax_mask(jconsts, batch, key):
    """The sparsity mask the JAX step draws from ``key``."""
    x = j_normalize({"S2": jnp.asarray(batch["S2"]), "S1": jnp.asarray(batch["S1"])}, JNormStats())
    score = j_score(jconsts["builder"], x, s1=True, s2=True, nir=True, layout="plain")
    return np.asarray(j_sparsity_mask(key, score, jnp.asarray(batch["admin_mask"]),
                                      jnp.asarray(batch["census_idx"]), occupancy=True))


def _assert_std(got, ref, rtol=SHARD_STD_RTOL):
    """std maps through their variance: rtol plus 16 float32 ulps of the
    sum of squares S2 = (n - 1) var + n mean^2."""
    n = np.asarray(ref["count"], np.float64)
    for mean_k, std_k in (("map", "map_std"), ("scale", "scale_std")):
        var_ref = np.asarray(ref[std_k], np.float64) ** 2
        var_got = np.asarray(got[std_k], np.float64) ** 2
        s2 = (n - 1) * var_ref + n * np.asarray(ref[mean_k], np.float64) ** 2
        bound = rtol * var_ref + 16 * np.finfo(np.float32).eps * s2
        assert (np.abs(var_got - var_ref) <= bound).all(), std_k


def _members(root, name, key, n):
    """n .pth members: JAX's init from ``key`` scaled by 1 + 0.01 s."""
    params, consts = j_init(jax.random.PRNGKey(key), JModelConfig(pretrained=False))
    out = []
    for s in range(n):
        out.append(str(root / f"{name}_m{s}.pth"))
        save_popcorn_checkpoint(out[-1], jax.tree.map(lambda a: a * (1.0 + 0.01 * s), params), consts)
    return out


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranked")
    jparams, jconsts = j_init(jax.random.PRNGKey(0), JModelConfig(pretrained=False))
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    mask = _jax_mask(jconsts, demo_batch(), jax.random.PRNGKey(7))
    torch.save({"params": params, "consts": consts, "mask": torch.from_numpy(mask.copy())},
               str(root / "state.pt"))
    spec = {
        "evals": {
            "A": {"data": str(root / "evA"), "members": _members(root, "A", 2, 2), "patch": 96,
                  "overlap": 16, "batch": 8, "meshes": [[2, 1]]},
            "B": {"data": str(root / "evB"), "members": _members(root, "B", 3, 5), "patch": 96,
                  "overlap": 16, "batch": 2, "meshes": [[1, 2], [2, 1]]},
        },
        "feed": str(root / "feed"), "train_data": str(root / "train"), "trainer": TRAINER,
    }
    spec["evals"]["A_int8s"] = dict(spec["evals"]["A"], quantize="int8s")
    j_make(spec["evals"]["A"]["data"], "rwa", height=192, width=256, seed=5)
    j_make(spec["evals"]["B"]["data"], "rwa", height=192, width=256, seed=7)
    j_make(spec["feed"], "rwa", height=256, width=320, seed=7, with_viirs=True, with_buildings=True)
    j_make(spec["train_data"], "rwa", height=192, width=256, n_regions=(3, 4), seed=13)
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    spawn_ranks(dist_suite, 2, (str(root),), devices=CPU2)
    return root, spec, (jparams, jconsts), (params, consts), mask


def test_dp_train_step_matches_jax_sharded_step(ranked):
    """tests/test_multichip.py::test_dp_train_step_matches_single_device:
    the port's step on two data ranks against the JAX step on its
    8-device mesh (same weights, batch and mask) and against the port's
    step on one device."""
    root, _, (jparams, jconsts), _, _ = ranked
    got = torch.load(str(root / "dp_step.pt"))
    tcfg = JTrainConfig(weak_batch_size=8)
    opt = j_make_optimizer(tcfg)
    step = j_make_train_step(JModelConfig(pretrained=False), tcfg, jconsts, JNormStats(), opt)
    mesh = j_make_mesh(8)
    with mesh:
        dev_batch = j_shard_batch(demo_batch(), mesh, batch_keys=("S2", "S1", "admin_mask",
                                                                  "census_idx", "y"))
        rep = j_replicated(mesh)
        p_ref, _, aux = step(jax.device_put(jparams, rep), jax.device_put(opt.init(jparams), rep),
                             dev_batch, jax.random.PRNGKey(7))
    np.testing.assert_allclose(got["loss"], float(aux["optimization_loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["pop"], float(np.asarray(aux["popcount"]).sum()), rtol=1e-5)
    ref = dict(tree_flatten(jax.tree.map(np.asarray, p_ref)))
    assert got["params"].keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got["params"][k].numpy(), r, err_msg=str(k), **STEP_PARAMS)
    one_loss, one_pop, one_params = run_demo_step(None, str(root / "state.pt"), device="cpu")
    np.testing.assert_allclose(got["loss"], one_loss, rtol=1e-5)
    np.testing.assert_allclose(got["pop"], one_pop, rtol=1e-5)
    for k, v in tree_flatten(one_params):
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=str(k),
                                   **STEP_PARAMS)


def _ev_paths(spec, name):
    return DataPaths(spec["evals"][name]["data"])


def _jax_maps(spec, name, mesh=None):
    ev = spec["evals"][name]
    from popcorn_tpu.config import DataPaths as JDataPaths
    from popcorn_tpu.infer.evaluator import load_member as j_load_member

    members = [j_load_member(p) for p in ev["members"]]
    ds = JDataset(JDataPaths(ev["data"]), "rwa", mode="test", patchsize=ev["patch"],
                  overlap=ev["overlap"], fourseasons=False)
    kw = dict(batch_size=ev["batch"])
    if mesh is not None:
        with mesh:
            out = j_run([m[0] for m in members], members[0][1], JModelConfig(pretrained=False),
                        ds, mesh=mesh, **kw)
    else:
        out = j_run([m[0] for m in members], members[0][1], JModelConfig(pretrained=False), ds, **kw)
    ds.close()
    return {k: np.asarray(v) for k, v in out.items()}


def _port_maps(spec, name, **cfg):
    ev = spec["evals"][name]
    members = [load_popcorn_checkpoint(p) for p in ev["members"]]
    ds = PopulationDataset(_ev_paths(spec, name), "rwa", mode="test", patchsize=ev["patch"],
                           overlap=ev["overlap"], fourseasons=False)
    out = run_sliding_inference([m[0] for m in members], members[0][1],
                                ModelConfig(pretrained=False, **cfg), ds,
                                batch_size=ev["batch"], device="cpu")
    ds.close()
    return out


def test_sharded_inference_matches_jax_mesh(ranked):
    """tests/test_multichip.py::test_sharded_inference_matches_single_device:
    the patches split over two data ranks, against the JAX eval on its
    8-device mesh and against the port's one-rank eval."""
    root, spec, _, _, _ = ranked
    got = dict(np.load(str(root / "ev_A_2x1.npz")))
    ref = _jax_maps(spec, "A", j_make_mesh(8))
    one = _port_maps(spec, "A")
    np.testing.assert_array_equal(got["count"], ref["count"])
    for k in ("map", "scale"):
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **MAP_TOL)
        np.testing.assert_allclose(got[k], one[k], err_msg=k, **SHARD_MAP)
    _assert_std(got, one)
    np.testing.assert_array_equal(got["count"], one["count"])


@pytest.mark.parametrize("grid", ["1x2", "2x1"])
def test_ensemble_sharded_inference_matches_scan_fold(ranked, grid):
    """tests/test_multichip.py::test_ensemble_sharded_inference_matches_scan_fold:
    5 members split over two 'ensemble' ranks (member slot 6 padded), and
    the patches over two 'data' ranks, against the JAX scan fold and the
    port's one-rank fold."""
    root, spec, _, _, _ = ranked
    got = dict(np.load(str(root / f"ev_B_{grid}.npz")))
    ref = _jax_maps(spec, "B")
    one = _port_maps(spec, "B")
    np.testing.assert_array_equal(got["count"], ref["count"])
    for k in ("map", "scale"):
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **MAP_TOL)
        np.testing.assert_allclose(got[k], one[k], err_msg=k, **SHARD_MAP)
    _assert_std(got, one)


def test_static_int8_under_ranks_takes_the_dynamic_kernels(ranked):
    """popcorn_tpu/infer/sliding.py:381-383: a ranked fold keeps the
    dynamic int8 path, so --quantize int8s over two data ranks equals the
    one-rank 'int8' eval."""
    root, spec, _, _, _ = ranked
    got = dict(np.load(str(root / "ev_A_int8s_2x1.npz")))
    one = _port_maps(spec, "A", quantize="int8")
    for k in ("map", "scale"):
        np.testing.assert_allclose(got[k], one[k], err_msg=k, **SHARD_MAP)


def test_multihost_mesh_single_host_degrade(ranked):
    """tests/test_multichip.py::test_multihost_mesh_single_host_degrade:
    under one host the multi-host grid is make_mesh's, in the port's two
    ranks as in the JAX package's 8 devices."""
    root = ranked[0]
    got = torch.load(str(root / "multihost.pt"), weights_only=False)
    m = j_make_multihost_mesh(n_data_per_host=2)
    m2 = j_make_multihost_mesh(n_data_per_host=1, n_ensemble=2)
    assert got["m1"] == (m.axis_names, dict(m.shape)) == (("data",), {"data": 2})
    assert got["m2"] == (m2.axis_names, dict(m2.shape))
    assert got["ens"] == j_ensemble_size(m2) == 2


def test_trainer_data_parallel(ranked, tmp_path):
    """tests/test_multichip.py::test_trainer_data_parallel: an epoch on two
    data ranks (host feed; 4-sample batches, two rows a rank: the JAX
    test's 8-sample batches make no full batch of this region's 12
    samples) runs, its losses finite and its replicas equal, and it equals
    the one-rank trainer's epoch on the same region (the global batch's
    loss at the JAX step's tolerance, and its parameters)."""
    root, spec, _, _, _ = ranked
    got = torch.load(str(root / "trainer_off.pt"), weights_only=False)
    assert got["same"] and got["feed"] == "WeaksupFeed"
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    tr = Trainer(DataPaths(spec["train_data"]), ModelConfig(pretrained=False),
                 TrainConfig(**TRAINER, device_feed="off", save_dir=str(tmp_path)),
                 inference_patch=128, inference_overlap=16, device="cpu")
    tr.train_epoch()
    np.testing.assert_allclose(got["losses"], train_losses(tr), rtol=1e-5)
    np.testing.assert_allclose(got["pred"], tr.pred_buffer.get(), rtol=1e-5)
    np.testing.assert_array_equal(got["target"], tr.target_buffer.get())
    for k, v in tree_flatten(tr.params):
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=str(k),
                                   **STEP_PARAMS)


def test_trainer_dp_uses_device_feed(ranked):
    """tests/test_device_weaksup.py::test_trainer_dp_uses_device_feed: the
    data-parallel trainer takes the device feed, whose rows equal the host
    feed's, so its epoch's parameters equal the host-feed DP trainer's bit
    for bit."""
    root = ranked[0]
    dev, host = (torch.load(str(root / f"trainer_{f}.pt"), weights_only=False)
                 for f in ("on", "off"))
    assert dev["feed"] == "DeviceWeaksupFeed" and dev["same"]
    for k, v in host["params"].items():
        assert torch.equal(dev["params"][k], v), k


EVAL_CLI_FLAGS = ["-treg", "rwa", "-S1", "-S2", "-NIR", "-occmodel", "-senbuilds",
                  "--compute_dtype", "float32", "--device", "cpu"]
TRAIN_CLI_FLAGS = ["-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa", "-occmodel",
                   "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse",
                   "--compute_dtype", "float32", "-e", "1", "-lt", "1", "-ms", "4", "-w", "1",
                   "--device", "cpu"]


def _eval_cli_run(ev, d, *extra):
    """The eval CLI on eval ``ev``'s region, its members copied into the
    new directory ``d``: (what main returned, the run's output folder)."""
    from popcorn_tpu_torch.cli import eval as eval_cli

    os.makedirs(d)
    cks = [shutil.copy(p, d) for p in ev["members"]]
    got = eval_cli.main(["--data_root", ev["data"], *EVAL_CLI_FLAGS, "--patchsize", str(ev["patch"]),
                         "--patch_overlap", str(ev["overlap"]), "-r", *cks, *extra])
    (folder,) = [f for f in os.listdir(d) if f.startswith("eval_outputs_ensemble")]
    return got, os.path.join(d, folder)


def _cli_metrics(folder):
    """The eval's one census record (a second writer would add a line)."""
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    return {k: v for k, v in rec.items() if k not in ("step", "time")}


def _tif(folder, name):
    with GeoTIFF(os.path.join(folder, name)) as g:
        return g.read(1, squeeze=True)


@pytest.fixture(scope="module")
def eval_cli_one(ranked, tmp_path_factory):
    return _eval_cli_run(ranked[1]["evals"]["A"], str(tmp_path_factory.mktemp("cli_one") / "m"))


@pytest.mark.parametrize("grid", [["--data_parallel", "2"], ["--ensemble_parallel", "2"]],
                         ids=lambda g: g[0])
def test_eval_cli_ranks_match_one_rank_and_only_rank0_writes(ranked, eval_cli_one, tmp_path, grid):
    """The eval CLI typed with --data_parallel 2 or --ensemble_parallel 2
    (--device cpu) spawns two gloo ranks (cli/eval.py -> spawn_ranks ->
    Evaluator(mesh=)): rank 0 writes the one output folder, whose name the
    other rank was handed, with the one-rank CLI's files; its GeoTIFFs and
    census metrics equal the one-rank CLI's at the sharded-run bounds (the
    std maps through their variance); the other rank writes nothing."""
    root, spec = ranked[:2]
    one_metrics, one = eval_cli_one
    got, folder = _eval_cli_run(spec["evals"]["A"], str(tmp_path / "m"), *grid)
    assert got is None  # the parent of the spawned ranks
    assert sorted(os.listdir(tmp_path / "m")) == sorted(
        [os.path.basename(p) for p in spec["evals"]["A"]["members"]] + [os.path.basename(folder)])
    assert sorted(os.listdir(folder)) == sorted(os.listdir(one))
    metrics, ref_metrics = _cli_metrics(folder), _cli_metrics(one)
    assert metrics.keys() == ref_metrics.keys() == {f"{k}/targettest" for k in one_metrics}
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(metrics[k], v, err_msg=k, **SHARD_MAP)
    count = np.load(str(root / "ev_A_2x1.npz"))["count"]
    names = {"map": "rwa_predictions.tif", "map_std": "rwa_predictionsSTD.tif",
             "scale": "rwa_predictionsSCALE_rwa.tif", "scale_std": "rwa_predictionsSCALE_STD.tif"}
    maps = {k: _tif(folder, n) for k, n in names.items()}
    ref = {k: _tif(one, n) for k, n in names.items()}
    for k in ("map", "scale"):
        np.testing.assert_allclose(maps[k], ref[k], err_msg=k, **SHARD_MAP)
    _assert_std({**maps, "count": count}, {**ref, "count": count})
    adj = "rwa_predictionsADJ_rwa.tif"
    np.testing.assert_allclose(_tif(folder, adj), _tif(one, adj), **SHARD_MAP)


def test_train_cli_data_parallel_matches_one_rank_and_only_rank0_writes(ranked, tmp_path):
    """The train CLI typed with --data_parallel 2 (--device cpu) spawns two
    gloo ranks (cli/train.py -> spawn_ranks -> Trainer): rank 0 writes the
    one experiment folder with the one-rank CLI's files; its logged losses
    equal the one-rank CLI's (rtol 1e-5) and its checkpoint the one-rank
    checkpoint at the sharded step's bound; the other rank writes
    nothing."""
    from popcorn_tpu_torch.cli import train as train_cli

    data = ranked[1]["train_data"]
    runs = {}
    for name, extra in (("one", []), ("dp", ["--data_parallel", "2"])):
        out = str(tmp_path / name)
        got = train_cli.main(["--data_root", data, *TRAIN_CLI_FLAGS, "--save_dir", out, *extra])
        assert (got is None) == bool(extra)  # the parent of the spawned ranks
        (folder,) = os.listdir(out)
        runs[name] = os.path.join(out, folder)
    one, dp = runs["one"], runs["dp"]
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))
    losses = train_losses(SimpleNamespace(experiment_folder=dp))
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, train_losses(SimpleNamespace(experiment_folder=one)),
                               rtol=1e-5)
    got = dict(tree_flatten(load_popcorn_checkpoint(os.path.join(dp, "last_model.pth"))[0]))
    ref = dict(tree_flatten(load_popcorn_checkpoint(os.path.join(one, "last_model.pth"))[0]))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=str(k), **STEP_PARAMS)


@pytest.mark.parametrize("augment", [False, True])
def test_device_feed_mesh_batch_parity(ranked, augment):
    """tests/test_device_weaksup.py::test_device_feed_mesh_batch_parity:
    under two data ranks each rank's device-feed batch is its rows of the
    host feed's batch, bit for bit and dtype for dtype."""
    root, spec = ranked[:2]
    ds = PopulationDataset(DataPaths(spec["feed"]), "rwa", mode="weaksup", train_level="coarse",
                           patchsize=None, overlap=None, fourseasons=True)
    host = list(WeaksupFeed([ds], batch_size=2, seed=1600, prefetch=0, augment=augment).epoch(0))
    ds.close()
    ranks = [torch.load(str(root / f"feed_{augment}_{r}.pt"), weights_only=False)
             for r in range(2)]
    assert len(host) == len(ranks[0]) == len(ranks[1]) > 0
    for i, hb in enumerate(host):
        want = uploaded(hb)
        for r in range(2):
            b = ranks[r][i]
            assert list(b["rows"]) == [r] and set(b) - {"rows"} == set(want)
            for k, v in b.items():
                if k == "rows":
                    continue
                w = want[k]
                if isinstance(w, torch.Tensor) and w.dim() >= 1 and k != "photometric":
                    w = w[r:r + 1]
                elif isinstance(w, np.ndarray) and k != "photometric":
                    w = w[r:r + 1]
                if isinstance(v, torch.Tensor):
                    assert v.dtype == w.dtype and torch.equal(v, w), (i, r, k)
                else:
                    np.testing.assert_array_equal(v, w, err_msg=f"{i} {r} {k}")


def test_population_timeseries_mesh(ranked, tmp_path):
    """pop_timeseries(mesh=): a step's eval over two data ranks, rank 0's
    totals against the one-rank time series'."""
    root, spec = ranked[:2]
    got = torch.load(str(root / "pop_mesh.pt"), weights_only=False)
    ev = spec["evals"]["A"]
    members = [load_popcorn_checkpoint(p) for p in ev["members"]]
    ref = run_population_timeseries(
        [m[0] for m in members], members[0][1], ModelConfig(pretrained=False),
        [("a", DataPaths(ev["data"]), "rwa")], str(tmp_path), patchsize=ev["patch"],
        overlap=ev["overlap"], fourseasons=False, device="cpu")
    assert [r["label"] for r in got] == ["a"]
    np.testing.assert_allclose(got[0]["total_population"], ref[0]["total_population"], rtol=1e-5)
    assert os.path.exists(os.path.join(str(root / "pop_mesh"), "totals.csv"))


def test_two_process_rehearsal_matches_jax(ranked):
    """tests/test_multihost_procs.py::test_two_process_multihost_matches_single_process:
    two localhost worker processes (gloo) run the data-parallel step and
    the 2-way ensemble fold; both see the same values, which equal the
    JAX package's single-process step on its 8-device mesh and its fold."""
    root, _, (jparams, jconsts), _, _ = ranked
    from popcorn_tpu.dist.multihost import run_demo_step as j_run_demo_step

    ref_loss, ref_pop = j_run_demo_step(j_make_mesh(8))
    ref_ens = j_run_demo_eval(2)
    state = str(root / "state.pt")
    (l0, p0, e0), (l1, p1, e1) = launch_workers(2, device="cpu", state=state, timeout=600)
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    np.testing.assert_allclose(p0, p1, rtol=1e-6)
    np.testing.assert_allclose(e0, e1, rtol=1e-6)
    # the JAX demo step draws its own mask; the workers take it from state
    np.testing.assert_allclose(l0, ref_loss, rtol=1e-4)
    np.testing.assert_allclose(p0, ref_pop, rtol=1e-4)
    np.testing.assert_allclose(e0, ref_ens, rtol=1e-4)
    np.testing.assert_allclose(e0, run_demo_eval(None, state, device="cpu"), rtol=1e-5)


def _cards(monkeypatch, n):
    """This process sees ``n`` cards (0: none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_make_mesh_refuses_more_ranks_than_devices(monkeypatch):
    """popcorn_tpu/dist/mesh.py:58-66: a grid larger than the devices
    raises ValueError: one process with one CPU device, and a host with
    one card (two data ranks on the one-card machine)."""
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        mesh_mod.make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="requested 1x2 mesh"):
        mesh_mod.make_mesh(1, devices=["cpu"], n_ensemble=2)
    m = mesh_mod.make_mesh(devices=["cpu"])
    assert (m.size, m.rank, m.device.type, m.backend) == (1, 0, "cpu", None)
    _cards(monkeypatch, 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        mesh_mod.make_mesh(2)
    with pytest.raises(ValueError, match="requested 1x2 mesh"):
        mesh_mod.make_mesh(1, n_ensemble=2)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        mesh_mod.devices_for("cuda", 2)
    assert mesh_mod.make_mesh().device == torch.device("cuda", 0)


def test_devices_for_keeps_the_card_index(monkeypatch):
    """--device cuda:1 runs one rank on card 1 (a one-rank mesh too, as
    the builtup time series' --spatial builds); 'cuda' gives one card a
    rank; 'cpu' one CPU a rank."""
    _cards(monkeypatch, 2)
    assert mesh_mod.devices_for("cuda:1") == ["cuda:1"]
    assert mesh_mod.make_mesh(devices=mesh_mod.devices_for("cuda:1")).device == torch.device("cuda", 1)
    assert mesh_mod.devices_for("cuda", 2) == ["cuda:0", "cuda:1"]
    assert mesh_mod.devices_for("cpu", 2) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="requested 3 devices, only 2 available"):
        mesh_mod.devices_for("cuda", 3)


def _no_card_case(case, tmp_path, monkeypatch):
    from popcorn_tpu_torch.cli import eval as eval_cli
    from popcorn_tpu_torch.cli import train as train_cli
    from popcorn_tpu_torch.cli.args import eval_parser
    from popcorn_tpu_torch.config import EvalConfig
    from popcorn_tpu_torch.dist.multihost import worker_main
    from popcorn_tpu_torch.infer import spatial as sp
    from popcorn_tpu_torch.infer.evaluator import Evaluator

    members = ["-r", str(tmp_path / "m.pth")]
    if case == "make_mesh":
        mesh_mod.make_mesh()
    elif case == "make_mesh_2":
        mesh_mod.make_mesh(2)
    elif case == "devices_for":
        mesh_mod.devices_for("cuda", 2)
    elif case == "eval_data_parallel":
        eval_cli.main(["--data_parallel", "2", *members])
    elif case == "eval_ensemble_parallel":
        eval_cli.main(["--ensemble_parallel", "2", *members])
    elif case == "eval_rank_mesh":  # a rank under torchrun builds its mesh
        eval_cli.eval_mesh(eval_parser().parse_args(["--data_parallel", "2", *members]))
    elif case == "evaluator_mesh":
        Evaluator(DataPaths(str(tmp_path)), ModelConfig(), EvalConfig(checkpoints=members[1:]),
                  mesh=mesh_mod.Mesh(1, 1, 0, "cuda:0"))
    elif case == "train_data_parallel":
        train_cli.main(["--data_parallel", "2"])
    elif case == "spatial":
        sp.make_spatial_builtup({}, ModelConfig())
    elif case == "pop_timeseries_mesh":
        run_population_timeseries([], {}, ModelConfig(), [], str(tmp_path), spatial=True,
                                  mesh=mesh_mod.Mesh(1, 1, 0, "cuda:0"))
    elif case == "rehearsal_one_rank":
        run_demo_step(None)
    elif case == "multihost_worker":  # its default device is the card
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                  "LOCAL_WORLD_SIZE"):
            monkeypatch.setenv(k, "1")  # restored after the test
        worker_main(["--coordinator", "127.0.0.1:1", "--num-processes", "2",
                     "--process-id", "0"])


@pytest.mark.parametrize("case", [
    "make_mesh", "make_mesh_2", "devices_for", "eval_data_parallel", "eval_ensemble_parallel",
    "eval_rank_mesh", "evaluator_mesh", "train_data_parallel", "spatial", "pop_timeseries_mesh",
    "rehearsal_one_rank", "multihost_worker"])
def test_no_card_raises_instead_of_running_on_the_cpu(case, tmp_path, monkeypatch):
    """On a host without a card, every ranked and whole-frame entry point
    asked for the card (the default) raises; none runs its ranks on the
    CPU. The eval and train CLIs raise before they spawn a rank."""
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        _no_card_case(case, tmp_path, monkeypatch)
    assert not torch.distributed.is_initialized()


def test_backend_choice_and_batch_rows():
    assert mesh_mod.choose_backend(["cpu", "cpu"])[0] == "gloo"
    assert mesh_mod.choose_backend(["cuda:0", "cuda:0"])[0] == "gloo"
    assert mesh_mod.choose_backend(["cuda:0", "cuda:1"])[0] == "nccl"
    assert mesh_mod.choose_backend(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], local=2)[0] == "nccl"
    m = mesh_mod.Mesh(2, 2, 3, "cpu")
    assert (m.data_index, m.ensemble_index, m.shape) == (1, 1, {"data": 2, "ensemble": 2})
    np.testing.assert_array_equal(m.batch_rows(8), [4, 5, 6, 7])
    np.testing.assert_array_equal(m.batch_rows(8, n_micro=2), [2, 3, 6, 7])
    with pytest.raises(ValueError):
        m.batch_rows(6, n_micro=2)


def test_pad_batch_to_multiple():
    b = {"x": np.arange(5.0), "p": np.ones(4)}
    out = mesh_mod.pad_batch_to_multiple(b, 4, ("x",))
    np.testing.assert_array_equal(out["x"], [0, 1, 2, 3, 4, 4, 4, 4])
    np.testing.assert_array_equal(out["valid"], [1, 1, 1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(out["p"], b["p"])
    t = mesh_mod.pad_batch_to_multiple({"x": torch.arange(4.0)}, 4, ("x",))
    assert t["valid"].all() and torch.equal(t["x"], torch.arange(4.0))


def test_make_mesh_joins_the_torchrun_group(tmp_path):
    """Two processes with torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): make_mesh joins the group itself (gloo on
    CPU ranks) and an all-reduce over the mesh sums both ranks."""
    import subprocess
    import sys

    from popcorn_tpu_torch.dist.launch import free_port

    code = (
        "import torch; from popcorn_tpu_torch.dist.mesh import make_mesh; "
        "m = make_mesh(2, devices=['cpu', 'cpu']); "
        "t = m.all_reduce(torch.tensor([m.rank + 1.0])); "
        "print('RANK', m.rank, m.backend, float(t[0]))"
    )
    port = str(free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                                      cwd=os.path.dirname(os.path.dirname(__file__)),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, e
        assert f"RANK {r} gloo 3.0" in o, o

"""What each of two gloo CPU ranks runs for tests/test_torch_dist.py,
tests/test_torch_spatial.py and tests/test_torch_spatial_train.py: one
spawn a test module (its fixture), every ranked path of the port on inputs
the fixture wrote, results written by rank 0 (or by each rank where a
rank's own share is checked). This module imports torch and the port only:
the spawned ranks never import jax."""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

CPU2 = ["cpu", "cpu"]


def _save(root, name, obj):
    torch.save(obj, os.path.join(root, name))


def train_losses(trainer):
    """The logged optimization loss of every step of a trainer (its
    metrics.jsonl, written by rank 0)."""
    with open(os.path.join(trainer.experiment_folder, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["optimization_loss/train"] for r in recs if "optimization_loss/train" in r]


def dist_suite(root):
    torch.set_num_threads(1)
    from popcorn_tpu_torch.compat.weights import load_popcorn_checkpoint
    from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
    from popcorn_tpu_torch.data.dataset import PopulationDataset
    from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed
    from popcorn_tpu_torch.dist.mesh import ensemble_size, make_mesh, make_multihost_mesh
    from popcorn_tpu_torch.dist.multihost import run_demo_eval, run_demo_step
    from popcorn_tpu_torch.infer.pop_timeseries import run_population_timeseries
    from popcorn_tpu_torch.infer.sliding import run_sliding_inference
    from popcorn_tpu_torch.train.state import tree_flatten
    from popcorn_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    spec = json.load(open(os.path.join(root, "spec.json")))
    mesh = make_mesh(2, devices=CPU2)

    # the data-parallel train step and the ensemble fold of the rehearsal
    loss, pop, params = run_demo_step(mesh, os.path.join(root, "state.pt"))
    ens = make_mesh(1, devices=CPU2, n_ensemble=2)
    enssum = run_demo_eval(ens, os.path.join(root, "state.pt"))
    if rank == 0:
        _save(root, "dp_step.pt", {"loss": loss, "pop": pop, "enssum": enssum,
                                   "params": dict(tree_flatten(params))})

    # the multi-host grid under one host
    m1 = make_multihost_mesh(n_data_per_host=2, devices=CPU2)
    m2 = make_multihost_mesh(n_data_per_host=1, n_ensemble=2, devices=CPU2)
    if rank == 0:
        _save(root, "multihost.pt", {"m1": (m1.axis_names, m1.shape), "m2": (m2.axis_names, m2.shape),
                                     "ens": ensemble_size(m2)})

    # the patch-split and member-split evals
    for name, ev in spec["evals"].items():
        members = [load_popcorn_checkpoint(p)[0] for p in ev["members"]]
        consts = load_popcorn_checkpoint(ev["members"][0])[1]
        ds = PopulationDataset(DataPaths(ev["data"]), "rwa", mode="test", patchsize=ev["patch"],
                               overlap=ev["overlap"], fourseasons=False)
        mcfg = ModelConfig(pretrained=False, quantize=ev.get("quantize"))
        for nd, ne in ev["meshes"]:
            maps = run_sliding_inference(members, consts, mcfg, ds, batch_size=ev["batch"],
                                         mesh=make_mesh(nd, devices=CPU2, n_ensemble=ne))
            assert (maps is None) == (rank != 0)
            if rank == 0:
                np.savez(os.path.join(root, f"ev_{name}_{nd}x{ne}.npz"), **maps)
        ds.close()

    # the device feed's rows of each global batch, on each rank
    ds = PopulationDataset(DataPaths(spec["feed"]), "rwa", mode="weaksup", train_level="coarse",
                           patchsize=None, overlap=None, fourseasons=True)
    for augment in (False, True):
        feed = DeviceWeaksupFeed([ds], mesh=mesh, device="cpu", batch_size=2, seed=1600,
                                 prefetch=0, augment=augment)
        _save(root, f"feed_{augment}_{rank}.pt", list(feed.epoch(0)))
    ds.close()

    # the data-parallel trainer, host feed and device feed
    for feed in ("off", "on"):
        tcfg = TrainConfig(**spec["trainer"], data_parallel=2, device_feed=feed,
                           save_dir=os.path.join(root, f"train_{feed}"))
        tr = Trainer(DataPaths(spec["train_data"]), ModelConfig(pretrained=False), tcfg,
                     inference_patch=128, inference_overlap=16, device="cpu")
        tr.train_epoch()
        flat = dict(tree_flatten(tr.params))
        # the replicas stay equal: every rank's parameters against rank 0's
        same = all([bool(torch.equal(v, mesh.broadcast(v.clone()))) for v in flat.values()])
        if rank == 0:
            _save(root, f"trainer_{feed}.pt", {"losses": train_losses(tr), "params": flat,
                                               "same": same,
                                               "feed": type(tr.feed).__name__,
                                               "pred": tr.pred_buffer.get(),
                                               "target": tr.target_buffer.get()})

    # the population time series over the ranks
    pop_ev = spec["evals"]["A"]
    members = [load_popcorn_checkpoint(p)[0] for p in pop_ev["members"]]
    recs = run_population_timeseries(
        members, load_popcorn_checkpoint(pop_ev["members"][0])[1], ModelConfig(pretrained=False),
        [("a", DataPaths(pop_ev["data"]), "rwa")], os.path.join(root, "pop_mesh"),
        patchsize=pop_ev["patch"], overlap=pop_ev["overlap"], fourseasons=False, mesh=mesh)
    if rank == 0:
        _save(root, "pop_mesh.pt", recs)


def spatial_suite(root):
    torch.set_num_threads(1)
    from popcorn_tpu_torch.compat.weights import load_popcorn_checkpoint
    from popcorn_tpu_torch.config import DataPaths, ModelConfig
    from popcorn_tpu_torch.data.dataset import PopulationDataset
    from popcorn_tpu_torch.dist.mesh import make_mesh
    from popcorn_tpu_torch.infer import spatial as sp
    from popcorn_tpu_torch.infer.timeseries import builtup_map

    rank = dist.get_rank()
    spec = json.load(open(os.path.join(root, "spec.json")))
    params, consts = load_popcorn_checkpoint(spec["model"])
    mcfg = ModelConfig(pretrained=False)
    mesh = make_mesh(2, devices=CPU2)
    out = {}
    for name, (h, w, seed) in spec["frames"].items():
        f = np.load(os.path.join(root, f"frame_{name}.npz"))
        out[f"density_{name}"] = sp.spatial_density_map(params, consts, mcfg, f["s2"], f["s1"], mesh)
        out[f"builtup_{name}"] = sp.spatial_builtup_map(consts, mcfg, f["s2"], f["s1"], mesh)
        out[f"ts_builtup_{name}"] = builtup_map(consts, mcfg, f["s2"], f["s1"], mesh=mesh)
    # the whole-region ensemble over (2, 1) and (1, 2) ranks
    members = [load_popcorn_checkpoint(p)[0] for p in spec["members"]]
    ds = PopulationDataset(DataPaths(spec["region"]), "rwa", mode="test", patchsize=96, overlap=16,
                           fourseasons=False)
    for nd, ne in ((2, 1), (1, 2)):
        maps = sp.run_spatial_inference(members, consts, mcfg, ds,
                                        mesh=make_mesh(nd, devices=CPU2, n_ensemble=ne))
        assert (maps is None) == (rank != 0)
        out[f"region_{nd}x{ne}"] = maps
    ds.close()
    if rank == 0:
        _save(root, "spatial.pt", out)


# the image keys whose rows split over the ranks (train/trainer.py::ROW_KEYS)
ROW_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask")


def spatial_step(mesh, batch, params, consts, mask=None, seed=3):
    """One train step of ``batch`` (numpy, whole crops) with this rank's
    rows of each crop (``mesh``; None: one rank, the plain step), the JAX
    weights' ModelConfig and a sparsity mask drawn from ``seed`` unless
    ``mask`` (the whole crops') is given: TrainStep.__call__'s gradients,
    summed over the ranks, and update. Returns (loss, popcount, the
    gradients and the stepped parameters by path)."""
    from popcorn_tpu_torch.config import ModelConfig, TrainConfig
    from popcorn_tpu_torch.data.normalize import NormStats
    from popcorn_tpu_torch.dist.mesh import shard_batch_spatial
    from popcorn_tpu_torch.train.state import make_optimizer, make_train_step, tree_flatten

    tcfg = TrainConfig()
    opt = make_optimizer(tcfg)
    step = make_train_step(ModelConfig(pretrained=False, biasinit=0.9407), tcfg, consts,
                           NormStats(device="cpu"), opt, mesh=mesh)
    b = shard_batch_spatial(batch, mesh, row_keys=ROW_KEYS)
    tb = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
    grads, aux = step.grads(params, tb, torch.Generator().manual_seed(seed), mask=mask)
    if step.mesh is not None:
        grads = step.reduce_grads(grads)
    new, _ = opt.update(grads, opt.init(params), params)
    return (float(aux["optimization_loss"]), aux["popcount"].numpy(), dict(tree_flatten(grads)),
            dict(tree_flatten(new)))


def spatial_train_suite(root):
    torch.set_num_threads(1)
    from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
    from popcorn_tpu_torch.dist.mesh import make_mesh
    from popcorn_tpu_torch.train.state import tree_flatten
    from popcorn_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    spec = json.load(open(os.path.join(root, "spec.json")))
    state = torch.load(os.path.join(root, "state.pt"))
    mesh = make_mesh(2, devices=CPU2)
    out = {}
    # the step on each crop: with the JAX package's mask, and drawn
    for name, mask_name in spec["steps"].items():
        batch = dict(np.load(os.path.join(root, f"crop_{name}.npz")))
        mask = None if mask_name is None else state["masks"][mask_name]
        out[name] = spatial_step(mesh, batch, state["params"], state["consts"], mask)
        out[f"row_block_{name}_{rank}"] = shard_batch_spatial_rows(batch, mesh)

    # the trainer on the grid it is given (the train CLI's ranks build
    # theirs): rows over the two ranks, the host feed
    tcfg = TrainConfig(**spec["trainer"], spatial_train=True, save_dir=os.path.join(root, "train"))
    tr = Trainer(DataPaths(spec["train_data"]), ModelConfig(pretrained=False, biasinit=0.9407),
                 tcfg, inference_patch=128, inference_overlap=16, device="cpu", mesh=mesh)
    dev_b, host_b, _ = next(tr._lookahead_batches(0))
    tr.train_epoch()
    flat = dict(tree_flatten(tr.params))
    same = all([bool(torch.equal(v, mesh.broadcast(v.clone()))) for v in flat.values()])
    out[f"trainer_{rank}"] = {"n_data": tr.mesh.n_data, "feed": tr.feed_choice,
                              "row_block": dev_b["row_block"], "rows": dev_b["S2"].shape[1],
                              "crop": host_b["S2"].shape[1], "same": same}
    if rank == 0:
        out["trainer"] = {"losses": train_losses(tr), "params": flat}
    torch.save(out, os.path.join(root, f"spatial_train_{rank}.pt"))


def shard_batch_spatial_rows(batch, mesh):
    """The 'row_block' that dist/mesh.py::shard_batch_spatial gives this rank."""
    from popcorn_tpu_torch.dist.mesh import shard_batch_spatial

    return shard_batch_spatial(batch, mesh, row_keys=ROW_KEYS)["row_block"]

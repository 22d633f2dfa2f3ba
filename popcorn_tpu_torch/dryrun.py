"""Dry-run entry points of the port: the forward on one patch, and the
ranked paths run once each on tiny shapes.

Counterpart of __graft_entry__.py. The JAX package proves its sharded
programs on a mesh of virtual CPU devices; the port's ranks are processes
with one device each, so its dry runs spawn them: gloo CPU ranks with
``device="cpu"``, or ranks that share one card (``"cuda:0"``, over gloo:
NCCL takes one rank a card), as the one-card rehearsal does
(dist/multihost.py). Nothing here runs at import.

  * ``entry()`` — (fn, example_args): the POPCORN forward on a 512^2
    S1+S2 patch on ``device`` (the card unless the caller asks for the
    CPU), in bf16 there and float32 on the CPU;
  * ``dryrun_multichip(n)`` — n spawned ranks (dist/launch.py): a
    data-parallel train step; the mesh-aware device feed's step bit-equal
    to the host feed's on the same batch; one crop's rows over the ranks
    (``shard_batch_spatial``); the Bag-of-POPCORN fold over a (data,
    ensemble) grid; and the whole-frame density map
    (infer/spatial.py::spatial_density_map). The model is the JAX dry
    run's: random (seed 0), head unfused;
  * ``dryrun_multihost(p, l)`` — the multi-process rehearsal
    (dist/multihost.py::launch_workers) with p x l workers, one rank each:
    their losses, popcount sums and ensemble sums agree.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _check(ok, what) -> None:
    """A dry run's check: AssertionError with ``what`` unless ``ok``."""
    if not ok:
        raise AssertionError(what)


def entry(device="cuda"):
    """(fn, example_args): the POPCORN forward on a 512x512 S1+S2 patch,
    on ``device``; ``fn(s2, s1)`` returns (popdensemap, popcount)."""
    from .compat.weights import to_torch
    from .config import ModelConfig
    from .data.normalize import NormStats, normalize_and_assemble
    from .dist.mesh import resolve_device
    from .nn.init import init_popcorn
    from .nn.popcorn import popcorn_forward

    import torch

    dev = resolve_device(device)
    mcfg = ModelConfig(pretrained=False,
                       compute_dtype="bfloat16" if dev.type == "cuda" else "float32")
    params, consts = init_popcorn(1600, mcfg)
    params, consts = to_torch(params, dev), to_torch(consts, dev)
    stats = NormStats(device=dev)

    @torch.no_grad()
    def fn(s2, s1):
        inputs = {"input": normalize_and_assemble({"S2": s2, "S1": s1}, stats)}
        out = popcorn_forward(params, consts, inputs, mcfg, train=False, padding=False,
                              sparse=False)
        return out["popdensemap"], out["popcount"]

    example_args = (torch.zeros((1, 512, 512, 4), device=dev),
                    torch.zeros((1, 512, 512, 2), device=dev))
    return fn, example_args


def _multichip_rank(n: int, devices, region: str, out: str) -> None:
    """One rank of ``dryrun_multichip``: every check, with rank 0 writing
    the results to ``out``. Raises AssertionError in the rank whose check
    fails (spawn_ranks then raises in the parent)."""
    import torch

    from .compat.weights import to_torch
    from .config import DataPaths, ModelConfig, TrainConfig
    from .data.dataset import PopulationDataset
    from .data.device_weaksup import DeviceWeaksupFeed
    from .data.feed import WeaksupFeed
    from .data.normalize import NormStats
    from .dist.mesh import make_mesh, pad_batch_to_multiple, replicate, shard_batch, shard_batch_spatial
    from .dist.multihost import scaled_tree
    from .infer.sliding import _upload, make_patch_forward
    from .infer.spatial import spatial_density_map
    from .nn.init import init_popcorn
    from .train.state import make_optimizer, make_train_step, tree_flatten
    from .train.trainer import ROW_KEYS, SHARD_KEYS, TRAIN_KEYS

    mesh = make_mesh(n, devices=devices)
    dev = mesh.device
    if dev.type == "cuda":
        # the two feeds' steps are compared bit for bit: no algorithm whose
        # sums depend on the run
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    mcfg = ModelConfig(pretrained=False, fused_head=False)
    tcfg = TrainConfig(weak_batch_size=n)
    params, consts = init_popcorn(0, mcfg)
    params = replicate(to_torch(params, dev), mesh)
    consts = to_torch(consts, dev)
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, consts, NormStats(device=dev), optimizer, mesh=mesh)
    rec = {"n": n, "device": str(dev), "backend": mesh.backend}

    # (1) one data-parallel train step: the batch's rows over the ranks
    b, h, w = n, 64, 64
    rng = np.random.default_rng(0)
    batch = {
        "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
        "admin_mask": np.tile(np.arange(1, b + 1, dtype=np.float32)[:, None, None], (1, h, w)),
        "census_idx": np.arange(1, b + 1, dtype=np.float32),
        "y": rng.uniform(10, 1000, (b,)).astype(np.float32),
        "photometric": np.asarray([0.0, 1.0, 0.0, 1.0], np.float32),
    }
    _, _, aux = step(params, opt_state,
                     _upload(shard_batch(batch, mesh, batch_keys=SHARD_KEYS), dev, TRAIN_KEYS),
                     torch.Generator().manual_seed(7))
    rec["loss"] = float(aux["optimization_loss"])
    _check(np.isfinite(rec["loss"]), f"multichip dryrun produced non-finite loss {rec['loss']}")

    # (2) the mesh-aware device feed: its batch, this rank's rows assembled
    # on the device, steps bit-equal to the host feed's batch
    ds = PopulationDataset(DataPaths(region), "rwa", mode="weaksup", train_level="coarse",
                           patchsize=None, overlap=None, fourseasons=True)
    # one rung: every census window buckets to 128^2, so the first batch
    # holds n samples whatever the draw
    fkw = dict(batch_size=n, seed=1600, prefetch=0, num_workers=1, bucket_ladder=(128,))
    results = {}
    try:
        for name, feed in (("host", WeaksupFeed([ds], **fkw)),
                           ("device", DeviceWeaksupFeed([ds], mesh=mesh, device=dev, **fkw))):
            fb = next(iter(feed.epoch(0)))
            if "rows" not in fb:
                fb = shard_batch(pad_batch_to_multiple(fb, n, SHARD_KEYS), mesh, batch_keys=SHARD_KEYS)
            fp, _, faux = step(params, opt_state, _upload(fb, dev, TRAIN_KEYS),
                               torch.Generator().manual_seed(9))
            results[name] = (dict(tree_flatten(fp)), float(faux["optimization_loss"]))
    finally:
        ds.close()
    host_p, dev_p = results["host"][0], results["device"][0]
    rec["feed_leaves_bit_equal"] = sum(bool(torch.equal(host_p[k], dev_p[k])) for k in host_p)
    rec["feed_leaves"] = len(host_p)
    rec["feed_loss"] = [results["host"][1], results["device"][1]]
    _check(rec["feed_leaves_bit_equal"] == len(host_p), f"device feed step differs: {rec}")
    _check(np.isfinite(rec["feed_loss"][1]), f"device-feed dp dryrun loss {rec['feed_loss']}")

    # (3) one crop whose rows span the ranks (--spatial_train): each rank
    # its block of rows with their context
    sh, sw = 8 * n, 64
    sp_batch = {
        "S2": rng.uniform(0, 4000, (1, sh, sw, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (1, sh, sw, 2)).astype(np.float32),
        "admin_mask": np.ones((1, sh, sw), np.float32),
        "census_idx": np.ones((1,), np.float32),
        "y": np.asarray([500.0], np.float32),
        "photometric": np.asarray([0.0, 1.0, 0.0, 1.0], np.float32),
    }
    sp_rows = shard_batch_spatial(sp_batch, mesh, row_keys=ROW_KEYS)
    _, _, aux_sp = step(params, opt_state,
                        {**_upload(sp_rows, dev, TRAIN_KEYS), "row_block": sp_rows["row_block"]},
                        torch.Generator().manual_seed(8))
    rec["sp_train_loss"] = float(aux_sp["optimization_loss"])
    _check(np.isfinite(rec["sp_train_loss"]), f"spatial-train dryrun loss {rec['sp_train_loss']}")

    # (4) the (data, ensemble) grid: 3 members over 'ensemble', the patch
    # batch's rows over 'data'
    ne = 4 if n % 4 == 0 else 2
    nd = n // ne
    mesh2 = make_mesh(nd, devices=devices, n_ensemble=ne)
    members = [scaled_tree(params, 1.0 + 0.01 * s) for s in range(3)]
    per = -(-len(members) // ne)
    local = members[mesh2.ensemble_index * per:(mesh2.ensemble_index + 1) * per]
    pb = max(2, nd)
    rows = mesh2.batch_rows(pb)
    patch = {"S2": np.repeat(batch["S2"][:1], pb, 0)[rows], "S1": np.repeat(batch["S1"][:1], pb, 0)[rows],
             "mask": np.ones((len(rows), h, w), np.float32), "valid": np.ones((len(rows),), bool)}
    with torch.no_grad():
        if local:
            fwd = make_patch_forward(mcfg, consts, NormStats(device=dev), len(local))
            dense = fwd(local, _upload(patch, dev))["dense_sum"]
        else:  # a padded slot holds no member
            dense = torch.zeros((len(rows), h, w), device=dev)
    mesh2.all_reduce(dense, "ensemble")
    rec["ensemble_dense_sum"] = float(mesh2.all_gather(dense, "data").double().sum())
    _check(np.isfinite(rec["ensemble_dense_sum"]), f"ensemble dryrun: {rec['ensemble_dense_sum']}")

    # (5) one whole frame, its rows over the ranks (infer/spatial.py)
    sp_h, sp_w = 4 * n * 2, 64  # 2 pooled rows a rank
    smap, sp_cnt = spatial_density_map(
        params, consts, mcfg, rng.uniform(0, 4000, (sp_h, sp_w, 4)).astype(np.float32),
        rng.uniform(-25, 0, (sp_h, sp_w, 2)).astype(np.float32), mesh)
    rec["spatial_shape"], rec["spatial_count"] = list(smap.shape), float(sp_cnt)
    _check(smap.shape == (sp_h, sp_w) and np.isfinite(sp_cnt), f"spatial dryrun bad: {rec}")
    if mesh.is_root:
        with open(out, "w") as f:
            json.dump(rec, f)


def dryrun_multichip(n_devices: int, device="cuda:0") -> dict:
    """Run ``n_devices`` (at least 2) ranks on ``device`` (each rank there:
    'cpu' for gloo CPU ranks, a card for ranks that share it) through every
    ranked path once; returns rank 0's results and prints them on one
    line. Raises when a rank's check fails."""
    from .data.synthetic import make_synthetic_region
    from .dist.launch import spawn_ranks
    from .dist.mesh import resolve_device

    if n_devices < 2:
        raise ValueError(f"dryrun_multichip({n_devices}): a dry run of ranks needs at least 2")
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="popcorn_dryrun_") as td:
        region = os.path.join(td, "region")
        make_synthetic_region(region, "rwa", height=128, width=192, n_regions=(4, 4), seed=3)
        out = os.path.join(td, "result.json")
        spawn_ranks(_multichip_rank, n_devices, (n_devices, [device] * n_devices, region, out),
                    devices=[device] * n_devices)
        with open(out) as f:
            rec = json.load(f)
    print(f"dryrun_multichip({n_devices}): OK, loss={rec['loss']:.4f}, "
          f"device_feed_dp_loss={rec['feed_loss'][1]:.4f}, sp_train_loss={rec['sp_train_loss']:.4f}, "
          f"ensemble_dense_sum={rec['ensemble_dense_sum']:.4f}, "
          f"spatial_count={rec['spatial_count']:.4f}", flush=True)
    return rec


def dryrun_multihost(num_processes: int = 2, local_devices: int = 1, device="cuda:0") -> dict:
    """The multi-process rehearsal with ``num_processes`` x ``local_devices``
    localhost workers (a port worker is one rank with one device; every
    worker on ``device``): one data-parallel train step whose batch spans
    the workers, and the 2-D Bag-of-POPCORN fold. Every worker's loss,
    popcount sum and ensemble sum must agree (rtol 1e-6). Returns them."""
    from .dist.mesh import resolve_device
    from .dist.multihost import launch_workers

    resolve_device(device)
    results = launch_workers(num_processes * local_devices, device=device)
    losses, pops, ens = (np.asarray(v) for v in zip(*results))
    _check(np.isfinite(losses).all(), f"non-finite multihost loss: {losses}")
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)
    np.testing.assert_allclose(pops, pops[0], rtol=1e-6)
    _check(np.isfinite(ens).all(), f"non-finite multihost ensemble sum: {ens}")
    np.testing.assert_allclose(ens, ens[0], rtol=1e-6)
    print(f"dryrun_multihost({num_processes}x{local_devices}): OK, loss={losses[0]:.4f}, "
          f"popcount_sum={pops[0]:.4f}, ensemble_dense_sum={ens[0]:.4f}", flush=True)
    return {"loss": losses.tolist(), "popsum": pops.tolist(), "enssum": ens.tolist()}

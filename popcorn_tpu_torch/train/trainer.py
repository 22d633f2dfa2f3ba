"""The weakly supervised training loop.

Counterpart of popcorn_tpu/train/trainer.py (reference run_train.py:43-476):
the epoch loop over census-region batches, memory-tiered gradient
freezing, weak validation, the in-training sliding-window test, StepLR and
``.pth`` checkpoint/resume. The feed chain is the JAX trainer's: the
device-resident feed (data/device_weaksup.py) when the region's stacks
fit, else its season-rotating form when the measured cost gate
(data/feed_select.py) prefers it, else the host ``WeaksupFeed``, whose
batches are uploaded pinned and asynchronously one batch ahead of the step
that uses them.

Data parallelism (``data_parallel > 1`` or ``multihost``, the JAX
trainer's mesh): this process is one rank of a (data,) grid
(dist/mesh.py). Every rank reads the same global batches (the feeds are
deterministic), pads one that does not split (``pad_batch_to_multiple``),
uploads only its rows (``shard_batch``; the device feed assembles only
them) and runs the data-parallel step (train/state.py). Rank 0 broadcasts
the parameters first, so replicas start equal; the logged popcounts and
targets are gathered; only rank 0 writes logs, checkpoints and maps.

Spatial training (``spatial_train``, the JAX trainer's row-sharded mesh):
the ranks of the grid split each crop's ROWS instead of the batch. Every
rank reads the same global batches from the host feed, uploads only its
rows and their context (``shard_batch_spatial``) and runs the spatial
step (train/state.py); the memory tiers count the whole crop, the batch
need not divide over the ranks, and the logged popcounts are the crops'.
The grid is ``data_parallel`` ranks, or without it the launched ranks (the
CLI spawns one a card), so one card is one rank and the plain step.
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..agg.census_agg import DeviceCensus, convert_popmap_to_census
from ..compat.weights import load_popcorn_from_dda, to_torch
from ..config import (
    NEED_ASCENDING_FILL,
    TESTLEVELS,
    DataPaths,
    ModelConfig,
    TrainConfig,
    find_dda_checkpoint,
)
from ..data.dataset import PopulationDataset
from ..data.device_weaksup import DeviceWeaksupFeed, Ineligible, resident_layout
from ..data.feed import WeaksupFeed
from ..data.feed_select import gate_mode, gate_report, gather_gate_inputs, prefer_rotation
from ..data.normalize import NormStats
from ..dist.launch import under_launcher
from ..dist.mesh import (
    devices_for,
    fetch_to_host,
    make_mesh,
    make_multihost_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
    shard_batch_spatial,
)
from ..infer.sliding import _upload, resolve_device, run_sliding_inference
from ..io.geotiff import GeoTIFF
from ..losses.losses import get_loss, r2
from ..losses.metrics import get_test_metrics
from ..nn.init import init_popcorn, init_prithvi_member
from ..nn.popcorn import check_config
from ..nn.prithvi import PRESETS as PRITHVI_PRESETS
from ..utils.log import MetricsLogger, NumberList, new_log
from ..utils.profiling import COUNTERS, SPANS, device_memory_stats, span
from . import adam
from . import checkpoint as ckpt
from .state import (
    keystr,
    make_eval_popcount,
    make_optimizer,
    make_train_step,
    set_learning_rate,
    step_lr,
    tree_flatten,
)

TRAIN_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask", "census_idx", "y",
              "photometric", "valid")
VAL_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask", "census_idx")
# the keys of a training batch that carry one row per sample
SHARD_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask", "census_idx", "y",
              "extent")
# the image keys whose rows split over the ranks under spatial training
# (popcorn_tpu/train/trainer.py's row_keys)
ROW_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask")


class _NoLogger:
    """The logger of a rank other than 0: rank 0 writes the records."""

    def log(self, metrics, step):
        pass

    def log_histogram(self, name, values, step, bins=64):
        pass


class Trainer:
    def __init__(
        self,
        paths: DataPaths,
        mcfg: ModelConfig,
        tcfg: TrainConfig,
        *,
        resume: Optional[str] = None,
        use_wandb: bool = False,
        inference_patch: int = 2048,
        inference_overlap: int = 128,
        test_patch_batch: int = 1,
        device="cuda",
        mesh=None,
    ):
        with span("trainer.init"):
            check_config(mcfg, spatial_train=tcfg.spatial_train)
            self.device = resolve_device(device)
            self.paths = paths
            self.mcfg = mcfg
            self.tcfg = tcfg
            self.inference_patch = inference_patch
            self.inference_overlap = inference_overlap
            self.test_patch_batch = test_patch_batch

            # data-parallel ranks: the batch's rows split over 'data' (or each
            # crop's rows under spatial training), the parameters replicated
            # (module docstring). Created before the feed so the device-resident
            # feed can assemble this rank's rows. ``mesh`` gives the grid (as
            # the Evaluator takes one: ranks that share a card); else it is
            # built from the config, as the CLI's ranks do.
            self.mesh = mesh
            if mesh is None and (tcfg.multihost or tcfg.data_parallel > 1
                                 or (tcfg.spatial_train and under_launcher())):
                n = tcfg.data_parallel if tcfg.data_parallel > 1 else None
                devs = devices_for(self.device)
                self.mesh = (make_multihost_mesh(n, devices=devs) if tcfg.multihost
                             else make_mesh(n, devices=devs))
            if self.mesh is not None:
                if not tcfg.spatial_train and tcfg.weak_batch_size % self.mesh.n_data:
                    raise ValueError(
                        f"weak_batch_size ({tcfg.weak_batch_size}) must be divisible "
                        f"by the data mesh size ({self.mesh.n_data})"
                    )
                self.device = self.mesh.device
            self.is_root = self.mesh is None or self.mesh.is_root

            args = {**dataclasses.asdict(mcfg), **dataclasses.asdict(tcfg)}
            if self.is_root:
                self.experiment_folder, _, _ = new_log(tcfg.save_dir, args)
                self.logger = MetricsLogger(self.experiment_folder, use_wandb=use_wandb)
            else:
                self.experiment_folder, self.logger = None, _NoLogger()
            if self.mesh is not None:
                self.experiment_folder = self.mesh.broadcast_object(self.experiment_folder)

            # datasets --------------------------------------------------------
            split = "train" if tcfg.weak_validation else "all"
            senb = mcfg.sentinel_buildings

            def weaksup(reg, lvl, **kw):
                return PopulationDataset(
                    paths, reg, mode="weaksup", train_level=lvl,
                    s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir, viirs=mcfg.viirs,
                    fourseasons=tcfg.fourseasons, max_samples=tcfg.max_weak_samples,
                    max_pix=tcfg.max_weak_pix, max_pix_box=tcfg.max_pix_box,
                    ascfill=reg in NEED_ASCENDING_FILL, patchsize=None, overlap=None,
                    sentinelbuildings=senb, **kw,
                )

            pairs = list(zip(tcfg.target_regions_train, tcfg.train_level))
            self.train_datasets = [weaksup(r, lv, split=split, asc_aug=tcfg.asc_aug)
                                   for r, lv in pairs]
            self.val_datasets = (
                [weaksup(r, lv, split="val", in_memory=tcfg.val_in_memory) for r, lv in pairs]
                if tcfg.weak_validation else []
            )
            self.test_datasets = [
                PopulationDataset(
                    paths, reg, mode="test", patchsize=inference_patch,
                    overlap=inference_overlap, s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir,
                    viirs=mcfg.viirs, fourseasons=False,
                    ascfill=reg in NEED_ASCENDING_FILL, sentinelbuildings=senb,
                )
                for reg in tcfg.target_regions
            ]

            with span("trainer.init.feed"):
                feed_kw = dict(
                    batch_size=tcfg.weak_batch_size, bucket_ladder=tcfg.bucket_ladder,
                    seed=tcfg.seed, building_input=mcfg.building_input,
                    segmentation_input=mcfg.segmentation_input, max_samples=tcfg.max_samples,
                    num_workers=tcfg.num_workers, transport=tcfg.transport,
                )
                self.feed_kw = feed_kw
                # the chosen feed ('resident', 'rotating' or 'host') and the cost
                # gate's report when it ran
                self.feed, self.feed_choice, self.gate_report = None, "host", None
                # the JAX trainer's gate: cross-host residency is unproven, and the
                # device feed assembles a batch's samples, not a crop's rows
                host_only = tcfg.multihost or tcfg.spatial_train
                if tcfg.device_feed == "on" and host_only:
                    raise Ineligible("--device_feed on requires a single-host run without "
                                     "--spatial_train (multihost and spatial batches are not "
                                     "assembled on the device)")
                if tcfg.device_feed != "off" and not host_only:
                    # device-resident data plane: mosaics upload once, batch
                    # assembly (crop + mask + geometric augs) runs on the device
                    try:
                        self.feed = self._agreed(lambda: DeviceWeaksupFeed(
                            self.train_datasets, device=self.device, mesh=self.mesh, **feed_kw))
                        self.feed_choice = "resident"
                        print("Training feed: device-resident mosaics")
                    except Ineligible as e:
                        if tcfg.device_feed == "on":
                            raise
                        # middle path: regions whose full multi-season stack does
                        # not fit rotate one season's slice at a time
                        try:
                            self.feed = self._maybe_rotating_feed(feed_kw, e)
                            self.feed_choice = "rotating"
                        except Ineligible as e2:
                            print(f"Device training feed unavailable ({e}; rotation: {e2}); "
                                  "using host feed")
                if self.feed is None:
                    self.feed = WeaksupFeed(self.train_datasets, **feed_kw)

            # model -----------------------------------------------------------
            with span("trainer.init.model"):
                if mcfg.feature_extractor in PRITHVI_PRESETS:
                    params, consts = init_prithvi_member(tcfg.seed, mcfg, self.device)
                elif mcfg.pretrained and find_dda_checkpoint():
                    params, consts = load_popcorn_from_dda(mcfg, head_seed=tcfg.seed)
                else:
                    params, consts = init_popcorn(tcfg.seed, mcfg)
                # replicas start equal: rank 0's parameters on every rank
                self.params = replicate(to_torch(params, self.device), self.mesh)
                self.consts = replicate(to_torch(consts, self.device), self.mesh)
                n_params = sum(v.numel() for _, v in tree_flatten(self.params))
                print(f"Model POPCORN; #Effective Params trainable: {n_params}")

                self.stats = NormStats(device=self.device)
                self.optimizer = make_optimizer(tcfg)
                self.opt_state = self.optimizer.init(self.params)
                self.step_fn = make_train_step(mcfg, tcfg, self.consts, self.stats, self.optimizer,
                                               mesh=self.mesh)
                self.eval_popcount = make_eval_popcount(mcfg, self.consts, self.stats)

                self.info = {"epoch": 0, "iter": 0, "sampleitr": 0}
                self.pred_buffer = NumberList(300)
                self.target_buffer = NumberList(300)
                self.best_optimization_loss = float("inf")
                # draws the sparsity mask's lattice (on the host: a few hundred
                # indices a step)
                self.generator = torch.Generator().manual_seed(tcfg.seed + 1)
                self._val_feeds: Dict[int, WeaksupFeed] = {}

                if resume is not None:
                    self.resume(resume)

    def _agreed(self, build):
        """``build()``'s feed when every rank built one, else Ineligible on
        every rank (free device memory differs between ranks that share a
        card), so all ranks take the same feed."""
        feed, err = None, None
        try:
            feed = build()
        except Ineligible as e:
            err = e
        if self.mesh is not None and not self.mesh.all_true(feed is not None):
            raise err or Ineligible("the device feed does not fit on every rank")
        if err is not None:
            raise err
        return feed

    def _maybe_rotating_feed(self, feed_kw, reason) -> DeviceWeaksupFeed:
        """The season-rotating device feed, or Ineligible when its slice
        does not fit — or when the MEASURED cost gate says the host feed
        would finish the epoch faster (rotation's per-epoch slice
        re-uploads are a fixed cost that only amortizes past enough
        samples an epoch)."""
        mode = self.tcfg.feed_gate
        env = gate_mode()
        if env != "auto":
            mode = env  # the environment wins (tests / operators)
        if mode == "host":
            raise Ineligible("feed gate forced host (feed_gate=host)")
        if mode != "off":
            lay = resident_layout(self.train_datasets, feed_kw["bucket_ladder"],
                                  feed_kw["transport"])
            probe = WeaksupFeed(self.train_datasets, **feed_kw)
            n = len(probe.index)
            if feed_kw["max_samples"] is not None:
                n = min(n, feed_kw["max_samples"])
            g = gather_gate_inputs(probe, n_samples=n,
                                   swap_bytes=lay["slice_bytes"] * len(lay["seasons"]),
                                   device=self.device)
            self.gate_report = gate_report(g)
            prefer = prefer_rotation(g)
            if self.mesh is not None:
                prefer = self.mesh.broadcast_object(prefer)  # rank 0's measurement decides
            if not prefer:
                raise Ineligible("cost gate picked host feed: " + self.gate_report)
            print(f"Feed cost gate: {self.gate_report} -> rotation")
        feed = self._agreed(lambda: DeviceWeaksupFeed(
            self.train_datasets, rotate=True, device=self.device, mesh=self.mesh, **feed_kw))
        print(f"Training feed: season-rotating device residency (full stack ineligible: {reason})")
        return feed

    # -- persistence ---------------------------------------------------------

    def save_model(self, prefix: str = "last") -> Optional[str]:
        """Write the checkpoint (rank 0 only: the replicas are equal)."""
        if not self.is_root:
            return None
        path = os.path.join(self.experiment_folder, f"{prefix}_model.pth")
        ckpt.save_checkpoint(
            path, self.params, self.consts, self.opt_state,
            epoch=self.info["epoch"] + 1, iteration=self.info["iter"],
        )
        return path

    def resume(self, path: str, load_optimizer: bool = True):
        state = ckpt.restore_checkpoint(path, self.device)
        self.params = state["params"]
        if load_optimizer and state["opt_state"] is not None:
            self.opt_state = state["opt_state"]
        self.info["epoch"] = state["epoch"]
        self.info["iter"] = state["iter"]

    # -- training ------------------------------------------------------------

    def _tier_flags(self, batch) -> Optional[Dict[str, bool]]:
        """Memory-tiered gradient freezing (run_train.py:190-198), by the
        global batch's pixels."""
        some = "S2" if "S2" in batch else "S1"
        b, h, w = batch[some].shape[:3]
        if "rows" in batch:  # this rank's rows of a global batch
            b *= self.mesh.n_data
        num_pix = b * h * w
        enc, unet = False, False
        if num_pix > self.tcfg.limit1:
            enc, unet = True, False
            if num_pix > self.tcfg.limit2:
                enc, unet = True, True
                if num_pix > self.tcfg.limit3:
                    return None  # skip sample
        return {"encoder_no_grad": enc, "unet_no_grad": unet}

    def _lookahead_batches(self, epoch: int):
        """Yield (dev_batch, host_batch, tier_flags): the NEXT batch's
        upload is issued before the current step runs, so the copy
        overlaps compute. Tier-skipped batches are dropped before their
        upload."""
        prev = None
        n_micro = max(1, int(self.tcfg.grad_accum))
        for batch in self.feed.epoch(epoch):
            flags = self._tier_flags(batch)
            if flags is None:
                continue
            if self.tcfg.spatial_train:
                batch = shard_batch_spatial(batch, self.mesh, row_keys=ROW_KEYS)
            elif self.mesh is not None and "rows" not in batch:
                batch = shard_batch(
                    pad_batch_to_multiple(batch, self.mesh.n_data * n_micro, SHARD_KEYS),
                    self.mesh, batch_keys=SHARD_KEYS, n_micro=n_micro,
                )
            with span("trainer.upload"):
                dev_batch = _upload(batch, self.device, TRAIN_KEYS)
            for k in ("row_block", "extent"):  # host values the step reads
                if k in batch:
                    dev_batch[k] = batch[k]
            nxt = (dev_batch, batch, flags)
            if prev is not None:
                yield prev
            prev = nxt
        if prev is not None:
            yield prev

    def train_epoch(self) -> Dict[str, float]:
        stats = defaultdict(float)
        nlog = 0
        for i, (dev_batch, batch, flags) in enumerate(self._lookahead_batches(self.info["epoch"])):
            collect_watch = (
                self.tcfg.watch_every > 0 and self.info["iter"] % self.tcfg.watch_every == 0
            )
            new_params, new_opt_state, aux = self.step_fn(
                self.params, self.opt_state, dev_batch, self.generator,
                collect_watch=collect_watch, **flags,
            )
            if not (self.tcfg.skip_first and self.info["epoch"] == 0):
                # --skip-first: run the full step but discard the update
                # during epoch 0 (arguments/train.py:42)
                self.params, self.opt_state = new_params, new_opt_state
            watch = aux.pop("watch", None)
            # the host's wait for the step: its loss, counts and logged values
            with span("trainer.readback"):
                loss = float(aux["optimization_loss"])
                if np.isnan(loss):
                    raise FloatingPointError("detected NaN loss..")
                if np.isinf(loss):
                    raise FloatingPointError("detected Inf loss..")
                pred, target = aux.pop("popcount"), dev_batch["y"]
                if self.mesh is not None and "row_block" not in batch:
                    # every rank's rows, in rank order (the JAX trainer's
                    # fetch_to_host of the sharded popcount)
                    valid = batch.get("valid", np.ones(len(pred), bool))
                    keep = fetch_to_host(torch.as_tensor(valid, dtype=torch.uint8),
                                         self.mesh).astype(bool)
                    pred = fetch_to_host(pred, self.mesh)[keep]
                    target = fetch_to_host(torch.as_tensor(target).float(), self.mesh)[keep]
                else:
                    pred, target = pred.cpu().numpy(), np.asarray(batch["y"])
                self.pred_buffer.add(pred)
                self.target_buffer.add(target)
                for k, v in aux.items():
                    stats[k] += float(v)
            if watch is not None:
                self.log_watch(watch)
            nlog += 1
            self.info["iter"] += 1
            self.info["sampleitr"] += self.tcfg.weak_batch_size

            # mid-epoch validation / target test (run_train.py:255-265)
            if self.tcfg.weak_validation and (i + 1) % self.tcfg.val_every_i_steps == 0:
                self.validate_weak()
            if (i + 1) % self.tcfg.test_every_i_steps == 0:
                self.test_target(save=True)

            if (i + 1) % max(1, min(self.tcfg.logstep_train, len(self.feed))) == 0:
                self.log_train(stats, nlog)
                stats, nlog = defaultdict(float), 0
        if nlog:
            self.log_train(stats, nlog)
        return stats

    def log_watch(self, grad_norms: Dict[str, torch.Tensor]):
        """wandb.watch equivalent (reference run_train.py:75): per-layer
        gradient norms as scalars + parameter histograms."""
        self.logger.log({f"grad_norm{k}": float(v) for k, v in grad_norms.items()}, self.info["iter"])
        for path, leaf in tree_flatten(self.params):
            self.logger.log_histogram(f"param{keystr(path)}", leaf.cpu().numpy(), self.info["iter"])

    def log_train(self, stats, nlog):
        out = {k: v / max(nlog, 1) for k, v in stats.items()}
        if len(self.pred_buffer.get()) > 1:
            out["Population_weak/r2"] = float(
                r2(torch.tensor(self.pred_buffer.get()), torch.tensor(self.target_buffer.get()))
            )
        self.logger.log({f"{k}/train": v for k, v in out.items()}, self.info["iter"])

    def train(self):
        for _ in range(self.info["epoch"], self.tcfg.num_epochs):
            adam_before = adam.launches
            self.train_epoch()
            # device memory per epoch (the reference's gpu_used GB,
            # run_train.py:39-40, 156-158)
            mem = device_memory_stats(self.device)
            if mem:
                self.logger.log(mem, self.info["iter"])
            # the epoch's median ms of each program span and its totals of
            # each program counter (utils/profiling.py), and its launches of
            # the optimizer kernel (one a step on a card)
            times = SPANS.summary()
            if times:
                self.logger.log({**{f"time/{k}_ms": v["median_ms"] for k, v in times.items()},
                                 **COUNTERS.summary(),
                                 "launches/adam": adam.launches - adam_before},
                                self.info["iter"])
            SPANS.reset()
            COUNTERS.reset()
            if self.tcfg.save_model in ("last", "both"):
                self.save_model("last")
            if (self.info["epoch"] + 1) % self.tcfg.val_every_n_epochs == 0:
                if self.tcfg.weak_validation:
                    self.validate_weak()
                self.test_target(save=True)
            if self.tcfg.lr_gamma != 1.0:
                lr = step_lr(self.tcfg.learning_rate, self.info["epoch"] + 1,
                             self.tcfg.lr_step, self.tcfg.lr_gamma)
                self.opt_state = set_learning_rate(self.opt_state, lr)
                self.logger.log({"log_lr": float(np.log10(lr))}, self.info["iter"])
            self.info["epoch"] += 1

    # -- evaluation ------------------------------------------------------------

    def validate_weak(self) -> Dict[str, float]:
        out = {}
        all_preds, all_gts = [], []
        for ds in self.val_datasets:
            preds, gts = [], []
            for batch in self._val_feed(ds).epoch(0):
                dev_batch = _upload(batch, self.device, VAL_KEYS)
                if "extent" in batch:
                    dev_batch["extent"] = batch["extent"]
                preds.append(self.eval_popcount(self.params, dev_batch).cpu().numpy())
                gts.append(batch["y"])
            if not preds:
                continue
            pred, gt = np.concatenate(preds), np.concatenate(gts)
            all_preds.append(pred)
            all_gts.append(gt)
            out.update(get_test_metrics(pred, gt, tag=f"MainCensus_{ds.region}_{ds.train_level}"))
        if all_preds:
            # the validation optimization loss (the configured loss x
            # lam_weak) drives --save-model best
            vloss, _ = get_loss(
                torch.from_numpy(np.concatenate(all_preds)),
                torch.from_numpy(np.concatenate(all_gts)),
                loss=self.tcfg.loss, lam=self.tcfg.lam,
            )
            vloss = float(vloss) * self.tcfg.lam_weak
            out["optimization_loss"] = vloss
            if vloss < self.best_optimization_loss:
                self.best_optimization_loss = vloss
                if self.tcfg.save_model in ("best", "both"):
                    self.save_model("best")
        self.logger.log({f"{k}/val": v for k, v in out.items()}, self.info["iter"])
        return out

    def _val_feed(self, ds) -> WeaksupFeed:
        """One cached validation feed per dataset: building one per call
        re-reads every raster. With a device-resident training feed it
        shares that feed's stacks (the same mosaics, another census
        split) instead of reading every val window on the host."""
        key = id(ds)
        if key not in self._val_feeds:
            vkw = dict(
                batch_size=self.tcfg.weak_val_batch_size,
                bucket_ladder=self.tcfg.bucket_ladder, seed=self.tcfg.seed,
                augment=False, drop_last=False,
                building_input=self.mcfg.building_input,
                segmentation_input=self.mcfg.segmentation_input,
                num_workers=self.tcfg.num_workers, transport=self.tcfg.transport,
            )
            feed = None
            if isinstance(self.feed, DeviceWeaksupFeed):
                try:
                    feed = DeviceWeaksupFeed([ds], resident_from=self.feed, **vkw)
                except Ineligible:
                    pass
            self._val_feeds[key] = feed if feed is not None else WeaksupFeed([ds], **vkw)
        return self._val_feeds[key]

    def test_target(self, save: bool = False) -> Dict[str, float]:
        """In-training sliding-window test (run_train.py:314-370) through
        the eval path (infer/sliding.py); the maps and the census
        aggregation stay on the device unless the region is above the
        device-stitch budget. Under a mesh the patches split over the
        ranks and rank 0 alone holds the maps and the metrics."""
        out = {}
        for ds in self.test_datasets:
            maps = run_sliding_inference(
                [self.params], self.consts, self.mcfg, ds, stats=self.stats,
                batch_size=self.test_patch_batch, num_workers=self.tcfg.num_workers,
                device=self.device, return_device=True, transport=self.tcfg.transport,
                device_feed="off" if self.tcfg.device_feed == "off" or self.mesh else "auto",
                mesh=self.mesh,
            )
            if maps is None:  # a rank other than 0
                continue
            # a region above the device-stitch budget comes back stitched
            # on the host, as numpy maps
            on_dev = isinstance(maps["map"], torch.Tensor)
            if save:
                host = {k: maps[k].cpu().numpy() if on_dev else maps[k] for k in ("map", "scale")}
                ds.save(host["map"], self.experiment_folder)
                if self.mcfg.occupancy_model:
                    ds.save(host["scale"], self.experiment_folder, tag=f"SCALE_{ds.region}")
            for level in TESTLEVELS.get(ds.region, ["coarse"]):
                import pandas as pd

                with GeoTIFF(ds.boundary_paths[level]) as g:
                    boundary = g.read(1, squeeze=True)
                census = pd.read_csv(ds.census_paths[level])
                if on_dev:
                    pred_c, gt_c = DeviceCensus(boundary, census, self.device).convert(maps["map"])
                else:
                    pred_c, gt_c = convert_popmap_to_census(maps["map"], boundary, census)
                out.update(get_test_metrics(pred_c, gt_c, tag=f"MainCensus_{ds.region}_{level}"))
        self.logger.log({f"{k}/targettest": v for k, v in out.items()}, self.info["iter"])
        return out

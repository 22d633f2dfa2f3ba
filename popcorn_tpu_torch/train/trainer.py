"""The weakly supervised training loop.

Counterpart of popcorn_tpu/train/trainer.py (reference run_train.py:43-476):
the epoch loop over census-region batches from the host ``WeaksupFeed``,
memory-tiered gradient freezing, weak validation, the in-training
sliding-window test, StepLR and ``.pth`` checkpoint/resume. Batches are
uploaded pinned and asynchronously one batch ahead of the step that uses
them. Not ported yet: the device-resident feeds (ROADMAP.md Queue 1 item
13) and the multi-device mesh / spatial training (items 16 and 17);
``TrainConfig.check`` raises for them.
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..agg.census_agg import DeviceCensus
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
from ..data.feed import WeaksupFeed
from ..data.normalize import NormStats
from ..infer.sliding import _upload, resolve_device, run_sliding_inference
from ..io.geotiff import GeoTIFF
from ..losses.losses import get_loss, r2
from ..losses.metrics import get_test_metrics
from ..nn.init import init_popcorn
from ..nn.popcorn import check_config
from ..utils.log import MetricsLogger, NumberList, new_log
from ..utils.profiling import device_memory_stats
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

TRAIN_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask", "census_idx", "y", "photometric")
VAL_KEYS = ("S2", "S1", "VIIRS", "building_counts", "admin_mask", "census_idx")


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
    ):
        tcfg.check()
        check_config(mcfg)
        self.device = resolve_device(device)
        self.paths = paths
        self.mcfg = mcfg
        self.tcfg = tcfg
        self.inference_patch = inference_patch
        self.inference_overlap = inference_overlap
        self.test_patch_batch = test_patch_batch

        args = {**dataclasses.asdict(mcfg), **dataclasses.asdict(tcfg)}
        self.experiment_folder, _, _ = new_log(tcfg.save_dir, args)
        self.logger = MetricsLogger(self.experiment_folder, use_wandb=use_wandb)

        # datasets ------------------------------------------------------------
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
        self.train_datasets = [weaksup(r, lv, split=split, asc_aug=tcfg.asc_aug) for r, lv in pairs]
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

        if tcfg.device_feed == "auto":
            print("Training feed: host (the device-resident feed is not ported "
                  "yet, ROADMAP.md Queue 1 item 13)")
        self.feed = WeaksupFeed(
            self.train_datasets, batch_size=tcfg.weak_batch_size,
            bucket_ladder=tcfg.bucket_ladder, seed=tcfg.seed,
            building_input=mcfg.building_input, segmentation_input=mcfg.segmentation_input,
            max_samples=tcfg.max_samples, num_workers=tcfg.num_workers,
        )

        # model ---------------------------------------------------------------
        if mcfg.pretrained and find_dda_checkpoint():
            params, consts = load_popcorn_from_dda(mcfg, head_seed=tcfg.seed)
        else:
            params, consts = init_popcorn(tcfg.seed, mcfg)
        self.params = to_torch(params, self.device)
        self.consts = to_torch(consts, self.device)
        n_params = sum(v.numel() for _, v in tree_flatten(self.params))
        print(f"Model POPCORN; #Effective Params trainable: {n_params}")

        self.stats = NormStats(device=self.device)
        self.optimizer = make_optimizer(tcfg)
        self.opt_state = self.optimizer.init(self.params)
        self.step_fn = make_train_step(mcfg, tcfg, self.consts, self.stats, self.optimizer)
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

    # -- persistence ---------------------------------------------------------

    def save_model(self, prefix: str = "last") -> str:
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
        """Memory-tiered gradient freezing (run_train.py:190-198)."""
        some = "S2" if "S2" in batch else "S1"
        b, h, w = batch[some].shape[:3]
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
        for batch in self.feed.epoch(epoch):
            flags = self._tier_flags(batch)
            if flags is None:
                continue
            nxt = (_upload(batch, self.device, TRAIN_KEYS), batch, flags)
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
            loss = float(aux["optimization_loss"])
            if np.isnan(loss):
                raise FloatingPointError("detected NaN loss..")
            if np.isinf(loss):
                raise FloatingPointError("detected Inf loss..")

            watch = aux.pop("watch", None)
            if watch is not None:
                self.log_watch(watch)
            self.pred_buffer.add(aux.pop("popcount").cpu().numpy())
            self.target_buffer.add(np.asarray(batch["y"]))
            for k, v in aux.items():
                stats[k] += float(v)
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
            self.train_epoch()
            # device memory per epoch (the reference's gpu_used GB,
            # run_train.py:39-40, 156-158)
            mem = device_memory_stats(self.device)
            if mem:
                self.logger.log(mem, self.info["iter"])
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
        re-reads every raster."""
        key = id(ds)
        if key not in self._val_feeds:
            self._val_feeds[key] = WeaksupFeed(
                [ds], batch_size=self.tcfg.weak_val_batch_size,
                bucket_ladder=self.tcfg.bucket_ladder, seed=self.tcfg.seed,
                augment=False, drop_last=False,
                building_input=self.mcfg.building_input,
                segmentation_input=self.mcfg.segmentation_input,
                num_workers=self.tcfg.num_workers,
            )
        return self._val_feeds[key]

    def test_target(self, save: bool = False) -> Dict[str, float]:
        """In-training sliding-window test (run_train.py:314-370) through
        the eval path (infer/sliding.py); the maps and the census
        aggregation stay on the device."""
        out = {}
        for ds in self.test_datasets:
            maps = run_sliding_inference(
                [self.params], self.consts, self.mcfg, ds, stats=self.stats,
                batch_size=self.test_patch_batch, num_workers=self.tcfg.num_workers,
                device=self.device, return_device=True,
            )
            if save:
                ds.save(maps["map"].cpu().numpy(), self.experiment_folder)
                if self.mcfg.occupancy_model:
                    ds.save(maps["scale"].cpu().numpy(), self.experiment_folder,
                            tag=f"SCALE_{ds.region}")
            for level in TESTLEVELS.get(ds.region, ["coarse"]):
                import pandas as pd

                with GeoTIFF(ds.boundary_paths[level]) as g:
                    boundary = g.read(1, squeeze=True)
                census = pd.read_csv(ds.census_paths[level])
                pred_c, gt_c = DeviceCensus(boundary, census, self.device).convert(maps["map"])
                out.update(get_test_metrics(pred_c, gt_c, tag=f"MainCensus_{ds.region}_{level}"))
        self.logger.log({f"{k}/targettest": v for k, v in out.items()}, self.info["iter"])
        return out

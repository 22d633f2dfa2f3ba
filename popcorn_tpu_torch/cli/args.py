"""CLI arguments: the flags of run_eval.py and run_train.py (the
reference's arguments/eval.py:3-27 and arguments/train.py:8-61 plus the
data-root, patch-geometry and device flags), and the port's own
``model_config_from_args``, ``eval_config_from_args`` and
``train_config_from_args``. Config files are supported via @file syntax."""

from __future__ import annotations

import argparse

from ..config import EvalConfig, ModelConfig, TrainConfig


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--data_root", type=str, default=None,
                   help="PopMapData root (default: $POPCORN_DATA)")
    p.add_argument("-treg", "--target_regions", nargs="+", default=["rwa"])
    p.add_argument("-S1", "--Sentinel1", action="store_true")
    p.add_argument("-S2", "--Sentinel2", action="store_true")
    p.add_argument("-NIR", "--NIR", action="store_true")
    p.add_argument("-VIIRS", "--VIIRS", action="store_true",
                   help="read+normalize VIIRS nightlights as an extra input channel")
    p.add_argument("-m", "--model", type=str, default="POPCORN")
    p.add_argument("-occmodel", "--occupancymodel", action="store_true")
    p.add_argument("-binp", "--buildinginput", action="store_true")
    p.add_argument("-sinp", "--segmentationinput", action="store_true")
    p.add_argument("-senbuilds", "--sentinelbuildings", action="store_true")
    p.add_argument("-fe", "--feature_extractor", type=str, default="DDA")
    p.add_argument("-pret", "--pretrained", action="store_true")
    p.add_argument("-binit", "--biasinit", type=float, default=0.75)
    p.add_argument("-tlevel", "--train_level", nargs="+", default=["coarse"])
    p.add_argument("-wp", "--wandb_project", type=str, default="POPCORN")
    p.add_argument("--wandb", action="store_true", help="mirror metrics to wandb")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="the port's kernels run float32; bfloat16 is not ported yet")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a card) or 'cpu'")


def eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="POPCORN ensemble evaluation (PyTorch/CUDA port)",
        fromfile_prefix_chars="@",
    )
    _add_common(p)
    p.add_argument("-r", "--resume", nargs="+", required=True,
                   help="ensemble member checkpoints (.pth in the reference format)")
    p.add_argument("-fs", "--fourseasons", action="store_true")
    p.add_argument("--seed", type=int, default=1610)
    p.add_argument("--save-dir", dest="save_dir", default="./results")
    p.add_argument("-w", "--num_workers", type=int, default=8)
    p.add_argument("--patch_batch", type=int, default=1)
    p.add_argument("--full", action="store_true", help="write detail maps")
    p.add_argument("--in_memory", action="store_true",
                   help="preload mosaics into RAM (reference arguments/eval.py:26)")
    p.add_argument("--patchsize", type=int, default=2048,
                   help="sliding-window patch size (reference "
                        "inference_patch_size=2048, utils/constants.py:12)")
    p.add_argument("--patch_overlap", type=int, default=128,
                   help="sliding-window halo (reference overlap=128)")
    return p


def train_parser() -> argparse.ArgumentParser:
    """The flags of run_train.py (popcorn_tpu/cli/args.py::train_parser).
    Flags of features the port does not run yet are accepted by the parser
    and raise in ``train_config_from_args``/``check_train_args``, naming
    the ROADMAP item that ports them; none is ignored silently."""
    p = argparse.ArgumentParser(
        description="POPCORN training (PyTorch/CUDA port)", fromfile_prefix_chars="@"
    )
    _add_common(p)
    p.add_argument("--fused_head", action="store_true", default=None,
                   help="accepted: the port's head always runs fused (kernels C and D)")
    p.add_argument("--no_fused_head", dest="fused_head", action="store_false",
                   help="raises: the port has no unfused head on the card")
    p.add_argument("--remat", dest="remat_unet", action="store_true",
                   help="recompute the trainable UNet blocks' activations in the "
                        "backward (torch.utils.checkpoint)")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="> 1 raises: not ported yet (ROADMAP.md Queue 1 item 16)")
    p.add_argument("--ensemble_parallel", type=int, default=1,
                   help="> 1 raises: not ported yet (ROADMAP.md Queue 1 item 16)")
    p.add_argument("--multihost", action="store_true",
                   help="raises: not ported yet (ROADMAP.md Queue 1 item 16)")
    p.add_argument("--compile_cache", nargs="?", const="", default=None, metavar="DIR",
                   help="accepted and ignored: PyTorch runs eagerly, there is no "
                        "XLA program to cache (the kernels are cached in "
                        "popcorn_tpu_torch/build/)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise at the op that "
                        "produced a NaN (the reference's anomaly detection)")
    p.add_argument("-r", "--resume", type=str, default=None)
    p.add_argument("-tregtrain", "--target_regions_train", nargs="+", default=["rwa"])
    p.add_argument("-wb", "--weak_batch_size", type=int, default=2)
    p.add_argument("--spatial_train", action="store_true",
                   help="raises: not ported yet (ROADMAP.md Queue 1 item 17)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update: same effective batch, "
                        "~N x less activation memory")
    p.add_argument("-wvb", "--weak_val_batch_size", type=int, default=1)
    p.add_argument("-e", "--num_epochs", type=int, default=100)
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    p.add_argument("-l", "--loss", nargs="+", default=["log_l1_loss"])
    p.add_argument("-sreg", "--scale_regularization", type=float, default=0.01)
    p.add_argument("-la", "--lam", nargs="+", type=float, default=[1.0])
    p.add_argument("-lw", "--lam_weak", type=float, default=100.0)
    p.add_argument("-lim1", "--limit1", type=int, default=9_000_000)
    p.add_argument("-lim2", "--limit2", type=int, default=9_000_000)
    p.add_argument("-lim3", "--limit3", type=int, default=13_000_000)
    p.add_argument("-wd", "--weightdecay", type=float, default=0.0)
    p.add_argument("-lrs", "--lr_step", type=int, default=5)
    p.add_argument("-lrg", "--lr_gamma", type=float, default=0.75)
    p.add_argument("-gc", "--gradient_clip", type=float, default=0.01)
    p.add_argument("-ascAug", "--ascAug", action="store_true")
    p.add_argument("--save_dir", default="outputs")
    p.add_argument("-w", "--num_workers", type=int, default=6)
    p.add_argument("-lt", "--logstep_train", type=int, default=25)
    p.add_argument("-val", "--val_every_n_epochs", type=int, default=2)
    p.add_argument("-wv", "--weak_validation", action="store_true")
    p.add_argument("-vi", "--val_every_i_steps", type=int, default=500_000)
    p.add_argument("-testi", "--test_every_i_steps", type=int, default=500_000)
    p.add_argument("--seed", type=int, default=1600)
    p.add_argument("--save-model", dest="save_model", default="both",
                   choices=["last", "best", "no", "both"])
    p.add_argument("--skip-first", dest="skip_first", action="store_true",
                   help="don't optimize during the first epoch")
    p.add_argument("-ms", "--max_samples", type=int, default=None,
                   help="cap on weak samples drawn per epoch")
    p.add_argument("--val_in_memory", action="store_true",
                   help="preload validation rasters into host RAM")
    p.add_argument("--watch_every", type=int, default=0,
                   help=">0: log per-layer gradient norms and parameter "
                        "histograms every N iters (reference wandb.watch)")
    p.add_argument("-mws", "--max_weak_samples", type=int, default=None)
    p.add_argument("-mwp", "--max_weak_pix", type=int, default=10_000_000)
    p.add_argument("-mpb", "--max_pix_box", type=int, default=12_000_000)
    p.add_argument("--device_feed", choices=("auto", "on", "off"), default="auto",
                   help="auto/off: the host feed; on raises (the device-resident "
                        "feed is ROADMAP.md Queue 1 item 13)")
    p.add_argument("--quantize_eval", choices=["int8", "int8s", "w4a8"], default=None,
                   help="raises: quantized eval is not ported yet (ROADMAP.md "
                        "Queue 1 item 11)")
    p.add_argument("--feed_gate", choices=("auto", "off", "host"), default="auto",
                   help="auto/host: the host feed; off (keep the season-rotating "
                        "feed) raises (ROADMAP.md Queue 1 item 13)")
    p.add_argument("--transport", choices=("exact", "bf16"), default="exact",
                   help="bf16 raises: not ported yet (ROADMAP.md Queue 1 item 13)")
    return p


def check_train_args(a) -> None:
    """Raise for the train flags whose feature the port does not run yet
    (the TrainConfig fields are checked by TrainConfig.check)."""
    if a.fused_head is False:
        raise NotImplementedError(
            "--no_fused_head: the port's head always runs fused (kernels C and D)"
        )
    if a.ensemble_parallel > 1:
        raise NotImplementedError(
            "--ensemble_parallel > 1 is not ported yet (ROADMAP.md Queue 1 item 16)"
        )
    if a.quantize_eval is not None:
        raise NotImplementedError(
            f"--quantize_eval {a.quantize_eval} is not ported yet (ROADMAP.md Queue 1 item 11)"
        )


def model_config_from_args(a) -> ModelConfig:
    return ModelConfig(
        s1=a.Sentinel1,
        s2=a.Sentinel2,
        nir=a.NIR,
        viirs=a.VIIRS,
        occupancy_model=a.occupancymodel,
        pretrained=a.pretrained,
        biasinit=a.biasinit,
        sentinel_buildings=a.sentinelbuildings,
        building_input=a.buildinginput,
        segmentation_input=a.segmentationinput,
        feature_extractor=a.feature_extractor,
        compute_dtype=a.compute_dtype,
        remat_unet=getattr(a, "remat_unet", False),
    )


def train_config_from_args(a) -> TrainConfig:
    tcfg = TrainConfig(
        target_regions=tuple(a.target_regions),
        target_regions_train=tuple(a.target_regions_train),
        train_level=tuple(a.train_level),
        weak_batch_size=a.weak_batch_size,
        weak_val_batch_size=a.weak_val_batch_size,
        num_epochs=a.num_epochs,
        learning_rate=a.learning_rate,
        loss=tuple(a.loss),
        lam=tuple(a.lam),
        lam_weak=a.lam_weak,
        scale_regularization=a.scale_regularization,
        weight_decay=a.weightdecay,
        lr_step=a.lr_step,
        lr_gamma=a.lr_gamma,
        gradient_clip=a.gradient_clip,
        seed=a.seed,
        limit1=a.limit1,
        limit2=a.limit2,
        limit3=a.limit3,
        max_weak_samples=a.max_weak_samples,
        max_weak_pix=a.max_weak_pix,
        max_pix_box=a.max_pix_box,
        weak_validation=a.weak_validation,
        val_every_n_epochs=a.val_every_n_epochs,
        val_every_i_steps=a.val_every_i_steps,
        test_every_i_steps=a.test_every_i_steps,
        logstep_train=a.logstep_train,
        asc_aug=a.ascAug,
        save_dir=a.save_dir,
        num_workers=a.num_workers,
        save_model=a.save_model,
        skip_first=a.skip_first,
        max_samples=a.max_samples,
        val_in_memory=a.val_in_memory,
        data_parallel=a.data_parallel,
        multihost=a.multihost,
        watch_every=a.watch_every,
        device_feed=a.device_feed,
        spatial_train=a.spatial_train,
        grad_accum=_validated_grad_accum(a),
        transport=a.transport,
        feed_gate=a.feed_gate,
    )
    tcfg.check()
    return tcfg


def _validated_grad_accum(a) -> int:
    """--grad_accum must divide the batch size, else every full batch would
    silently take the single-shot path meant for an indivisible tail batch
    and the flag's memory saving never materializes."""
    accum = max(1, a.grad_accum)
    wb = a.weak_batch_size
    if accum > 1 and wb and wb % accum != 0:
        raise SystemExit(
            f"--grad_accum {accum} does not divide --weak_batch_size {wb}: "
            "full batches would run un-accumulated (no memory saving). "
            "Pick a divisor of the batch size."
        )
    return accum


def eval_config_from_args(a) -> EvalConfig:
    return EvalConfig(
        target_regions=tuple(a.target_regions),
        train_level=tuple(a.train_level),
        checkpoints=tuple(a.resume),
        fourseasons=a.fourseasons,
        seed=a.seed,
        save_dir=a.save_dir,
        num_workers=a.num_workers,
        patch_batch=a.patch_batch,
        in_memory=a.in_memory,
        patchsize=a.patchsize,
        overlap=a.patch_overlap,
    )

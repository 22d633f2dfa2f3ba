"""CLI arguments: the flags of run_eval.py and run_train.py (the
reference's arguments/eval.py:3-27 and arguments/train.py:8-61 plus the
data-root, patch-geometry and device flags), and the port's own
``model_config_from_args``, ``eval_config_from_args`` and
``train_config_from_args``. Config files are supported via @file syntax."""

from __future__ import annotations

import argparse

from ..config import EvalConfig, ModelConfig, TrainConfig


TRANSPORT_HELP = ("data-plane dtype of the float image modalities: bf16 halves "
                  "S1's upload bytes and residency (lossy, census r2 within 0.02)")


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
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="the UNets' and the eval head's compute dtype (default "
                        "bfloat16, as run_eval.py/run_train.py); float32 for "
                        "parity with the reference")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a card) or 'cpu'")


def _add_runtime(p: argparse.ArgumentParser, train: bool):
    """The JAX parsers' runtime flags (popcorn_tpu/cli/args.py::_add_common):
    each is taken with the port's behaviour."""
    p.add_argument("--fused_head", action="store_true", default=None,
                   help="the head through its fused kernels (%s), the default "
                        "on every device" % ("C and D" if train else "C"))
    p.add_argument("--no_fused_head", dest="fused_head", action="store_false",
                   help="the head as four 1x1 convs in the compute dtype (no "
                        "head kernel)")
    p.add_argument("--remat", dest="remat_unet", action="store_true",
                   help="recompute the trainable UNet blocks' activations in the "
                        "backward (torch.utils.checkpoint)" if train else
                        "accepted: no effect in eval, where no gradient flows")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks on the 'data' axis: the batch's rows split over them "
                        "(training) or the patches (eval); typed without torchrun, "
                        "the CLI spawns them on this host, one a card (one a CPU "
                        "process with --device cpu)")
    p.add_argument("--ensemble_parallel", type=int, default=1,
                   help="ranks on the 'ensemble' axis: Bag-of-POPCORN members split "
                        "over them (eval only; training runs its data ranks)")
    p.add_argument("--multihost", action="store_true",
                   help="ranks over several hosts (torchrun on each): data-parallel "
                        "across hosts, data/ensemble within each; one process "
                        "degrades to this host's ranks")
    p.add_argument("--compile_cache", nargs="?", const="", default=None, metavar="DIR",
                   help="accepted and ignored: PyTorch runs eagerly, there is no "
                        "XLA program to cache (the kernels are cached in "
                        "popcorn_tpu_torch/build/)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise at the op that "
                        "produced a NaN (the reference's anomaly detection)" if train else
                        "raise at the first patch whose member outputs hold a NaN, "
                        "naming it (what jax_debug_nans stops the JAX eval on)")


def eval_parser() -> argparse.ArgumentParser:
    """The flags of run_eval.py (popcorn_tpu/cli/args.py::eval_parser), as
    ``train_parser`` takes run_train.py's."""
    p = argparse.ArgumentParser(
        description="POPCORN ensemble evaluation (PyTorch/CUDA port)",
        fromfile_prefix_chars="@",
    )
    _add_common(p)
    _add_runtime(p, train=False)
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
    p.add_argument("--device_feed", choices=("auto", "on", "off"), default="auto",
                   help="device-resident season mosaics: auto takes them when the "
                        "stitch is on the device, on forces them, off takes the "
                        "host patch feed")
    p.add_argument("--patchsize", type=int, default=2048,
                   help="sliding-window patch size (reference "
                        "inference_patch_size=2048, utils/constants.py:12)")
    p.add_argument("--patch_overlap", type=int, default=128,
                   help="sliding-window halo (reference overlap=128)")
    p.add_argument("--quantize", choices=["int8", "int8s", "w4a8"], default=None,
                   help="int8 eval through the int8 UNet-block kernels: 'int8' = "
                        "dynamic per-tile activation scales (kernels G/H); "
                        "'int8s' = static scales calibrated on the first patch "
                        "batch, int8 block I/O (kernels E/F); 'w4a8' = int8s "
                        "with int4-grid weights. Census r2 stays within 0.02 "
                        "of the float run")
    p.add_argument("--spatial", action="store_true",
                   help="whole-region inference: every member over each season's "
                        "whole mosaic (row blocks over the ranks), no patches or "
                        "stitch; the border ring holds true output where the "
                        "stitched map is 0")
    p.add_argument("--transport", choices=("exact", "bf16"), default="exact",
                   help=TRANSPORT_HELP)
    return p


def train_parser() -> argparse.ArgumentParser:
    """The flags of run_train.py (popcorn_tpu/cli/args.py::train_parser),
    each taken with the port's behaviour."""
    p = argparse.ArgumentParser(
        description="POPCORN training (PyTorch/CUDA port)", fromfile_prefix_chars="@"
    )
    _add_common(p)
    _add_runtime(p, train=True)
    p.add_argument("-r", "--resume", type=str, default=None)
    p.add_argument("-tregtrain", "--target_regions_train", nargs="+", default=["rwa"])
    p.add_argument("-wb", "--weak_batch_size", type=int, default=2)
    p.add_argument("--spatial_train", action="store_true",
                   help="with --data_parallel N: split each sample's rows over the "
                        "data ranks instead of the batch (one rank a card when N "
                        "is not given) — census-region crops beyond one card's "
                        "memory train across the ranks instead of being "
                        "tier-skipped; raise -lim1/-lim2/-lim3 accordingly")
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
                   help="device-resident training feed: auto tries it, then the "
                        "season-rotating form behind the cost gate, then the host "
                        "feed; on requires it; off takes the host feed")
    p.add_argument("--quantize_eval", choices=["int8", "int8s", "w4a8"], default=None,
                   help="run the in-training target test and weak validation "
                        "through quantized inference (as eval --quantize); the "
                        "train steps stay float. Explicit opt-in: quantized "
                        "validation steers best-model selection")
    p.add_argument("--feed_gate", choices=("auto", "off", "host"), default="auto",
                   help="when the full resident stack does not fit: auto measures "
                        "the season-rotating feed against the host feed, host "
                        "takes the host feed, off keeps rotation whenever it fits")
    p.add_argument("--transport", choices=("exact", "bf16"), default="exact",
                   help=TRANSPORT_HELP)
    return p


def n_ranks(a) -> int:
    """The ranks a command asks for: --data_parallel x --ensemble_parallel
    (an eval's grid; training uses its data ranks)."""
    return max(1, a.data_parallel) * max(1, getattr(a, "ensemble_parallel", 1))


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
        fused_head=a.fused_head is not False,  # None (no flag): fused
        quantize=getattr(a, "quantize", None) or getattr(a, "quantize_eval", None),
        remat_unet=getattr(a, "remat_unet", False),
    )


def train_config_from_args(a) -> TrainConfig:
    return TrainConfig(
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
        device_feed=a.device_feed,
        transport=a.transport,
        debug_nans=a.debug_nans,
        spatial=a.spatial,
    )

"""Eval CLI arguments: the flags of run_eval.py (the reference's
arguments/eval.py:3-27 plus the data-root and patch-geometry flags), and
the port's own ``model_config_from_args`` and ``eval_config_from_args``.
Config files are supported via @file syntax."""

from __future__ import annotations

import argparse

from ..config import EvalConfig, ModelConfig


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
    )


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

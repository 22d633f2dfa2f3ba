"""Training entry point of the port, with run_train.py's flags.

Example (Rwanda, occupancy model, on-the-fly Sentinel buildings, on the
card; ``--device cpu`` runs the plain versions):
  POPCORN_DATA=/data python -m popcorn_tpu_torch.cli.train -S2 -NIR -S1 \
      -treg rwa -tregtrain rwa -occmodel -senbuilds -pret -binit 0.9407
"""

from __future__ import annotations

import time

import torch

from ..config import DataPaths
from ..train.trainer import Trainer
from .args import check_train_args, model_config_from_args, train_config_from_args, train_parser


def main(argv=None):
    """Train; returns the Trainer (its experiment folder holds
    metrics.jsonl and the .pth checkpoints, its params the trained
    model)."""
    args = train_parser().parse_args(argv)
    check_train_args(args)
    mcfg = model_config_from_args(args)
    tcfg = train_config_from_args(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    trainer = Trainer(
        DataPaths(args.data_root), mcfg, tcfg, resume=args.resume,
        use_wandb=args.wandb, device=args.device,
    )
    print("Experiment folder:", trainer.experiment_folder)
    since = time.time()
    trainer.train()
    elapsed = time.time() - since
    print(f"Training completed in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
    return trainer


if __name__ == "__main__":
    main()

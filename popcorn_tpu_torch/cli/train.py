"""Training entry point of the port, with run_train.py's flags.

Example (Rwanda, occupancy model, on-the-fly Sentinel buildings, on the
card; ``--device cpu`` runs the plain versions):
  POPCORN_DATA=/data python -m popcorn_tpu_torch.cli.train -S2 -NIR -S1 \
      -treg rwa -tregtrain rwa -occmodel -senbuilds -pret -binit 0.9407

``--data_parallel N`` trains on N data-parallel ranks (train/trainer.py):
typed as above, the command spawns them on this host (one a card; one a
CPU process with ``--device cpu``, over gloo); under ``torchrun
--nproc_per_node N`` it is one of them. ``--multihost`` takes torchrun's
ranks of every host. ``--spatial_train`` splits each crop's rows over
the ranks instead of the batch; without ``--data_parallel`` it takes one
rank a card (one card: one rank, the plain step). ``--ensemble_parallel``
is an eval flag: training ignores it, as run_train.py does.
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import DataPaths
from ..dist.launch import spawn_ranks, under_launcher
from ..dist.mesh import devices_for, resolve_device
from ..train.trainer import Trainer
from .args import model_config_from_args, train_config_from_args, train_parser


def main(argv=None):
    """Train; returns the Trainer (its experiment folder holds
    metrics.jsonl and the .pth checkpoints, its params the trained
    model), or None in the parent of spawned ranks."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = train_parser().parse_args(argv)
    if args.ensemble_parallel > 1:
        print("--ensemble_parallel applies to the eval; training runs its "
              f"{args.data_parallel} data rank(s)")
    n = args.data_parallel
    if args.spatial_train and n <= 1 and resolve_device(args.device).type == "cuda":
        n = torch.cuda.device_count()
    if n > 1 and not under_launcher():
        spawn_ranks(_rank_main, n, (argv,), devices=devices_for(args.device, n))
        return None
    return _run(args)


def _rank_main(argv):
    _run(train_parser().parse_args(argv))


def _run(args):
    mcfg = model_config_from_args(args)
    tcfg = train_config_from_args(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    trainer = Trainer(
        DataPaths(args.data_root), mcfg, tcfg, resume=args.resume,
        use_wandb=args.wandb, device=args.device,
    )
    if trainer.is_root:
        print("Experiment folder:", trainer.experiment_folder)
    since = time.time()
    trainer.train()
    if trainer.is_root:
        elapsed = time.time() - since
        print(f"Training completed in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
    return trainer


if __name__ == "__main__":
    main()

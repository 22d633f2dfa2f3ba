"""Ensemble evaluation entry point of the port, with run_eval.py's flags.

Example (Bag-of-POPCORN, 5 members, on the card):
  POPCORN_DATA=/data python -m popcorn_tpu_torch.cli.eval -occmodel \
      -senbuilds -S2 -NIR -S1 -treg rwa -tlevel coarse -r m1.pth ... m5.pth
"""

from __future__ import annotations

import time

from ..config import DataPaths
from ..infer.evaluator import Evaluator
from .args import check_eval_args, eval_config_from_args, eval_parser, model_config_from_args


def main(argv=None, timings=None):
    """Run the eval CLI on ``argv``; returns the census metrics. ``timings``:
    a dict that receives each region's sliding-window split
    (infer/sliding.py::run_sliding_inference)."""
    args = eval_parser().parse_args(argv)
    check_eval_args(args)
    ev = Evaluator(
        DataPaths(args.data_root),
        model_config_from_args(args),
        eval_config_from_args(args),
        device=args.device,
        use_wandb=args.wandb,
    )
    print("Experiment folder:", ev.experiment_folder)
    since = time.time()
    stats = ev.test_target(save=True, full=args.full, timings=timings)
    for k, v in sorted(stats.items()):
        print(f"  {k}: {v:.4f}")
    elapsed = time.time() - since
    print(f"Evaluating completed in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
    return stats


if __name__ == "__main__":
    main()

"""Ensemble evaluation entry point of the port, with run_eval.py's flags.

Example (Bag-of-POPCORN, 5 members, on the card):
  POPCORN_DATA=/data python -m popcorn_tpu_torch.cli.eval -occmodel \
      -senbuilds -S2 -NIR -S1 -treg rwa -tlevel coarse -r m1.pth ... m5.pth

Ranks: ``--data_parallel N`` and ``--ensemble_parallel M`` split the
patches and the members over N x M ranks (dist/mesh.py). Typed as above,
the command spawns them on this host (one a card; one a CPU process with
``--device cpu``, over gloo); under ``torchrun --nproc_per_node N*M`` it
is one of them. ``--multihost`` takes torchrun's ranks of every host.
``--spatial`` runs the whole-frame path (infer/spatial.py).
"""

from __future__ import annotations

import sys
import time

from ..config import DataPaths
from ..dist.launch import spawn_ranks, under_launcher
from ..dist.mesh import devices_for, make_mesh, make_multihost_mesh
from ..infer.evaluator import Evaluator
from .args import (
    eval_config_from_args,
    eval_parser,
    model_config_from_args,
    n_ranks,
)


def eval_mesh(args):
    """The mesh an eval command line asks for, or None for one process."""
    if not (args.multihost or n_ranks(args) > 1):
        return None
    devs = devices_for(args.device)
    if args.multihost:
        nd = args.data_parallel if args.data_parallel > 1 else None
        return make_multihost_mesh(nd, n_ensemble=args.ensemble_parallel, devices=devs)
    return make_mesh(args.data_parallel, devices=devs, n_ensemble=args.ensemble_parallel)


def main(argv=None, timings=None):
    """Run the eval CLI on ``argv``; returns the census metrics (None in
    the parent of spawned ranks, {} on a rank other than 0). ``timings``:
    a dict that receives each region's sliding-window split
    (infer/sliding.py::run_sliding_inference)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = eval_parser().parse_args(argv)
    n = n_ranks(args)
    if n > 1 and not under_launcher():
        spawn_ranks(_rank_main, n, (argv,), devices=devices_for(args.device, n))
        return None
    return _run(args, timings)


def _rank_main(argv):
    _run(eval_parser().parse_args(argv), None)


def _run(args, timings):
    ev = Evaluator(
        DataPaths(args.data_root),
        model_config_from_args(args),
        eval_config_from_args(args),
        device=args.device,
        use_wandb=args.wandb,
        mesh=eval_mesh(args),
    )
    if ev.is_root:
        print("Experiment folder:", ev.experiment_folder)
    since = time.time()
    stats = ev.test_target(save=True, full=args.full, timings=timings)
    if ev.is_root:
        for k, v in sorted(stats.items()):
            print(f"  {k}: {v:.4f}")
        elapsed = time.time() - since
        print(f"Evaluating completed in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
    return stats


if __name__ == "__main__":
    main()

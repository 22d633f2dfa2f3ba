"""Train the DDA built-up extractor with fusion-DA consistency training:
the port's twin of tools/run_dda_train.py, with its flags plus --device.

Example (on the card; ``--device cpu`` runs on the CPU):
  python -m popcorn_tpu_torch.cli.dda_train --manifest data/manifest.json \
      --epochs 30 --loss SoftDiceLoss --consistency-factor 0.5

The trained extractor is written in the reference's DDA checkpoint format
(train/checkpoint.py::save_dda_checkpoint), which the time series' built-up
mode and the POPCORN model load through POPCORN_DDA_CHECKPOINT.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DDA extractor training (PyTorch/CUDA port)")
    p.add_argument("--manifest", required=True)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--loss", default="SoftDiceLoss")
    p.add_argument("--consistency-factor", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--labeled-per-batch", type=int, default=8)
    p.add_argument("--unlabeled-per-batch", type=int, default=8)
    p.add_argument("--out", default="dda_checkpoint.pt",
                   help="the trained extractor, a DDA checkpoint file")
    p.add_argument("--no-augment", action="store_true",
                   help="disable the training augmentations (flip/rot90/color/gamma, "
                        "reference DDA_model/utils/augmentations.py:11-31)")
    p.add_argument("--crop-size", type=int, default=0,
                   help="random-crop size during training (0 = off)")
    p.add_argument("--test", action="store_true",
                   help="after training, run the per-site test loop (pixel P/R/F1/IoU "
                        "+ morphology metrics per head; reference evaluation.py:252-453)")
    p.add_argument("--test-manifest", default=None,
                   help="manifest of held-out test sites for --test; defaults to the "
                        "training manifest")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None):
    """Train on ``argv``; returns the DDATrainer."""
    from ..dda.train import DDAConfig, DDATrainer, format_site_report
    from ..train.checkpoint import save_dda_checkpoint

    args = parser().parse_args(argv)
    aug_on = not args.no_augment
    cfg = DDAConfig(
        epochs=args.epochs, loss_type=args.loss,
        loss_factor=args.consistency_factor, lr=args.lr,
        labeled_per_batch=args.labeled_per_batch,
        unlabeled_per_batch=args.unlabeled_per_batch,
        random_flip=aug_on, random_rotate=aug_on,
        color_shift=aug_on, gamma_correction=aug_on,
        crop_size=args.crop_size,
    )
    tr = DDATrainer(args.manifest, cfg, device=args.device)
    for e in range(cfg.epochs):
        loss = tr.train_epoch(augment=aug_on)
        print(f"epoch {e}: loss {loss:.4f}", flush=True)
    print("eval:", tr.evaluate())
    if args.test:
        print(format_site_report(tr.test_per_site(args.test_manifest)))
    params, bn = tr.export_for_popcorn()
    save_dda_checkpoint(os.path.abspath(args.out), {"unet": params, "unet_bn": bn})
    print("saved", args.out)
    return tr


if __name__ == "__main__":
    main()

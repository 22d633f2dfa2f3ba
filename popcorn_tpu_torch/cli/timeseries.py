"""Time-series entry point of the port, the twin of run_timeseries.py:
built-up probability per dated frame (the reference's
time_series_inference_single_frame.py, de-bit-rotted) or the ensemble
population time series (the time_series_inference.ipynb workflow). Both
modes take run_timeseries.py's flags plus --device (the card by default;
'cpu' runs the plain versions).

Built-up mode: frames.json lists dated single-frame rasters,
  {"s2": [{"date": "2023-10-01", "path": "S2_20231001.tif"}, ...],
   "s1_desc": [...], "s1_asc": [...]}
  python -m popcorn_tpu_torch.cli.timeseries builtup --frames frames.json --out-dir builtup/
The extractor is the repo's DDA checkpoint (or POPCORN_DDA_CHECKPOINT,
such as a checkpoint from popcorn_tpu_torch.cli.dda_train). --spatial
scores each whole frame in one call over this process's ranks (one, or
torchrun's) instead of overlap-stitched patches (infer/spatial.py).

Population mode: steps.json lists (label, data_root, region) steps,
  [{"label": "2020", "data_root": "/data/2020", "region": "cod"}, ...]
  python -m popcorn_tpu_torch.cli.timeseries population --steps steps.json \
      -r m1.pth m2.pth m3.pth m4.pth m5.pth -S1 -S2 -NIR -occmodel -senbuilds --out-dir ts/
with the eval CLI's flags (cli/args.py::eval_parser), as cli/eval.py
takes them: --data_parallel/--ensemble_parallel spawn the ranks each
step's eval splits over, --spatial runs each step's eval whole-frame
(run_timeseries.py parses these flags and runs one process's stitched
eval). The patches are --patchsize/--patch_overlap (2048/128 by default,
the sizes run_timeseries.py uses; it does not read these flags).
"""

from __future__ import annotations

import argparse
import json
import sys


def _builtup(argv):
    p = argparse.ArgumentParser(prog="python -m popcorn_tpu_torch.cli.timeseries builtup")
    p.add_argument("--frames", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--patchsize", type=int, default=1024)
    p.add_argument("--overlap", type=int, default=64)
    p.add_argument("--no-nir", action="store_true")
    p.add_argument("--spatial", action="store_true",
                   help="score each whole frame in one call over this process's "
                        "ranks instead of overlap-stitched patches")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args(argv)

    from ..compat.weights import load_popcorn_from_dda
    from ..config import ModelConfig
    from ..dist.mesh import devices_for, make_mesh
    from ..infer.timeseries import Frame, find_closest_frames, parse_date, run_builtup_timeseries

    with open(a.frames) as f:
        spec = json.load(f)

    def frames(key):
        return [Frame(parse_date(r["date"]), r["path"]) for r in spec.get(key, [])]

    mcfg = ModelConfig(nir=not a.no_nir)
    _, consts = load_popcorn_from_dda(mcfg)
    pairs = find_closest_frames(frames("s2"), frames("s1_desc"), frames("s1_asc"))
    mesh = make_mesh(devices=devices_for(a.device)) if a.spatial else None
    written = run_builtup_timeseries(consts, mcfg, pairs, a.out_dir, patchsize=a.patchsize,
                                     overlap=a.overlap, device=a.device, mesh=mesh)
    for w in written:
        print("->", w)
    return written


def _population_parser():
    from .args import eval_parser

    p = eval_parser()
    p.prog = "python -m popcorn_tpu_torch.cli.timeseries population"
    p.add_argument("--steps", required=True)
    p.add_argument("--out-dir", required=True)
    return p


def _population(argv):
    from ..dist.launch import spawn_ranks, under_launcher
    from ..dist.mesh import devices_for
    from .args import n_ranks

    a = _population_parser().parse_args(argv)
    n = n_ranks(a)
    if n > 1 and not under_launcher():
        spawn_ranks(_population_rank, n, (list(argv),), devices=devices_for(a.device, n))
        return None
    return _population_run(a)


def _population_rank(argv):
    _population_run(_population_parser().parse_args(argv))


def _population_run(a):
    from ..compat.weights import load_popcorn_from_dda
    from ..config import DataPaths
    from ..infer.evaluator import load_member
    from ..infer.pop_timeseries import run_population_timeseries
    from .args import model_config_from_args
    from .eval import eval_mesh

    mcfg = model_config_from_args(a)
    with open(a.steps) as f:
        steps_spec = json.load(f)
    members, consts = [], None
    for c in a.resume:
        params, member_consts = load_member(c)
        members.append(params)
        consts = consts or member_consts
    if consts is None:
        _, consts = load_popcorn_from_dda(mcfg)
    steps = [(s["label"], DataPaths(s["data_root"]), s["region"]) for s in steps_spec]
    records = run_population_timeseries(
        members, consts, mcfg, steps, a.out_dir, patchsize=a.patchsize,
        overlap=a.patch_overlap, fourseasons=a.fourseasons, patch_batch=a.patch_batch,
        device=a.device, mesh=eval_mesh(a), spatial=a.spatial, transport=a.transport,
    )
    for r in records:
        print(r)
    return records


def main(argv=None):
    """Run ``{builtup|population} ...``; returns the written paths
    (builtup) or the totals records (population)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    mode, rest = (argv[0], argv[1:]) if argv else ("", [])
    if mode == "builtup":
        return _builtup(rest)
    if mode == "population":
        return _population(rest)
    print(__doc__)
    raise SystemExit("usage: python -m popcorn_tpu_torch.cli.timeseries {builtup|population} ...")


if __name__ == "__main__":
    main()

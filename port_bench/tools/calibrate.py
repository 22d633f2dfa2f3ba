"""Readings that the limits of ``correct`` are set from (limits/*.json).

    python3 port_bench/tools/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3 4 5] [--controls ...] [--out readings.jsonl]

On the card, at the cell's own size (a cell of BENCHMARK.json or of
held/), in one process: for every seed the numbers that the sound
program reads against the plain reference (the lower readings), and for
each control seed the numbers of

* eval cells: the program with its own lower-precision paths switched
  on, one map each: ``int8s`` (``--quantize int8s``: the members' UNets
  in int8 under the configuration's bf16, the building extractor left in
  bf16) and ``int8_builder`` (``--quantize int8`` with the building
  extractor quantized too); and the plain reference computed with fp8
  operands;
* training cells: the plain reference put in the program's place and
  computed with fp8 (e4m3) operands, and the faults planted in it: half
  of each batch left out (the mean over the rest), a step whose answer is
  altered where it is produced (the first sample's population count
  scaled by 1.5), and a backward whose sign is wrong (every gradient
  times -1); a step that returns its state unchanged reads 1 on the leaf
  gaps by their definition and needs no run.

Each reading is one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cell_with(cell, **model):
    c = copy.copy(cell)
    c.config = copy.deepcopy(cell.config)
    c.config["model"].update(model)
    return c


def _drive(R, spec, cell, seed, device="cuda", cache=None):
    run = R.Run(cell, seed, device)
    drv = spec.driver_module(cell.driver)
    R.prepare_data(run, cache or R.CACHE)
    drv.setup(run)
    drv.window(run, 0.01, None)  # one map, or one epoch
    while cell.driver == "train_epoch" and run.step.calls <= drv.N_CHECKED:
        drv.window(run, 0.01, None)  # the step after the checked ones closes them
    drv.release(run)
    return run, drv


EVAL_CONTROLS = ("int8s", "int8_builder", "reference_fp8")
PROGRAM_CONTROLS = {"int8s": {"quantize": "int8s"},
                    "int8_builder": {"quantize": "int8", "pallas_stream": True}}


def eval_readings(R, spec, cell, seeds, control_seeds, controls=EVAL_CONTROLS, **kw):
    for seed in seeds:
        run, drv = _drive(R, spec, cell, seed, **kw)
        yield {"seed": seed, "side": "program", **drv.check(run)}
    from port_bench.harness import compare
    from port_bench.reference import model as ref_model
    from port_bench.reference.evaluate import evaluate

    for mode, model in PROGRAM_CONTROLS.items():
        for seed in control_seeds if mode in controls else ():
            run, drv = _drive(R, spec, _cell_with(cell, **model), seed, **kw)
            yield {"seed": seed, "side": f"control_{mode}", **drv.check(run)}
    cfg = cell.config
    for seed in control_seeds if "reference_fp8" in controls else ():
        run, drv = _drive(R, spec, cell, seed, **kw)
        args = dict(patch=cfg["patchsize"], overlap=cfg["overlap"], fourseasons=cfg["fourseasons"],
                    levels=cfg["levels"], train_level=cfg["train_level"], device=run.device)
        ref = evaluate(run.data_root, run.members, **args)
        low = evaluate(run.data_root, run.members, q=ref_model.fp8, **args)
        yield {"seed": seed, "side": "control_reference_fp8",
               **compare.eval_numbers(low, ref, cfg["levels"], 0)}


def train_readings(R, spec, cell, seeds, control_seeds, controls=(), **kw):
    import torch

    from port_bench.harness import compare
    from port_bench.reference import model as ref_model
    from port_bench.reference.train import Region, TrainSettings, run_steps

    cell = copy.copy(cell)
    cell.traffic = dict(cell.traffic, warm_epochs=0)
    region = None
    settings = TrainSettings(**{k: cell.config["train"][k] for k in (
        "learning_rate", "gradient_clip", "lam_weak", "scale_regularization", "limit1", "limit2")})

    def as_program(ref):
        norms = lambda d: {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}
        return {"loss": ref["loss"], "popcount": ref["popcount"], "grad1": norms(ref["grad1"]),
                "change": ref["change"]}

    for seed in seeds:
        run, drv = _drive(R, spec, cell, seed, **kw)
        if region is None:
            region = Region(run.data_root, cell.config["train_level"], run.device)
        ps = run.program_steps
        batches = [c["batch"] for c in ps["checked"]]
        gens = [c["gen_state"] for c in ps["checked"]]
        ref = run_steps(region, run.member, batches, gens, settings, run.device)
        nums, leaves = compare.train_numbers(drv.program_numbers(ps), ref)
        yield {"seed": seed, "side": "program", **nums, **{f"worst_leaf.{k}": v for k, v in leaves.items()}}
        if seed not in control_seeds:
            continue
        fp8 = run_steps(region, run.member, batches, gens, settings, run.device, q=ref_model.fp8)
        nums, leaves = compare.train_numbers(as_program(fp8), ref)
        yield {"seed": seed, "side": "control_fp8", **nums, **{f"worst_leaf.{k}": v for k, v in leaves.items()}}
        half = [{k: (v[:1] if k not in ("photometric",) else v) for k, v in b.items()}
                for b in batches]
        faults = (("fault_half_batch", half, {}),
                  ("fault_answer_altered", batches, {"popcount_scale": 1.5}),
                  ("fault_sign_flip", batches, {"grad_scale": -1.0}))
        for side, fault_batches, fault in faults:
            got = run_steps(region, run.member, fault_batches, gens, settings, run.device, **fault)
            nums, leaves = compare.train_numbers(as_program(got), ref)
            yield {"seed": seed, "side": side, **nums,
                   **{f"worst_leaf.{k}": v for k, v in leaves.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=list(EVAL_CONTROLS),
                   help="an eval cell's controls to read (all by default)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import port_bench.run as R
    from port_bench.harness import spec

    os.environ["TQDM_DISABLE"] = "1"
    cell = spec.load_cell(args.workload, bench=spec.with_held())
    for k, v in cell.traffic.get("env", {}).items():
        os.environ[k] = str(v)
    gen = eval_readings if cell.driver == "eval_map" else train_readings
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()
    for rec in gen(R, spec, cell, args.seeds, set(args.control_seeds), controls=args.controls):
        rec["t"] = round(time.perf_counter() - t0, 1)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()

"""Readings that the Prithvi member's limits of ``correct`` are set from
(limits/prithvi-eo2-300m-member-train-bf16.json).

    python3 port_bench/tools/calibrate_prithvi.py --workload train-prithvi300m-resident \
        --seeds 1 2 ... [--control-seeds 3 4 5] [--out readings.jsonl]

On the card, at the cell's own size, in one process, as tools/calibrate.py
reads a training cell (whose ``train_readings`` runs the DDA member's
reference and so cannot take this configuration): for every seed the
numbers that the sound program reads against reference/prithvi.py (the
lower readings), and for each control seed the numbers of the reference
put in the program's place and computed with fp8 (e4m3) operands, of the
faults tools/calibrate.py plants (half of each batch left out, the first
sample's population count times 1.5, every gradient times -1), and of two
faults planted in the extractor's mechanism: the bucket's padding
attended (each sample encoded over the whole bucket) and the position
table's h and w swapped. Each reading is one JSON line. The benchmark's
own runs never run this.
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


def readings(R, spec, cell, seeds, control_seeds):
    import torch

    from port_bench.harness import compare
    from port_bench.reference import model as ref_model
    from port_bench.reference.prithvi import run_steps
    from port_bench.reference.train import Region
    from port_bench.tools.calibrate import _drive

    cell = copy.copy(cell)
    cell.traffic = dict(cell.traffic, warm_epochs=0)
    heads = cell.config["num_heads"]
    region = None

    def as_program(ref):
        norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad1"].items()}
        return {"loss": ref["loss"], "popcount": ref["popcount"], "grad1": norms,
                "change": ref["change"]}

    def line(seed, side, nums, leaves):
        return {"seed": seed, "side": side, **nums,
                **{f"worst_leaf.{k}": v for k, v in leaves.items()}}

    for seed in seeds:
        run, drv = _drive(R, spec, cell, seed)
        if region is None:
            region = Region(run.data_root, cell.config["train_level"], run.device)
        ps = run.program_steps
        batches = [c["batch"] for c in ps["checked"]]
        gens = [c["gen_state"] for c in ps["checked"]]
        settings = drv.settings(cell.config)
        ref = run_steps(region, run.member, batches, gens, settings, run.device, heads=heads)
        yield line(seed, "program", *compare.train_numbers(drv.program_numbers(ps), ref))
        if seed not in control_seeds:
            continue
        half = [{k: (v[:1] if k != "photometric" else v) for k, v in b.items()} for b in batches]
        controls = (("control_fp8", batches, {"q": ref_model.fp8}),
                    ("fault_half_batch", half, {}),
                    ("fault_answer_altered", batches, {"popcount_scale": 1.5}),
                    ("fault_sign_flip", batches, {"grad_scale": -1.0}),
                    ("fault_padding_attended", batches, {"whole_bucket": True}),
                    ("fault_pos_hw_swapped", batches, {"swap_hw": True}))
        for side, fault_batches, fault in controls:
            got = run_steps(region, run.member, fault_batches, gens, settings, run.device,
                            heads=heads, **fault)
            yield line(seed, side, *compare.train_numbers(as_program(got), ref))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import port_bench.run as R
    from port_bench.harness import spec

    os.environ["TQDM_DISABLE"] = "1"
    cell = spec.load_cell(args.workload, bench=spec.with_held())
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()
    for rec in readings(R, spec, cell, args.seeds, set(args.control_seeds)):
        rec["t"] = round(time.perf_counter() - t0, 1)
        text = json.dumps(rec)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()

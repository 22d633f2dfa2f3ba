"""Driver of the Prithvi-EO-2.0 member's training: ``Trainer.train_epoch``
of the program with ``-fe prithvi_eo2_300m``, epochs back to back, over
one region's census samples, as drivers/train_epoch.py runs the DDA
member, with its step and feed proxies and its window.

Set-up draws the member from the seed (harness/weights_prithvi.py: the
encoder, neck and head drawn, the published building extractor), builds
the Trainer with its feed and resumes it from that member, and runs
``warm_epochs`` epochs. The window is train_epoch's; besides, the record
holds each window step's samples' crop sizes and, for the traced steps,
each sample's extent size (read from the batch's 'extent') and whether a
memory tier froze the encoder, so the readers count tokens. After the
run has reduced the trace with roofline/kernels.json, ``release`` reduces
it a second time with roofline/kernels_prithvi.json (attention and the
update) into ``trace_prithvi``.

The comparison is train_epoch's, against reference/prithvi.py's steps,
the program's leaves named by Prithvi's state-dict keys here.

The program module imported first below is what this configuration runs;
a program without it fails here, before any data is prepared.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import popcorn_tpu_torch.nn.prithvi  # noqa: F401  (the extractor this cell runs)

from port_bench.harness import compare, spec
from port_bench.harness.trace import reduce_trace
from port_bench.harness.weights_prithvi import make_member
from port_bench.reference.prithvi import run_steps
from port_bench.reference.train import Region, TrainSettings
from port_bench.traffic.region import REGION, crop_sizes

base = spec.driver_module("train_epoch")
N_CHECKED = base.N_CHECKED
_BLOCK = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2",
          "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_WB = {"w": "weight", "b": "bias"}


class StepProxy(base.StepProxy):
    """train_epoch's proxy; also keeps each traced step's samples' extent
    sizes and its encoder tier."""

    def __init__(self, fn):
        super().__init__(fn)
        self.traced_samples, self.traced_frozen = [], []

    def __call__(self, params, opt_state, batch, generator=None, **kw):
        if self.tracer is not None and not self.tracer.done:
            self.traced_samples.append([[int(r1 - r0), int(c1 - c0)]
                                        for r0, r1, c0, c1 in batch["extent"]])
            self.traced_frozen.append(bool(kw.get("encoder_no_grad")))
        return super().__call__(params, opt_state, batch, generator, **kw)


def _counters() -> Dict[str, float]:
    from popcorn_tpu_torch.utils import profiling

    c = getattr(profiling, "COUNTERS", None)
    return {} if c is None else c.summary()


def setup(run) -> None:
    from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
    from popcorn_tpu_torch.train.trainer import Trainer

    cfg, tr = run.cell.config, run.cell.traffic
    run.member = make_member(run.dda_path, run.tmp("members"), run.seed, cfg, run.device)
    tcfg = TrainConfig(target_regions=(REGION,), target_regions_train=(REGION,),
                       train_level=(cfg["train_level"],), seed=int(run.seed),
                       save_dir=run.tmp("train"), save_model="no",
                       device_feed=tr["device_feed"], num_workers=tr["num_workers"],
                       **cfg["train"])
    trainer = Trainer(DataPaths(run.data_root), ModelConfig(**cfg["model"]), tcfg,
                      resume=run.member, device=run.device)
    run.step = trainer.step_fn = StepProxy(trainer.step_fn)
    run.feed = trainer.feed = base.FeedProxy(trainer.feed)
    run.trainer = trainer
    run.feed_choice = trainer.feed_choice
    for _ in range(tr["warm_epochs"]):
        trainer.train_epoch()
        trainer.info["epoch"] += 1
    run.sync()


def window(run, seconds: float, tracer=None) -> Dict:
    before = _counters()
    record = base.window(run, seconds, tracer)
    after = _counters()
    # the window's and the traced steps' counts of the program's counters
    run.notes.update({k: after[k] - before.get(k, 0) for k in after})
    run.notes.setdefault("steps/encoder_frozen", 0)
    crops = crop_sizes(run.data_root, run.cell.config["train_level"])
    record["samples_hw"] = [[list(crops[int(i)]) for i in idx] for _, idx in record["units"]]
    record["traced_samples"] = run.step.traced_samples
    record["traced_frozen"] = run.step.traced_frozen
    run.tracer, run.record = tracer, record
    return record


# kernel families of the traced device time (run.notes' 'device_share'),
# by a word of the kernel's name
FAMILIES = (("attention", ("flash_", "fmha", "sdpa")), ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
            ("update", ("adam_",)), ("layer_norm", ("layer_norm", "GammaBeta")))


def _kernels(path: str) -> List[Tuple[str, float]]:
    """The trace's kernel events: (name, microseconds)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e.get("name", ""), float(e.get("dur", 0))) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def device_shares(kernels: List[Tuple[str, float]]) -> Dict[str, float]:
    """Each kernel family's share of the trace's kernel time, for the
    notes (no metric reads it)."""
    out: Dict[str, float] = {}
    for name, dur in kernels:
        fam = next((k for k, words in FAMILIES if any(w in name for w in words)), "other")
        out[fam] = out.get(fam, 0.0) + dur
    total = sum(out.values()) or 1.0
    return {k: round(v / total, 4) for k, v in sorted(out.items())}


def kernel_table(table: Dict, names) -> Dict[str, List[str]]:
    """roofline/kernels_prithvi.json's patterns, each function's with the
    ``names`` that start with one of its '_prefixes'."""
    out = {fn: list(ps) for fn, ps in table.items() if not fn.startswith("_")}
    for fn, prefixes in table.get("_prefixes", {}).items():
        out[fn] += sorted({n for n in names if n.startswith(tuple(prefixes))})
    return out


def release(run) -> None:
    """train_epoch's release; then the trace's second reduction."""
    base.release(run)
    tracer = getattr(run, "tracer", None)
    if tracer is not None and tracer.done and os.path.exists(tracer.out_path):
        with open(os.path.join(spec.BENCH_DIR, "roofline", "kernels_prithvi.json")) as f:
            table = json.load(f)
        kernels = _kernels(tracer.out_path)
        run.record["trace_prithvi"] = reduce_trace(
            tracer.out_path, kernel_table(table, {n for n, _ in kernels}))
        run.notes["device_share"] = device_shares(kernels)


def reference_key(path: Tuple[str, ...]) -> str:
    """The reference state dict's name of a leaf of the program's tree."""
    if path[0] == "head":
        return compare.reference_key(path)
    if path[0] == "neck":
        return f"neck.{_WB[path[1]]}"
    if path[1] == "cls_token":
        return "encoder.cls_token"
    if path[1] == "blocks":
        return f"encoder.blocks.{path[2]}.{_BLOCK[path[3]]}.{_WB[path[4]]}"
    return f"encoder.{'patch_embed.proj' if path[1] == 'patch_embed' else 'norm'}.{_WB[path[2]]}"


def reference_layout(path, v):
    """A leaf in the reference's layout: the head as train_epoch lays it
    out, the patch embedding with the Conv3d's time axis, the rest as is."""
    if path[0] == "head":
        return compare.reference_layout(path, v)
    return v[:, :, None] if path[1:] == ("patch_embed", "w") else v


def program_numbers(ps: Dict, b1: float = 0.9) -> Dict:
    """train_epoch.program_numbers under this member's names."""
    p0 = dict(ps["params0"])
    return {
        "loss": [float(c["loss"]) for c in ps["checked"]],
        "popcount": [c["popcount"].double().cpu() for c in ps["checked"]],
        "grad1": {reference_key(p): float((v.double() / (1 - b1)).norm())
                  for p, v in ps["mu_after_first"]},
        "change": {reference_key(p): reference_layout(p, v - p0[p]) for p, v in ps["params_after"]},
    }


def settings(cfg) -> TrainSettings:
    return TrainSettings(**{k: cfg["train"][k] for k in (
        "learning_rate", "gradient_clip", "lam_weak", "scale_regularization", "limit1", "limit2")})


def check(run) -> Dict[str, float]:
    cfg = run.cell.config
    ps = run.program_steps
    region = Region(run.data_root, cfg["train_level"], run.device)
    ref = run_steps(region, run.member, [c["batch"] for c in ps["checked"]],
                    [c["gen_state"] for c in ps["checked"]], settings(cfg), run.device,
                    heads=cfg["num_heads"])
    nums, leaves = compare.train_numbers(program_numbers(ps), ref)
    run.notes.update({f"worst_leaf.{k}": v for k, v in leaves.items()})
    return nums

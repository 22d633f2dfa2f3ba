"""Driver of member training: ``Trainer.train_epoch`` of the program,
epochs back to back, over one region's census samples.

Set-up draws the member from the seed (the pretrained UNet, a seeded
head), builds the Trainer with its feed and resumes it from that member,
then runs ``warm_epochs`` epochs: the first steps of the first one are
the steps the plain reference follows after the window, so they go
through the window's own call and feed. The window runs epochs until
``seconds`` have passed, the epoch in flight finished and counted (a
traced run then runs epochs until the tracer's steps have run).

The Trainer's ``step_fn`` and ``feed`` are replaced from here by
forwarding proxies, with no edit to the program: they time the steps and
the waits on the feed, name the host's spans in the trace, and keep what
the comparison reads (each of the first steps' inputs, the optimizer's
state after the first, the parameters that the fourth step receives).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from port_bench.harness import compare
from port_bench.harness.weights import make_members
from port_bench.reference.train import Region, TrainSettings, run_steps
from port_bench.traffic.region import REGION, crop_sizes

N_CHECKED = 3  # steps the reference follows
_BATCH_KEYS = ("S2", "S1", "admin_mask", "census_idx", "y", "photometric")


def _host(t):
    return t.detach().cpu().clone() if isinstance(t, torch.Tensor) else torch.as_tensor(t)


class StepProxy:
    """Forwards to the Trainer's step; records (module docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0
        self.checked: List[Dict] = []
        self.params0 = self.params_after = self.mu_after_first = None
        self.window = None  # a dict while the window is open
        self.tracer = None  # a Tracer after the window, until it is done
        self.traced: List = []

    def __getattr__(self, k):
        return getattr(self.fn, k)

    def __call__(self, params, opt_state, batch, generator=None, **kw):
        self.calls += 1
        n = self.calls
        if n == 1:
            self.params0 = [(p, _host(v)) for p, v in _flat(params)]
        if n == 2:
            self.mu_after_first = [(p, _host(v)) for p, v in _flat(opt_state["mu"])]
        if n == N_CHECKED + 1:
            self.params_after = [(p, _host(v)) for p, v in _flat(params)]
        if n <= N_CHECKED:
            self.checked.append({"batch": {k: _host(batch[k]) for k in _BATCH_KEYS},
                                 "gen_state": generator.get_state().clone()})
        w = self.window
        if w is not None:
            now = time.perf_counter()
            if w["last"] is not None:
                w["intervals"].append(now - w["last"])
            w["last"] = now
            w["steps"].append((tuple(batch["S2"].shape[:3]), batch["census_idx"]))
        t = self.tracer if self.tracer is not None and not self.tracer.done else None
        if t is not None:
            self.traced.append(tuple(batch["S2"].shape[:3]))
            t.unit_begin(len(self.traced) - 1)
        with torch.autograd.profiler.record_function("train.step_fn"):
            out = self.fn(params, opt_state, batch, generator, **kw)
        if n <= N_CHECKED:
            self.checked[-1]["loss"] = out[2]["optimization_loss"].detach().clone()
            self.checked[-1]["popcount"] = out[2]["popcount"].detach().clone()
        if t is not None:
            t.unit_end(len(self.traced) - 1)
        return out


class FeedProxy:
    """Forwards to the Trainer's feed; times each wait on its epoch
    iterator while the window is open."""

    def __init__(self, feed):
        self.feed = feed
        self.waits = None

    def __getattr__(self, k):
        return getattr(self.feed, k)

    def __len__(self):
        return len(self.feed)

    def epoch(self, epoch: int):
        it = iter(self.feed.epoch(epoch))
        while True:
            t0 = time.perf_counter()
            with torch.autograd.profiler.record_function("train.feed_next"):
                b = next(it, None)
            if self.waits is not None:
                self.waits.append(time.perf_counter() - t0)
            if b is None:
                return
            yield b


def _flat(tree, prefix=()):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def setup(run) -> None:
    from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
    from popcorn_tpu_torch.train.trainer import Trainer

    cfg, tr = run.cell.config, run.cell.traffic
    run.member = make_members(run.dda_path, run.tmp("members"), run.seed, 1, perturb=0.0,
                              biasinit=cfg["model"]["biasinit"], device=run.device)[0]
    mcfg = ModelConfig(**cfg["model"])
    tcfg = TrainConfig(target_regions=(REGION,), target_regions_train=(REGION,),
                       train_level=(cfg["train_level"],), seed=int(run.seed),
                       save_dir=run.tmp("train"), save_model="no",
                       device_feed=tr["device_feed"], num_workers=tr["num_workers"],
                       **cfg["train"])
    trainer = Trainer(DataPaths(run.data_root), mcfg, tcfg, resume=run.member, device=run.device)
    run.step = trainer.step_fn = StepProxy(trainer.step_fn)
    run.feed = trainer.feed = FeedProxy(trainer.feed)
    run.trainer = trainer
    run.feed_choice = trainer.feed_choice
    for _ in range(tr["warm_epochs"]):
        trainer.train_epoch()
        trainer.info["epoch"] += 1
    run.sync()


def window(run, seconds: float, tracer=None) -> Dict:
    """Epochs back to back for ``seconds``; then, with a ``tracer``, epochs
    until its steps have run under the profiler, outside the window and
    its numbers."""
    trainer, step = run.trainer, run.step
    step.window = {"last": None, "intervals": [], "steps": []}
    run.feed.waits = []
    epoch_s = []
    t0 = time.perf_counter()
    while True:
        te = time.perf_counter()
        trainer.train_epoch()
        trainer.info["epoch"] += 1
        epoch_s.append(time.perf_counter() - te)
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t0
    w = step.window
    step.window = None
    waits = run.feed.waits
    run.feed.waits = None
    if tracer is not None:
        step.tracer, step.traced = tracer, []
        while not tracer.done:
            trainer.train_epoch()
            trainer.info["epoch"] += 1
        step.tracer = None
    steps = [(shape, [float(v) for v in idx.cpu()]) for shape, idx in w["steps"]]
    samples = sum(s[0][0] for s in steps)
    run.notes["epoch_s"] = [round(t, 3) for t in epoch_s]
    crops = crop_sizes(run.data_root, run.cell.config["train_level"])
    crop_px = [sum(crops[int(i)][0] * crops[int(i)][1] for i in idx) for _, idx in steps]
    return {
        "units": steps, "traced": list(step.traced), "window_s": window_s,
        "attempted": len(steps), "failed": 0,
        "epochs": len(epoch_s), "step_intervals_s": w["intervals"], "feed_waits_s": waits,
        "samples": samples, "crop_px": crop_px, "feed_choice": run.feed_choice,
        "end_to_end": {"train_samples_per_s": samples / window_s},
    }


def release(run) -> None:
    """Keep the checked steps on the host; free the program's device state."""
    step = run.step
    run.program_steps = {
        "checked": step.checked, "params0": step.params0, "params_after": step.params_after,
        "mu_after_first": step.mu_after_first,
    }
    run.trainer = run.step = run.feed = None
    gc.collect()
    torch.cuda.empty_cache()


def program_numbers(ps: Dict, b1: float = 0.9) -> Dict:
    """The program's side of the comparison: each checked step's loss and
    population counts, the
    first gradient as its optimizer holds it (Adam's first moment after
    one step over 1 - b1) as leaf norms, and each leaf's change over the
    checked steps, under the reference's names."""
    p0 = dict(ps["params0"])
    return {
        "loss": [float(c["loss"]) for c in ps["checked"]],
        "popcount": [c["popcount"].double().cpu() for c in ps["checked"]],
        "grad1": compare.leaf_norms((p, v / (1 - b1)) for p, v in ps["mu_after_first"]),
        "change": {compare.reference_key(p): compare.reference_layout(p, v - p0[p])
                   for p, v in ps["params_after"]},
    }


def check(run) -> Dict[str, float]:
    cfg = run.cell.config
    ps = run.program_steps
    region = Region(run.data_root, cfg["train_level"], run.device)
    settings = TrainSettings(**{k: cfg["train"][k] for k in (
        "learning_rate", "gradient_clip", "lam_weak", "scale_regularization", "limit1", "limit2")})
    ref = run_steps(region, run.member, [c["batch"] for c in ps["checked"]],
                    [c["gen_state"] for c in ps["checked"]], settings, run.device)
    nums, leaves = compare.train_numbers(program_numbers(ps), ref)
    run.notes.update({f"worst_leaf.{k}": v for k, v in leaves.items()})
    return nums

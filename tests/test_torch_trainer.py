"""The port's trainer on a tiny synthetic region (256x384, CPU,
plain versions): the train CLI end to end, the .pth checkpoint read back
by the JAX package and by resume, the in-training target test, the memory
tiers, and the run_train.py flag surface.

Checkpoint weights must come back exactly (a transpose of float32 arrays
each way); the rest checks finiteness and structure."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.cli.args import train_parser as j_train_parser
from popcorn_tpu.compat.torch_convert import load_popcorn_checkpoint as j_load_checkpoint
from popcorn_tpu.losses.losses import get_loss as j_get_loss
from popcorn_tpu_torch.cli import train as train_cli
from popcorn_tpu_torch.cli.args import (
    model_config_from_args,
    train_config_from_args,
    train_parser,
)
from popcorn_tpu_torch.config import ModelConfig, TrainConfig
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.train.state import keystr, tree_flatten
from popcorn_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
FLAGS = ["-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa", "-occmodel",
         "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("popdata_torch_train"))
    make_synthetic_region(root, "rwa", height=256, width=384, n_regions=(3, 4), seed=11)
    return root


@pytest.fixture(scope="module")
def cli_run(synth, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("outputs_cli"))
    trainer = train_cli.main(
        ["--data_root", synth, *FLAGS, "-e", "1", "-lt", "1", "-ms", "2", "-w", "1",
         "--device", "cpu", "--save_dir", out]
    )
    return trainer


@pytest.fixture(scope="module")
def trainer(synth, tmp_path_factory):
    from popcorn_tpu_torch.config import DataPaths

    tcfg = TrainConfig(
        num_epochs=1, bucket_ladder=(128, 256, 512), logstep_train=1, max_samples=2,
        num_workers=1, save_dir=str(tmp_path_factory.mktemp("outputs")),
        val_every_n_epochs=100,
    )
    return Trainer(DataPaths(synth), ModelConfig(biasinit=0.9407), tcfg,
                   inference_patch=128, inference_overlap=16, device="cpu")


def _records(trainer):
    with open(os.path.join(trainer.experiment_folder, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_runs_and_logs_jax_metric_keys(cli_run, synth):
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda

    recs = _records(cli_run)
    tr = [r for r in recs if "optimization_loss/train" in r]
    assert tr and all(np.isfinite(r["optimization_loss/train"]) for r in tr)
    # the head moved away from its initialisation
    p0, _ = load_popcorn_from_dda(ModelConfig(biasinit=0.9407), head_seed=1600)
    assert (cli_run.params["head"]["l4"]["b"] != p0["head"]["l4"]["b"]).any()
    # the train keys the JAX trainer logs: its get_loss aux, /train
    _, aux = j_get_loss(jnp.ones(2), jnp.ones(2), scale_abs_mean=jnp.asarray(1.0), tag="weak")
    want = {f"{k}/train" for k in aux}
    got = set().union(*(r.keys() for r in tr)) - {"step", "time", "Population_weak/r2/train"}
    assert got == want
    assert any("log_lr" in r for r in recs)
    assert os.path.exists(os.path.join(cli_run.experiment_folder, "last_model.pth"))


def test_checkpoint_reads_back_exactly_in_jax(cli_run):
    path = os.path.join(cli_run.experiment_folder, "last_model.pth")
    jparams, jconsts = j_load_checkpoint(path)
    ref = dict(tree_flatten({"params": jparams, "consts": jconsts}))
    got = dict(tree_flatten({"params": cli_run.params}))
    assert {p for p in ref if p[0] == "params"} == set(got)
    for path_, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[path_]), err_msg=keystr(path_))


def test_resume_round_trips(trainer):
    trainer.train_epoch()
    trainer.info["epoch"] = 3
    trainer.info["iter"] = 17
    path = trainer.save_model("last")
    before = dict(tree_flatten(trainer.params))
    mu_before = dict(tree_flatten(trainer.opt_state["mu"]))
    count = trainer.opt_state["count"]
    assert count >= 1
    trainer.params = {k: {kk: vv for kk, vv in v.items()} for k, v in trainer.params.items()}
    trainer.params["head"]["l1"] = {k: v + 1.0 for k, v in trainer.params["head"]["l1"].items()}
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer.resume(path)
    for p, v in tree_flatten(trainer.params):
        np.testing.assert_array_equal(v.numpy(), before[p].numpy(), err_msg=keystr(p))
    for p, v in tree_flatten(trainer.opt_state["mu"]):
        np.testing.assert_array_equal(v.numpy(), mu_before[p].numpy(), err_msg=keystr(p))
    assert trainer.opt_state["count"] == count
    assert trainer.info == {**trainer.info, "epoch": 4, "iter": 17}


def test_train_logs_each_epochs_own_counts_and_keeps_the_totals(synth, tmp_path):
    """Trainer.train logs what each epoch added to the program counters,
    which are process totals that only grow (utils/profiling.py), and
    leaves the totals as they were: every crop here is above limit1, so
    each step freezes the encoder and adds one to steps/encoder_frozen."""
    from popcorn_tpu_torch.config import DataPaths
    from popcorn_tpu_torch.utils.profiling import COUNTERS, count

    tcfg = TrainConfig(num_epochs=2, bucket_ladder=(128, 256, 512), logstep_train=1, max_samples=4,
                       num_workers=1, save_dir=str(tmp_path), val_every_n_epochs=100,
                       save_model="no", limit1=1000)
    tr = Trainer(DataPaths(synth), ModelConfig(biasinit=0.9407), tcfg,
                 inference_patch=128, inference_overlap=16, device="cpu")
    count("steps/encoder_frozen", 5)  # counted before the run: not an epoch's
    before = COUNTERS.summary()
    it0 = tr.info["iter"]
    tr.train()
    epochs = [r for r in _records(tr) if "time/step.forward_ms" in r]
    assert len(epochs) == 2
    steps = [epochs[0]["step"] - it0, epochs[1]["step"] - epochs[0]["step"]]
    assert all(n > 0 for n in steps)
    assert [r["steps/encoder_frozen"] for r in epochs] == steps
    assert COUNTERS.summary()["steps/encoder_frozen"] == before["steps/encoder_frozen"] + sum(steps)


def test_target_test_gives_finite_census_metrics(trainer):
    out = trainer.test_target(save=True)
    assert [k for k in out if k.endswith("/r2")], list(out)
    assert all(np.isfinite(v) for v in out.values()), out
    assert os.path.exists(os.path.join(trainer.experiment_folder, "rwa_predictions.tif"))


def test_memory_tiers(trainer):
    """tests/test_train_e2e.py::test_memory_tiers on the port's trainer."""
    batch = {"S2": np.zeros((2, 256, 256, 4), np.float32)}
    tc = trainer.tcfg
    assert trainer._tier_flags(batch) == {"encoder_no_grad": False, "unet_no_grad": False}
    tc.limit1, tc.limit2, tc.limit3 = 1000, 100_000, 120_000
    assert trainer._tier_flags(batch) is None  # skip: 131k > 120k limit3
    tc.limit3 = 13_000_000
    assert trainer._tier_flags(batch) == {"encoder_no_grad": True, "unet_no_grad": True}
    tc.limit2 = 9_000_000
    assert trainer._tier_flags(batch) == {"encoder_no_grad": True, "unet_no_grad": False}
    tc.limit1 = 9_000_000


def _flag_cases():
    """One argv per run_train.py option (every choice of a choice flag)."""
    cases = []
    for a in j_train_parser()._actions:
        if not a.option_strings or a.dest == "help":
            continue
        opt = a.option_strings[-1]
        if a.choices:
            cases += [[opt, c] for c in a.choices]
        elif a.nargs in (0, "?"):
            cases.append([opt])
        elif a.type is int:
            cases.append([opt, "2"])
        elif a.type is float:
            cases.append([opt, "0.5"])
        else:
            cases.append([opt, "rwa"])
    return cases


@pytest.mark.parametrize("argv", _flag_cases(), ids=lambda a: " ".join(a))
def test_every_run_train_flag_is_taken_or_refused_with_a_reason(argv):
    args = train_parser().parse_args(argv)
    try:
        model_config_from_args(args)
        tcfg = train_config_from_args(args)
    except NotImplementedError as e:
        assert "ROADMAP" in str(e) or "port" in str(e), str(e)
        return
    assert isinstance(tcfg, TrainConfig)


def test_train_cli_defaults_to_cuda():
    args = train_parser().parse_args([])
    assert args.device == "cuda"

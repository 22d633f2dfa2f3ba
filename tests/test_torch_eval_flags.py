"""The port's eval CLI takes every flag of run_eval.py: each is accepted
with the port's behaviour, or refused with NotImplementedError naming the
ROADMAP item that ports it (the eval twin of tests/test_torch_trainer.py::
test_every_run_train_flag_is_taken_or_refused_with_a_reason). argparse never
exits on a JAX eval command line."""

import pytest

from popcorn_tpu.cli.args import eval_parser as j_eval_parser
from popcorn_tpu_torch.cli.args import (
    eval_config_from_args,
    eval_parser,
    model_config_from_args,
    train_parser,
)
from popcorn_tpu_torch.config import EvalConfig

MEMBERS = ["-r", "m1.pth", "m2.pth"]


def _flag_cases():
    """One argv per run_eval.py option (every choice of a choice flag)."""
    cases = []
    for a in j_eval_parser()._actions:
        if not a.option_strings or a.dest in ("help", "resume"):
            continue
        opt = a.option_strings[-1]
        if a.choices:
            cases += [[opt, c] for c in a.choices]
        elif a.nargs in (0, "?"):
            cases.append([opt])
        elif a.type is int:
            # a patch must exceed twice the default overlap
            cases.append([opt, "512" if a.dest == "patchsize" else "2"])
        elif a.type is float:
            cases.append([opt, "0.5"])
        else:
            cases.append([opt, "rwa"])
    return cases


def _configs(argv):
    args = eval_parser().parse_args([*argv, *MEMBERS])
    model_config_from_args(args)
    return args, eval_config_from_args(args)


@pytest.mark.parametrize("argv", _flag_cases(), ids=lambda a: " ".join(a))
def test_every_run_eval_flag_is_taken_or_refused_with_a_reason(argv):
    try:
        _, ecfg = _configs(argv)
    except NotImplementedError as e:
        assert "ROADMAP.md Queue 1 item" in str(e), str(e)
        return
    assert isinstance(ecfg, EvalConfig)


@pytest.mark.parametrize(
    "argv,item",
    [(["--data_parallel", "2"], 16), (["--ensemble_parallel", "2"], 16),
     (["--multihost"], 16), (["--spatial"], 17)],
    ids=lambda v: " ".join(v) if isinstance(v, list) else str(v),
)
def test_refused_eval_flags_name_their_roadmap_item(argv, item):
    """The flags these items refused are ported now (items 16 and 17): they
    parse and check, their values reach the command line the CLI acts on
    (cli/eval.py spawns the ranks; EvalConfig.spatial takes the whole-frame
    path), and their help no longer names the item as a refusal."""
    args, ecfg = _configs(argv)
    dest = argv[0].lstrip("-")
    value = getattr(args, dest)
    assert value is True or value == int(argv[-1])
    assert ecfg.spatial == (dest == "spatial")
    from popcorn_tpu_torch.cli.args import n_ranks

    assert n_ranks(args) == (2 if dest in ("data_parallel", "ensemble_parallel") else 1)
    helps = {a.dest: a.help for a in eval_parser()._actions}
    assert f"item {item}" not in helps[dest] and "raises" not in helps[dest]


@pytest.mark.parametrize(
    "argv",
    [["--compile_cache"], ["--compile_cache", "/tmp/xla"], ["--fused_head"], ["--remat"],
     ["--debug_nans"], ["--device_feed", "auto"], ["--device_feed", "off"],
     ["--device_feed", "on"], ["--data_parallel", "1"], ["--transport", "exact"],
     ["--transport", "bf16"]],
    ids=lambda a: " ".join(a),
)
def test_accepted_eval_flags(argv):
    args, ecfg = _configs(argv)
    assert ecfg.debug_nans == ("--debug_nans" in argv)
    assert model_config_from_args(args).remat_unet == ("--remat" in argv)
    # the feed flags reach the EvalConfig the Evaluator passes on
    if "--device_feed" in argv:
        assert ecfg.device_feed == argv[-1]
    if "--transport" in argv:
        assert ecfg.transport == argv[-1]


@pytest.mark.parametrize(
    "argv,field,value",
    [(["--device_feed", "on"], "device_feed", "on"), (["--transport", "bf16"], "transport", "bf16"),
     (["--feed_gate", "off"], "feed_gate", "off")],
    ids=lambda v: " ".join(v) if isinstance(v, list) else str(v),
)
def test_train_feed_flags_are_taken(argv, field, value):
    from popcorn_tpu_torch.cli.args import train_config_from_args

    args = train_parser().parse_args(argv)
    assert getattr(train_config_from_args(args), field) == value


def test_no_fused_head_reaches_the_model_config_in_eval():
    args, _ = _configs(["--no_fused_head"])
    assert model_config_from_args(args).fused_head is False
    for argv in ([], ["--fused_head"]):
        assert model_config_from_args(_configs(argv)[0]).fused_head is True


def test_no_fused_head_reaches_the_model_config_in_train():
    args = train_parser().parse_args(["--no_fused_head"])
    assert model_config_from_args(args).fused_head is False
    assert model_config_from_args(train_parser().parse_args([])).fused_head is True


def test_package_exports_train_config():
    import popcorn_tpu
    import popcorn_tpu_torch
    from popcorn_tpu_torch.config import TrainConfig

    assert popcorn_tpu_torch.TrainConfig is TrainConfig
    assert set(popcorn_tpu.__all__) <= set(popcorn_tpu_torch.__all__)

"""ModelConfig.layout and pallas_packed_head in the port (nn/popcorn.py):
the config carries the JAX package's fields with its defaults, so the
args.csv that the port's trainer and Evaluator write holds the JAX
package's keys; every layout value the JAX package's select_engine names
runs the port's one engine and gives the same maps bit for bit, as does
pallas_packed_head; another layout raises."""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from popcorn_tpu.config import EvalConfig as JEvalConfig
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.config import TrainConfig as JTrainConfig
from popcorn_tpu_torch.compat.weights import save_popcorn_checkpoint
from popcorn_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from popcorn_tpu_torch.data.normalize import NormStats, normalize_and_assemble
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.infer.evaluator import Evaluator
from popcorn_tpu_torch.nn.init import init_popcorn
from popcorn_tpu_torch.nn.popcorn import LAYOUTS, check_config, popcorn_predict
from popcorn_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _keys(folder):
    with open(os.path.join(folder, "args.csv")) as f:
        return [row[0] for row in csv.reader(f)][1:]


def test_model_config_fields_match_jax():
    """The port's ModelConfig has the JAX package's fields in its order,
    layout and pallas_packed_head with its defaults (TrainConfig too)."""
    got, ref = dataclasses.asdict(ModelConfig()), dataclasses.asdict(JModelConfig())
    assert list(got) == list(ref)
    assert (got["layout"], got["pallas_packed_head"]) == (ref["layout"], ref["pallas_packed_head"])
    assert got["layout"] == "auto" and got["pallas_packed_head"] is None
    assert list(dataclasses.asdict(TrainConfig())) == list(dataclasses.asdict(JTrainConfig()))
    assert set(LAYOUTS) == {"auto", "packed", "wide", "spatial", "plain"}


def test_written_args_hold_the_jax_keys(tmp_path):
    """args.csv of a training run and of an eval holds the JAX package's
    ModelConfig keys in its order, layout and pallas_packed_head among
    them, and its TrainConfig's or EvalConfig's."""
    paths = make_synthetic_region(str(tmp_path / "data"), "rwa", height=64, width=96,
                                 n_regions=(2, 2), seed=3)
    mcfg = ModelConfig(pretrained=False)
    tr = Trainer(paths, mcfg, TrainConfig(target_regions=(), save_dir=str(tmp_path / "out"),
                                                    num_workers=1, device_feed="off"),
                 inference_patch=64, inference_overlap=8, device="cpu")
    jm = list(dataclasses.asdict(JModelConfig()))
    keys = _keys(tr.experiment_folder)
    assert keys[:len(jm)] == jm and set(keys[len(jm):]) == set(dataclasses.asdict(JTrainConfig()))
    member = str(tmp_path / "m.pth")
    params, consts = init_popcorn(0, mcfg)
    save_popcorn_checkpoint(member, params, consts)
    ev = Evaluator(paths, mcfg, EvalConfig(checkpoints=(member,)), device="cpu")
    keys = _keys(ev.experiment_folder)
    # the port's EvalConfig also carries debug_nans (run_eval.py's flag)
    assert keys[:len(jm)] == jm and set(keys[len(jm):]) >= set(dataclasses.asdict(JEvalConfig()))


@pytest.fixture(scope="module")
def small():
    params, consts = init_popcorn(0, ModelConfig(pretrained=False, biasinit=0.9407))
    rng = np.random.default_rng(1)
    x = normalize_and_assemble({"S2": torch.from_numpy(rng.uniform(0, 4000, (1, 48, 64, 4)).astype(np.float32)),
                                "S1": torch.from_numpy(rng.uniform(-25, 0, (1, 48, 64, 2)).astype(np.float32))},
                               NormStats())
    return params, consts, x


def _maps(small, **cfg):
    params, consts, x = small
    out = popcorn_predict(params, consts, {"input": x}, ModelConfig(pretrained=False, **cfg),
                          padding=False)
    return out["popdensemap"], out["scale"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pallas_packed_head", [None, True, False])
def test_every_layout_gives_the_same_maps(small, layout, pallas_packed_head):
    """Each layout value, with each pallas_packed_head value, runs the one
    NHWC engine: the maps equal the default config's bit for bit."""
    ref = _maps(small)
    got = _maps(small, layout=layout, pallas_packed_head=pallas_packed_head)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("layout", ["diagonal", "", "PLAIN"])
def test_unknown_layout_raises(small, layout):
    """A layout outside the JAX package's values raises (the JAX package
    falls through to its packed or plain engine)."""
    with pytest.raises(ValueError, match="layout"):
        check_config(ModelConfig(layout=layout))
    with pytest.raises(ValueError, match="layout"):
        _maps(small, layout=layout)

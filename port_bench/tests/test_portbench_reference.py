"""The plain reference against the program's plain CPU path, at float32 on
tiny sizes: the forward, the stitched maps, the census and the adjusted
map of a whole eval, and the first training steps. Both compute the same
float32 function, in other orders, so the gaps sit at float32 rounding."""

import os

import pytest
import torch

from port_bench.harness.weights import make_members
from port_bench.reference.model import Popcorn, dda_input, load_state, load_stats
from port_bench.tests.tiny import tiny_run

DDA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "weights", "fusionda_newAug8_16_checkpoint30_lossweight0.5.pt")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench"))


def test_forward_matches_the_programs(tmp_path):
    from popcorn_tpu_torch.compat.weights import load_popcorn_checkpoint
    from popcorn_tpu_torch.config import ModelConfig
    from popcorn_tpu_torch.data.normalize import NormStats, normalize_and_assemble
    from popcorn_tpu_torch.nn.popcorn import popcorn_predict

    path = make_members(DDA, str(tmp_path), 11, 1, perturb=0.1, biasinit=0.9407, device="cpu")[0]
    g = torch.Generator().manual_seed(0)
    s2 = torch.rand((1, 4, 64, 72), generator=g) * 3000  # R, G, B, NIR
    s1 = torch.randn((1, 2, 64, 72), generator=g) * 3 - 15
    net = Popcorn(load_state(path, "cpu"))
    x6 = dda_input(s2, s1, load_stats("cpu"))
    score = net.building_score("building_extractor.", x6)
    dense, scale = net.occupancy(x6, score)

    params, consts = load_popcorn_checkpoint(path)
    x = normalize_and_assemble({"S2": s2.permute(0, 2, 3, 1), "S1": s1.permute(0, 2, 3, 1)},
                               NormStats())
    out = popcorn_predict(params, consts, {"input": x}, ModelConfig(occupancy_model=True),
                          padding=None)
    assert torch.allclose(out["building_counts"], score, atol=1e-5)
    assert torch.allclose(out["scale"], scale, rtol=1e-4, atol=1e-5)
    assert torch.allclose(out["popdensemap"], dense, rtol=1e-4, atol=1e-5)


def _driven(name, cache, **model):
    from port_bench.harness.spec import driver_module

    run = tiny_run(name, cache, **model)
    drv = driver_module(run.cell.driver)
    drv.setup(run)
    drv.window(run, 0.5, None)
    drv.release(run)
    return drv.check(run)


def test_eval_maps_census_and_adjustment_match_the_programs(cache):
    n = _driven("eval-bag5-sidecar", cache, compute_dtype="float32")
    assert n["missing_visits"] == 0
    for k in ("map_rel", "map_std_rel", "scale_rel", "adj_rel", "census_rel", "adj_census_rel"):
        assert n[k] < 1e-5, (k, n[k])
    # the program forms each std from float32 sums of squares less n x mean^2,
    # which cancel where members agree: 2e-4 seen with two members
    assert n["scale_std_rel"] < 1e-3


def test_train_steps_match_the_programs(cache):
    n = _driven("train-member-resident", cache, compute_dtype="float32")
    assert n["batch_misses"] == 0
    assert n["loss_rel"] < 1e-5
    assert n["grad1_leaf_gap"] < 1e-4
    assert n["change_leaf_gap"] < 1e-3  # Adam divides by small second moments


def test_bf16_program_reads_above_float32(cache):
    n = _driven("eval-bag5-sidecar", cache)
    assert 1e-4 < n["map_rel"] < 0.1

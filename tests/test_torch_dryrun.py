"""The port's dry runs (popcorn_tpu_torch/dryrun.py, the counterpart of
__graft_entry__.py) on the CPU: ``dryrun_multichip(2)`` over two gloo CPU
ranks, spawned once for the module, with each of the JAX dry run's five
checks read from its record; the data-parallel step's loss held to the
port's one-process step on the same batch; ``dryrun_multihost`` over two
CPU workers; ``entry()`` on the CPU; and the card asked for where there is
none raising.

The fifth check's frame is the JAX dry run's 4 x n x 2 = 16 rows: the
reference's padding reflects it by 24 rows a side, more than the frame
holds, which numpy's (and jnp.pad's) 'reflect' does by reflecting again;
tests/test_torch_reflect_pad.py holds that padding to the JAX package's."""

import os

import numpy as np
import pytest
import torch

from popcorn_tpu_torch import dryrun

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def multichip():
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # each spawned rank's torch threads
    try:
        return dryrun.dryrun_multichip(2, device="cpu")
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads


def test_multichip_ranks(multichip):
    assert multichip["n"] == 2 and multichip["device"] == "cpu" and multichip["backend"] == "gloo"


def test_multichip_data_parallel_step_equals_one_process(multichip):
    """Check 1: the step of the batch's rows over two ranks gives the loss
    of the same step on one process."""
    from popcorn_tpu_torch.compat.weights import to_torch
    from popcorn_tpu_torch.config import ModelConfig, TrainConfig
    from popcorn_tpu_torch.data.normalize import NormStats
    from popcorn_tpu_torch.nn.init import init_popcorn
    from popcorn_tpu_torch.train.state import make_optimizer, make_train_step

    mcfg, tcfg = ModelConfig(pretrained=False, fused_head=False), TrainConfig(weak_batch_size=2)
    params, consts = init_popcorn(0, mcfg)
    opt = make_optimizer(tcfg)
    step = make_train_step(mcfg, tcfg, to_torch(consts), NormStats(device="cpu"), opt)
    rng = np.random.default_rng(0)
    b, h, w = 2, 64, 64
    batch = {
        "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
        "admin_mask": np.tile(np.arange(1, b + 1, dtype=np.float32)[:, None, None], (1, h, w)),
        "census_idx": np.arange(1, b + 1, dtype=np.float32),
        "y": rng.uniform(10, 1000, (b,)).astype(np.float32),
        "photometric": np.asarray([0.0, 1.0, 0.0, 1.0], np.float32),
    }
    params = to_torch(params)
    _, _, aux = step(params, opt.init(params), {k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.Generator().manual_seed(7))
    assert np.isfinite(multichip["loss"])
    np.testing.assert_allclose(multichip["loss"], float(aux["optimization_loss"]), rtol=1e-5)


def test_multichip_device_feed_step_bit_equal(multichip):
    """Check 2: the mesh-aware device feed's batch steps to the host
    feed's parameters bit for bit."""
    assert multichip["feed_leaves_bit_equal"] == multichip["feed_leaves"] > 0
    host, device = multichip["feed_loss"]
    assert host == device and np.isfinite(device)


def test_multichip_spatial_train_step(multichip):
    """Check 3: one crop whose rows span the two ranks trains to a finite
    loss."""
    assert np.isfinite(multichip["sp_train_loss"])


def test_multichip_ensemble_fold(multichip):
    """Check 4: the 3-member fold over a (1 data, 2 ensemble) grid."""
    assert np.isfinite(multichip["ensemble_dense_sum"]) and multichip["ensemble_dense_sum"] > 0


def test_multichip_spatial_density_map(multichip):
    """Check 5: the whole 16x64 frame's rows over the two ranks."""
    assert multichip["spatial_shape"] == [16, 64] and np.isfinite(multichip["spatial_count"])


def test_multihost_workers_agree(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rec = dryrun.dryrun_multihost(2, 1, device="cpu")
    assert len(rec["loss"]) == 2 and rec["loss"][0] == rec["loss"][1]
    assert np.isfinite(rec["enssum"]).all()


def test_entry_forward_on_the_cpu():
    fn, (s2, s1) = dryrun.entry("cpu")
    assert s2.shape == (1, 512, 512, 4) and s1.shape == (1, 512, 512, 2)
    dense, count = fn(s2, s1)
    assert dense.shape == (1, 512, 512) and dense.dtype == torch.float32
    assert bool(torch.isfinite(dense).all()) and np.isfinite(float(count[0]))


@pytest.mark.parametrize("call", [lambda: dryrun.entry(), lambda: dryrun.dryrun_multichip(2),
                                  lambda: dryrun.dryrun_multihost(2)],
                         ids=["entry", "multichip", "multihost"])
def test_the_card_is_asked_for_by_default(call):
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        call()


def test_multichip_needs_two_ranks():
    with pytest.raises(ValueError, match="at least 2"):
        dryrun.dryrun_multichip(1, device="cpu")

"""The slice as a whole on the CPU: the port's sliding-window ensemble
inference and Evaluator against the JAX package's, on the same synthetic
region and the same two .pth members (the repo's DDA weights and seeded
heads).

Maps at rtol 2e-4 / atol 2e-5 (float32 through both UNets, different but
equivalent summation orders); visit counts equal; census metrics to 1e-3
relative (the JAX Evaluator sums regions in float32 on its device, the
port in float64).

The std maps are held through their variance: std = sqrt((S2 - n*m^2)/
(n-1)) cancels where the members agree, so a float32 rounding of the
sum of squares S2 moves std by about sqrt(eps * S2), not by eps. The
variance is compared at rtol 2e-4 plus 16 float32 ulps of S2."""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda, save_popcorn_checkpoint
from popcorn_tpu.config import EvalConfig as JEvalConfig
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.infer.evaluator import Evaluator as JEvaluator
from popcorn_tpu.infer.evaluator import load_member as j_load_member
from popcorn_tpu.infer.sliding import run_sliding_inference as j_run
from popcorn_tpu_torch.config import EvalConfig, ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.infer.evaluator import Evaluator, load_member
from popcorn_tpu_torch.infer.sliding import run_sliding_inference

torch.set_num_threads(1)
MAP_TOL = dict(rtol=2e-4, atol=2e-5)
PATCH, OVERLAP = 96, 16
PRODUCTS = ("", "STD", "SCALE_rwa", "SCALE_STD", "ADJ_rwa")


def _dataset(cls, paths):
    return cls(paths, "rwa", mode="test", patchsize=PATCH, overlap=OVERLAP,
               fourseasons=False, train_level="coarse")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_data"))
    paths = j_make(root, "rwa", height=192, width=256, seed=21)
    mdir = tmp_path_factory.mktemp("members")
    cks = []
    for i in range(2):
        params, consts = load_popcorn_from_dda(
            JModelConfig(biasinit=0.9407), head_key=jax.random.PRNGKey(50 + i)
        )
        cks.append(str(mdir / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    return root, paths, cks


def test_synthetic_region_is_byte_identical(setup, tmp_path):
    root, _, _ = setup
    make_synthetic_region(str(tmp_path), "rwa", height=192, width=256, seed=21)
    files = []
    for d, _, names in os.walk(root):
        files += [os.path.relpath(os.path.join(d, n), root) for n in names]
    assert files
    for rel in files:
        assert filecmp.cmp(os.path.join(root, rel), os.path.join(tmp_path, rel), shallow=False), rel


@pytest.mark.parametrize("level", ["coarse", "fine100"])
def test_census_aggregation_matches_jax(setup, level):
    """convert/adjust/detail maps on the host and DeviceCensus against the
    JAX package's host functions on one random map (float64 vs float32
    segment sums: rtol 1e-5)."""
    import pandas as pd

    from popcorn_tpu.agg import census_agg as jagg
    from popcorn_tpu_torch.agg import census_agg as agg
    from popcorn_tpu_torch.io.geotiff import GeoTIFF

    _, paths, _ = setup
    with GeoTIFF(paths.boundary_path("rwa", level)) as g:
        boundary = g.read(1, squeeze=True)
    census = pd.read_csv(paths.census_path("rwa", level))
    pred = np.random.default_rng(61).gamma(2.0, 3.0, boundary.shape).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)

    got_c, got_gt = agg.convert_popmap_to_census(pred, boundary, census)
    ref_c, ref_gt = jagg.convert_popmap_to_census(pred, boundary, census)
    np.testing.assert_allclose(got_c, ref_c, **tol)
    np.testing.assert_array_equal(got_gt, ref_gt)
    ref_adj = jagg.adjust_map_to_census(pred, boundary, census)
    np.testing.assert_allclose(agg.adjust_map_to_census(pred, boundary, census), ref_adj, **tol)
    dc = agg.DeviceCensus(boundary, census, "cpu")
    np.testing.assert_allclose(dc.convert(torch.from_numpy(pred))[0], ref_c, **tol)
    np.testing.assert_allclose(dc.adjust(torch.from_numpy(pred)).numpy(), ref_adj, **tol)
    ref_det = jagg.detail_maps(pred, boundary, census)
    got_det = agg.detail_maps(pred, boundary, census)
    assert got_det.keys() == ref_det.keys()
    for k in ref_det:
        np.testing.assert_allclose(got_det[k], ref_det[k], err_msg=k, **tol)


def test_sliding_inference_matches_jax(setup):
    _, paths, cks = setup
    jmembers = [j_load_member(p) for p in cks]
    ref = j_run([m[0] for m in jmembers], jmembers[0][1], JModelConfig(), _dataset(JDataset, paths))
    members = [load_member(p) for p in cks]
    got = run_sliding_inference(
        [m[0] for m in members], members[0][1], ModelConfig(), _dataset(PopulationDataset, paths),
        device="cpu",
    )
    for k in ("map", "scale"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), err_msg=k, **MAP_TOL)
    n = np.asarray(ref["count"], np.float64)
    for mean_k, std_k in (("map", "map_std"), ("scale", "scale_std")):
        var_ref = np.asarray(ref[std_k], np.float64) ** 2
        var_got = np.asarray(got[std_k], np.float64) ** 2
        s2 = (n - 1) * var_ref + n * np.asarray(ref[mean_k], np.float64) ** 2
        bound = 2e-4 * var_ref + 16 * np.finfo(np.float32).eps * s2
        assert (np.abs(var_got - var_ref) <= bound).all(), std_k
        assert var_ref.max() > 0, std_k
    np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))
    assert got["map"].max() > 0


def test_evaluator_matches_jax(setup):
    _, paths, cks = setup
    jev = JEvaluator(paths, JModelConfig(), JEvalConfig(checkpoints=tuple(cks)))
    jev.datasets = [_dataset(JDataset, paths)]
    ref = jev.test_target(save=False)

    ev = Evaluator(paths, ModelConfig(), EvalConfig(checkpoints=tuple(cks)), device="cpu")
    ev.datasets = [_dataset(PopulationDataset, paths)]
    out = ev.test_target(save=True)
    for tag in PRODUCTS:
        assert os.path.exists(os.path.join(ev.experiment_folder, f"rwa_predictions{tag}.tif")), tag
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert out["Population_AdjCensus_rwa_coarse/r2"] > 0.9


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU; a
    missing card raises instead of dropping to the CPU."""
    import inspect

    from popcorn_tpu_torch.infer import sliding

    assert inspect.signature(run_sliding_inference).parameters["device"].default == "cuda"
    assert inspect.signature(Evaluator).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        sliding.resolve_device("cuda")
    assert sliding.resolve_device("cpu").type == "cpu"

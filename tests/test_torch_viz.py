"""The port's plots (popcorn_tpu_torch/utils/viz.py): the quick-look figure
against the JAX package's save_quicklook on the same arrays (the same
image size), the population time series' totals.png (drawn as
popcorn_tpu/infer/pop_timeseries.py draws it), and the time series without
matplotlib: totals.csv alone, no error."""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from popcorn_tpu.utils import viz as j_viz
from popcorn_tpu_torch.compat.weights import to_torch
from popcorn_tpu_torch.config import DataPaths, ModelConfig
from popcorn_tpu_torch.data.synthetic import make_synthetic_region
from popcorn_tpu_torch.infer.pop_timeseries import run_population_timeseries
from popcorn_tpu_torch.nn.init import init_popcorn
from popcorn_tpu_torch.utils import viz

torch.set_num_threads(1)


def _png(path):
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("panels", [("s2", "s1", "builtup", "pop"), ("pop",)])
def test_save_quicklook_matches_jax(tmp_path, panels):
    rng = np.random.default_rng(0)
    arrays = {"s2": rng.uniform(0, 4000, (48, 64, 4)).astype(np.float32),
              "s1": rng.uniform(-25, 0, (48, 64)).astype(np.float32),
              "builtup": rng.random((48, 64)).astype(np.float32),
              "pop": np.where(rng.random((48, 64)) < 0.3, rng.random((48, 64)) * 50, 0).astype(np.float32)}
    kw = {k: arrays[k] for k in panels}
    got = viz.save_quicklook(str(tmp_path / "port.png"), **kw)
    j_viz.save_quicklook(str(tmp_path / "jax.png"), **kw)
    a, b = _png(got), _png(str(tmp_path / "jax.png"))
    assert a.shape == b.shape and a.shape[1] == 120 * 5 * len(panels)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz_steps")
    out = []
    for label, seed in (("2020", 1), ("2021", 2)):
        make_synthetic_region(str(root / label), "rwa", height=96, width=96, n_regions=(2, 2), seed=seed)
        out.append((label, DataPaths(str(root / label)), "rwa"))
    params, consts = init_popcorn(3, ModelConfig(pretrained=False))
    return out, to_torch(params), to_torch(consts)


def _run(steps, out):
    tsteps, params, consts = steps
    return run_population_timeseries([params], consts, ModelConfig(pretrained=False), tsteps, out,
                                     patchsize=64, overlap=8, fourseasons=False, device="cpu")


def test_population_timeseries_draws_totals_png(steps, tmp_path):
    recs = _run(steps, str(tmp_path / "port"))
    img = _png(str(tmp_path / "port" / "totals.png"))
    assert img.shape == (4 * 120, 7 * 120, 3)
    # the same records through viz.save_totals_plot draw the same figure
    viz.save_totals_plot(str(tmp_path / "again.png"), recs)
    np.testing.assert_array_equal(_png(str(tmp_path / "again.png")), img)


def test_population_timeseries_without_matplotlib(steps, tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        viz.save_totals_plot(str(tmp_path / "x.png"), [])
    recs = _run(steps, str(tmp_path / "no_plot"))
    assert len(recs) == 2
    assert os.path.exists(tmp_path / "no_plot" / "totals.csv")
    assert not os.path.exists(tmp_path / "no_plot" / "totals.png")

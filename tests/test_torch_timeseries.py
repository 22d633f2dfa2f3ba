"""The time series in the port (infer/timeseries.py,
infer/pop_timeseries.py, cli/timeseries.py) against the JAX package's on
the same numpy-seeded frames, the same synthetic regions and the same
weights (the repo's DDA checkpoint; two members with seeded heads).

Tolerances: built-up maps rtol 2e-4 / atol 2e-5 (TOL, float32 through the
frozen extractor in another but equivalent summation order,
tests/test_torch_popcorn.py); population totals rtol 2e-4; the std total
rtol 2e-3, since a std is the square root of a cancelling difference
(tests/test_torch_eval.py holds the std maps through their variance)."""

import csv
import datetime as dt
import json
import os

import jax
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda as j_load_popcorn_from_dda
from popcorn_tpu.compat.torch_convert import save_popcorn_checkpoint
from popcorn_tpu.config import DataPaths as JDataPaths
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.infer import timeseries as jts
from popcorn_tpu.infer.evaluator import load_member as j_load_member
from popcorn_tpu.infer.pop_timeseries import run_population_timeseries as j_run_pop
from popcorn_tpu.io.geotiff import write_geotiff
from popcorn_tpu_torch.cli import timeseries as ts_cli
from popcorn_tpu_torch.compat.weights import from_jax
from popcorn_tpu_torch.config import DataPaths, ModelConfig
from popcorn_tpu_torch.infer import timeseries as ts
from popcorn_tpu_torch.infer.evaluator import load_member
from popcorn_tpu_torch.infer.pop_timeseries import run_population_timeseries
from popcorn_tpu_torch.io.geotiff import GeoTIFF

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
TOTAL_RTOL, STD_TOTAL_RTOL = 2e-4, 2e-3
PATCH, OVERLAP = 64, 8


@pytest.fixture(scope="module")
def extractor():
    _, jconsts = j_load_popcorn_from_dda(JModelConfig(biasinit=0.9407), head_key=jax.random.PRNGKey(0))
    jconsts = jax.tree.map(np.asarray, jconsts)
    return jconsts, from_jax({}, jconsts)[1]


def _frames(d):
    return [ts.Frame(ts.parse_date(s), p) for s, p in d]


def test_parse_date_and_matching_as_jax():
    assert ts.parse_date("2023-10-01") == jts.parse_date("2023-10-01") == dt.date(2023, 10, 1)
    assert ts.parse_date("20231001") == dt.date(2023, 10, 1)
    with pytest.raises(ValueError, match="unparseable"):
        ts.parse_date("01/10/2023")
    s2 = [("2023-01-10", "a"), ("2023-02-10", "b"), ("2023-03-30", "c")]
    desc = [("2023-01-08", "d1"), ("2023-02-20", "d2")]
    asc = [("2023-01-30", "a1")]

    def paths(pairs):
        return [tuple(f.path if f is not None else None for f in p) for p in pairs]

    for d, a in ((desc, asc), (desc, []), ([], asc)):
        got = ts.find_closest_frames(_frames(s2), _frames(d), _frames(a))
        ref = jts.find_closest_frames(*[[jts.Frame(jts.parse_date(s), p) for s, p in x]
                                        for x in (s2, d, a)])
        assert paths(got) == paths(ref)
    single = ts.find_closest_frames(_frames(s2[:1]), _frames(desc), [])
    assert single[0][1].path == "d1" and single[0][2] is None
    with pytest.raises(ValueError, match="no S1 frames"):
        ts.find_closest_frames(_frames(s2), [], [])


@pytest.mark.parametrize("patch", [128, 64], ids=["one_shot", "tiled"])
def test_builtup_map_matches_jax(extractor, patch):
    jconsts, consts = extractor
    rng = np.random.default_rng(20)
    s2 = rng.uniform(0, 4000, (96, 96, 4)).astype(np.float32)
    s1 = rng.uniform(-25, 0, (96, 96, 2)).astype(np.float32)
    ref = jts.builtup_map(jconsts, JModelConfig(), s2, s1, patchsize=patch, overlap=8)
    got = ts.builtup_map(consts, ModelConfig(), s2, s1, patchsize=patch, overlap=8, device="cpu")
    assert got.shape == (96, 96) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    assert (got >= 0).all() and (got <= 1).all()


def test_mesh_names_its_roadmap_item(extractor):
    """builtup_map(mesh=), ROADMAP.md Queue 1 item 17's inference half, now
    ported: the whole frame in one call (infer/spatial.py) against the JAX
    package's mesh path on the frame padded the same way (a one-device
    mesh: rows to 4, columns to 32), and against the port's patch path on
    a frame that fits one patch (tests/test_spatial.py's bound)."""
    from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh
    from popcorn_tpu_torch.dist.mesh import make_mesh

    jconsts, consts = extractor
    rng = np.random.default_rng(23)
    s2 = rng.uniform(0, 4000, (72, 50, 4)).astype(np.float32)
    s1 = rng.uniform(-25, 0, (72, 50, 2)).astype(np.float32)
    got = ts.builtup_map(consts, ModelConfig(), s2, s1, mesh=make_mesh(devices=["cpu"]))
    ref = jts.builtup_map(jconsts, JModelConfig(), s2, s1, mesh=j_make_mesh(1))
    assert got.shape == (72, 50)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    s2p, s1p = s2[:64, :32], s1[:64, :32]
    np.testing.assert_allclose(
        ts.builtup_map(consts, ModelConfig(), s2p, s1p, mesh=make_mesh(devices=["cpu"])),
        ts.builtup_map(consts, ModelConfig(), s2p, s1p, patchsize=128, device="cpu"),
        rtol=2e-5, atol=2e-6)


def _write_frames(root, rng, size, dates, orbits=("s1_desc", "s1_asc")):
    """Dated S2 frames (4 bands) and S1 frames (2 bands) a few days off,
    with NaNs in one S1 frame (the reader heals them); frames.json."""
    spec = {"s2": [], "s1_desc": [], "s1_asc": []}
    t = (30.0, 1e-4, -1.5, 1e-4)
    for i, date in enumerate(dates):
        p2 = os.path.join(root, f"s2_{i}.tif")
        write_geotiff(p2, rng.uniform(0, 4000, (4, size, size)).astype(np.float32), transform=t)
        spec["s2"].append({"date": date, "path": p2})
        for j, key in enumerate(orbits):
            s1 = rng.uniform(-25, 0, (2, size, size)).astype(np.float32)
            if i == 0 and j == 0:
                s1[:, 5:9, 10:20] = np.nan
            p1 = os.path.join(root, f"{key}_{i}.tif")
            write_geotiff(p1, s1, transform=t)
            day = (dt.date.fromisoformat(date) + dt.timedelta(days=j + 1)).isoformat()
            spec[key].append({"date": day, "path": p1})
    path = os.path.join(root, "frames.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec, path


def _jax_pairs(spec):
    return jts.find_closest_frames(*[[jts.Frame(jts.parse_date(r["date"]), r["path"]) for r in spec[k]]
                                     for k in ("s2", "s1_desc", "s1_asc")])


def _assert_geotiffs_match(got_paths, ref_paths):
    assert [os.path.basename(p) for p in got_paths] == [os.path.basename(p) for p in ref_paths]
    for g, r in zip(got_paths, ref_paths):
        with GeoTIFF(g) as a, GeoTIFF(r) as b:
            np.testing.assert_allclose(a.read(1, squeeze=True), b.read(1, squeeze=True), **TOL)
            assert a.transform == b.transform and a.transform is not None


@pytest.mark.parametrize("size,patch,orbits", [(64, 128, ("s1_desc", "s1_asc")),
                                               (96, 64, ("s1_desc",))],
                         ids=["both_orbits", "desc_only_tiled"])
def test_run_builtup_timeseries_matches_jax(extractor, tmp_path, size, patch, orbits):
    jconsts, consts = extractor
    spec, _ = _write_frames(str(tmp_path), np.random.default_rng(21), size,
                            ["2023-01-05", "2023-06-05"], orbits)
    ref = jts.run_builtup_timeseries(jconsts, JModelConfig(), _jax_pairs(spec),
                                     str(tmp_path / "jax"), patchsize=patch, overlap=8)
    pairs = ts.find_closest_frames(*[[ts.Frame(ts.parse_date(r["date"]), r["path"]) for r in spec[k]]
                                     for k in ("s2", "s1_desc", "s1_asc")])
    got = ts.run_builtup_timeseries(consts, ModelConfig(), pairs, str(tmp_path / "port"),
                                    patchsize=patch, overlap=8, device="cpu")
    assert [os.path.basename(p) for p in got] == ["BuiltUp_2023-01-05.tif", "BuiltUp_2023-06-05.tif"]
    _assert_geotiffs_match(got, ref)


def test_builtup_cli_on_the_cpu(extractor, tmp_path):
    """The CLI's builtup mode (the repo's DDA weights, its default
    patches, --device cpu) against the JAX function that run_timeseries.py
    builtup calls."""
    jconsts, _ = extractor
    spec, frames_json = _write_frames(str(tmp_path), np.random.default_rng(22), 48, ["2022-12-31"])
    ref = jts.run_builtup_timeseries(jconsts, JModelConfig(), _jax_pairs(spec), str(tmp_path / "jax"))
    got = ts_cli.main(["builtup", "--frames", frames_json, "--out-dir", str(tmp_path / "port"),
                       "--device", "cpu"])
    _assert_geotiffs_match(got, ref)
    # --spatial: each whole frame in one call, as the JAX CLI's mesh path
    from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh

    ref_sp = jts.run_builtup_timeseries(jconsts, JModelConfig(), _jax_pairs(spec),
                                        str(tmp_path / "jax_sp"), mesh=j_make_mesh(1))
    got_sp = ts_cli.main(["builtup", "--frames", frames_json, "--out-dir", str(tmp_path / "sp"),
                          "--spatial", "--device", "cpu"])
    _assert_geotiffs_match(got_sp, ref_sp)


def test_builtup_cli_spatial_without_a_card_raises(tmp_path, monkeypatch):
    """builtup --spatial at the default --device cuda on a host without a
    card raises before it writes anything; no frame moves to the CPU."""
    _, frames_json = _write_frames(str(tmp_path), np.random.default_rng(22), 48, ["2022-12-31"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        ts_cli.main(["builtup", "--frames", frames_json, "--out-dir", str(tmp_path / "sp"),
                     "--spatial"])
    assert not os.path.exists(tmp_path / "sp")


@pytest.fixture(scope="module")
def population(tmp_path_factory):
    """Two 128^2 synthetic time steps and two .pth members."""
    root = tmp_path_factory.mktemp("pop")
    steps = []
    for label, seed in (("2020", 1), ("2021", 2)):
        j_make(str(root / label), "rwa", height=128, width=128, n_regions=(2, 2), seed=seed)
        steps.append({"label": label, "data_root": str(root / label), "region": "rwa"})
    cks = []
    for i in range(2):
        params, consts = j_load_popcorn_from_dda(JModelConfig(biasinit=0.9407),
                                                 head_key=jax.random.PRNGKey(60 + i))
        cks.append(str(root / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    jmembers = [j_load_member(p) for p in cks]
    jsteps = [(s["label"], JDataPaths(s["data_root"]), s["region"]) for s in steps]
    jout = str(root / "jax")
    ref = j_run_pop([m[0] for m in jmembers], jmembers[0][1], JModelConfig(), jsteps, jout,
                    patchsize=PATCH, overlap=OVERLAP, fourseasons=False)
    return root, steps, cks, ref, jout


def _read_totals(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_totals_match(got, ref):
    assert [r["label"] for r in got] == [r["label"] for r in ref] == ["2020", "2021"]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["total_population"], r["total_population"], rtol=TOTAL_RTOL)
        np.testing.assert_allclose(g["total_std"], r["total_std"], rtol=STD_TOTAL_RTOL)
        assert g["total_std"] > 0


def _assert_outputs_match(out, jout):
    header, rows = _read_totals(os.path.join(out, "totals.csv"))
    jheader, jrows = _read_totals(os.path.join(jout, "totals.csv"))
    assert header == jheader == ["label", "total_population", "total_std"]
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    for r, jr in zip(rows, jrows):
        np.testing.assert_allclose(float(r[1]), float(jr[1]), rtol=TOTAL_RTOL)
    for label in ("2020", "2021"):
        for tag in ("", "_STD"):
            name = f"rwa_predictions_{label}{tag}.tif"
            assert os.path.exists(os.path.join(out, name)) and os.path.exists(os.path.join(jout, name))
        with GeoTIFF(os.path.join(out, f"rwa_predictions_{label}.tif")) as a, \
                GeoTIFF(os.path.join(jout, f"rwa_predictions_{label}.tif")) as b:
            np.testing.assert_allclose(a.read(1, squeeze=True), b.read(1, squeeze=True), **TOL)


def test_run_population_timeseries_matches_jax(population, tmp_path):
    _, steps, cks, ref, jout = population
    members = [load_member(p) for p in cks]
    tsteps = [(s["label"], DataPaths(s["data_root"]), s["region"]) for s in steps]
    got = run_population_timeseries([m[0] for m in members], members[0][1], ModelConfig(), tsteps,
                                    str(tmp_path), patchsize=PATCH, overlap=OVERLAP,
                                    fourseasons=False, device="cpu")
    _assert_totals_match(got, ref)
    _assert_outputs_match(str(tmp_path), jout)
    # the CSV holds each total as repr() of the float, as pandas' to_csv
    _, rows = _read_totals(os.path.join(str(tmp_path), "totals.csv"))
    assert rows == [[r["label"], repr(r["total_population"]), repr(r["total_std"])] for r in got]


def test_population_cli_on_the_cpu(population, tmp_path):
    """The CLI's population mode (.pth members, the eval CLI's flags,
    --compute_dtype float32 as the JAX run here, --device cpu)."""
    _, steps, cks, ref, jout = population
    steps_json = str(tmp_path / "steps.json")
    with open(steps_json, "w") as f:
        json.dump(steps, f)
    argv = ["population", "--steps", steps_json, "--out-dir", str(tmp_path / "out"),
            "-r", *cks, "-S1", "-S2", "-NIR", "-occmodel", "-senbuilds", "--compute_dtype",
            "float32", "--patchsize", str(PATCH), "--patch_overlap", str(OVERLAP), "--device", "cpu"]
    got = ts_cli.main(argv)
    _assert_totals_match(got, ref)
    _assert_outputs_match(str(tmp_path / "out"), jout)
    # --spatial: each step's eval whole-frame, against the JAX package's
    # whole-frame eval of the step (run_timeseries.py parses and ignores
    # the flag; infer/spatial.py::run_spatial_inference is its function)
    from popcorn_tpu.config import DataPaths as JDataPaths
    from popcorn_tpu.data.dataset import PopulationDataset as JDataset
    from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh
    from popcorn_tpu.infer.spatial import run_spatial_inference as j_spatial

    sp_dir = str(tmp_path / "sp")
    got_sp = ts_cli.main([*argv[:4], sp_dir, *argv[5:], "--spatial"])
    jmembers = [j_load_member(p) for p in cks]
    for rec, step in zip(got_sp, steps):
        jds = JDataset(JDataPaths(step["data_root"]), "rwa", mode="test", patchsize=PATCH,
                       overlap=OVERLAP, fourseasons=False)
        ref_sp = j_spatial([m[0] for m in jmembers], jmembers[0][1], JModelConfig(), jds,
                           mesh=j_make_mesh(1))
        jds.close()
        np.testing.assert_allclose(rec["total_population"], float(ref_sp["map"].sum()),
                                   rtol=TOTAL_RTOL)
        np.testing.assert_allclose(rec["total_std"], float(ref_sp["map_std"].sum()),
                                   rtol=STD_TOTAL_RTOL)
    assert os.path.exists(os.path.join(sp_dir, "totals.csv"))
    with pytest.raises(SystemExit):
        ts_cli.main(["nosuchmode"])

"""The harness on the CPU: it finds every file by name, its names keep the
benchmark's alphabet, the traffic is a function of data_seed, the cell's
grid and the copied arithmetic are right, and a run without a card
measures nothing."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from port_bench.harness import spec
from port_bench.harness.trace import reduce_trace
from port_bench.reference.evaluate import patch_grid
from port_bench.roofline import bounds, flops
from port_bench.traffic.region import make_region, read_level, read_season
from port_bench.traffic.tiff import read_tiff, write_tiff

BENCH = spec.BENCH_DIR
ROOT = spec.ROOT
B = spec.benchmark()
HELD = spec.with_held()  # BENCHMARK.json and the cells held out of it


def test_benchmark_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["port_bench"] and B["command"][1] == "port_bench/run.py"
    assert 1 <= B["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in HELD["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.load_cell(cell, bench=HELD)
    assert os.path.exists(os.path.join(BENCH, "drivers", f"{c.driver}.py"))
    assert spec.limits(c.config_name)
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    assert c.chips == 1


@pytest.mark.parametrize("metric", [m["name"] for m in HELD["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


@pytest.mark.parametrize("cfg", HELD["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = os.path.join(ROOT, cfg["file"])
    assert cfg["file"].startswith("port_bench/")
    with open(path) as f:
        c = json.load(f)
    assert c["name"] == cfg["name"] and c["reduced"] == cfg["reduced"]
    assert c["model"]["compute_dtype"] == "bfloat16"


def test_names_and_units():
    for b in (B, HELD):
        names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
        names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
        names += [r for c in b["configs"] for r in c["reduced"]]
        for n in names:
            assert spec.NAME.match(n), n
        for m in b["end_to_end"] + b["per_layer"]:
            assert spec.UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            got = [x["name"] for x in b[group]]
            assert len(got) == len(set(got))
        e2e = {m["name"] for m in b["end_to_end"]}
        assert all(m["moves"] in e2e for m in b["per_layer"])
        cells = {w["name"] for w in b["workloads"]}
        assert all(set(m.get("workloads", cells)) <= cells for m in b["end_to_end"] + b["per_layer"])
        assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
        for w in b["workloads"] + b["configs"] + b["per_layer"]:
            for k in ("why", "layer", "source"):
                if k in w:
                    assert 1 <= len(w[k]) <= 200 and "\n" not in w[k] and "\t" not in w[k]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_rooflines_are_named_by_kernel():
    for m in HELD["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^\w+_roofline(\.\w+)?$", m["name"]), m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_generator_is_a_function_of_data_seed(tmp_path):
    kw = dict(height=130, width=150, n_regions=(3, 2))
    for d, seed in (("a", 3), ("b", 3), ("c", 4)):
        make_region(str(tmp_path / d), data_seed=seed, **kw)
    sa, sb, sc = (read_season(str(tmp_path / d), "autumn") for d in "abc")
    assert np.array_equal(sa[0], sb[0]) and np.array_equal(sa[1], sb[1])
    assert not np.array_equal(sa[0], sc[0])
    la, lb = (read_level(str(tmp_path / d), "fine100") for d in "ab")
    assert np.array_equal(la[0], lb[0]) and la[1].equals(lb[1])


def test_tiff_round_trip_and_the_program_reads_it(tmp_path):
    from popcorn_tpu_torch.io.geotiff import GeoTIFF

    rng = np.random.default_rng(0)
    for dt, shape in ((np.uint16, (4, 300, 270)), (np.float32, (2, 257, 513))):
        a = (rng.random(shape) * 1000).astype(dt)
        p = str(tmp_path / f"x_{np.dtype(dt).name}.tif")
        write_tiff(p, a, nodata=0.0)
        assert np.array_equal(read_tiff(p), a)
        with GeoTIFF(p) as g:
            assert np.array_equal(g.read(None, raw=True), a)


def test_the_cell_grid_makes_36_visits_a_map():
    grid = patch_grid(4608, 4608, 2048, 128, True)
    assert len(grid) == 36 and len({(x, y) for x, y, _ in grid}) == 9
    from popcorn_tpu_torch.data.dataset import patch_grid as program_grid

    assert sorted(map(tuple, program_grid((4608, 4608), 2048, 128, True).tolist())) == sorted(grid)


def test_copied_flops_and_peaks_equal_the_programs():
    from popcorn_tpu_torch.utils import flops as program

    for args in ((2048, 2048, 5), (1000, 700, 1)):
        assert flops.eval_patch_flops(*args) == program.eval_patch_flops(*args)
    assert flops.train_step_flops(1024, 512, 2) == program.train_step_flops(1024, 512, 2)
    for name, peaks in program._PEAKS_TFLOPS.items():
        assert flops.PEAKS_TFLOPS[name] == peaks


def test_launch_counts_add_up_to_the_analytic_flops():
    launches = bounds.eval_patch_launches(2048, 5)
    unet = [l for l in launches if l[0] in ("double_conv", "up_block")]
    head = [l for l in launches if l[0] == "head"]
    assert len(unet) == 10 * 6 and len(head) == 5
    member_feats = sum(l[1] for l in bounds.unet_launches(1, 2048, 2048))
    assert member_feats == pytest.approx(flops.features_flops_per_px() * 2048 ** 2)
    step = bounds.train_step_launches(2, 512, 256, False)
    assert {l[0] for l in step} == {"double_conv", "up_block", "head", "head_bwd"}
    b = bounds.bounds_by_function(launches, "NVIDIA H100 80GB HBM3")
    assert all(v > 0 for v in b.values())


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.unit", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "eval.census", "ts": 60, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void double_conv_kernel<float, 2, 8, 8>(x)",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void double_conv_q_kernel<float>(x)", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 5},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    r = reduce_trace(str(p), {"double_conv": ["double_conv_kernel"]})
    assert r["window_s"] == pytest.approx(100e-6) and r["busy_s"] == pytest.approx(35e-6)
    assert r["device_s_by_function"] == {"double_conv": pytest.approx(20e-6)}
    assert dict(r["idle_gaps"])["eval.census"] == pytest.approx(50e-6)  # the gap 40-90 us


def test_a_run_without_a_card_measures_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        B["workloads"][0]["name"], "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not re.search(r"^\{.*\}\s*$", p.stdout, re.M)
    assert "no measurement" in p.stderr


class _Tracer:
    """Stands for harness/trace.py's Tracer: notes when each unit began."""

    def __init__(self, count):
        self.count, self.done, self.began = count, False, []

    def unit_begin(self, i):
        import time

        self.began.append(time.perf_counter())

    def unit_end(self, i):
        if i == self.count - 1:
            self.done = True


@pytest.mark.parametrize("cell", ["eval-bag5-sidecar", "train-member-resident"])
def test_traced_units_run_after_the_window(cell, tmp_path):
    """The profiler's units run once the window has closed, so that the
    window's host clocks, which the host-clock metrics read, run untraced."""
    import time

    from port_bench.tests.tiny import tiny_run

    run = tiny_run(cell, str(tmp_path))
    drv = spec.driver_module(run.cell.driver)
    drv.setup(run)
    tracer = _Tracer(run.cell.workload["trace"]["count"])
    t0 = time.perf_counter()
    record = drv.window(run, 0.2, tracer)
    assert len(record["traced"]) == tracer.count == len(tracer.began)
    assert min(tracer.began) >= t0 + record["window_s"]

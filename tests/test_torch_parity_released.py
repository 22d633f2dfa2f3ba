"""The port's released-weights parity harness
(popcorn_tpu_torch/tools/parity_released.py): its --selftest on the CPU,
run as a user runs it (every surface's census metrics finite, the eval
CLI's metrics equal to the harness's, no kernel launched off the card);
``diff_expected``'s table and verdict against tools/parity_released.py's on
the same metrics; and the card asked for where there is none raising."""

import json
import os
import subprocess
import sys

import pytest

from popcorn_tpu_torch.tools import parity_released as harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import parity_released as j_harness  # noqa: E402  (tools/ is not a package)


def test_selftest_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "popcorn_tpu_torch.tools.parity_released", "--selftest",
                        "--device", "cpu"], cwd=ROOT, env={**env, "OMP_NUM_THREADS": "2"},
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])["selftest"]
    assert set(rec) == {"stitched", "spatial", "int8s", "transport_bf16", "cli_equals_harness"}
    assert rec["cli_equals_harness"] is True
    for surface in ("stitched", "spatial", "int8s", "transport_bf16"):
        assert rec[surface]["n_metrics"] == 28 and rec[surface]["launches"] == {}
        assert "Population_AdjCensus_rwa_coarse/r2" in rec[surface]["r2"]
    for line in ("stitched surface", "spatial surface", "int8s surface", "transport_bf16 surface",
                 "the eval CLI's 28 metrics equal the harness's"):
        assert f"selftest OK: {line}" in r.stdout


@pytest.mark.parametrize("ours,expected,rtol", [
    ({"a/r2": 0.66, "b/r2": 0.5}, {"a/r2": 0.66}, 1e-3),
    ({"a/r2": 0.66}, {"a/r2": 0.7, "c/r2": 0.1}, 1e-3),
    ({"a/r2": 0.6995, "b/r2": 0.0}, {"a/r2": 0.7, "b/r2": 0.0}, 1e-3),
])
def test_diff_expected_matches_jax_harness(ours, expected, rtol, capsys):
    failed = harness.diff_expected(ours, expected, rtol)
    table = capsys.readouterr().out
    assert failed == j_harness.diff_expected(ours, expected, rtol)
    assert table == capsys.readouterr().out


def test_selftest_asks_for_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        harness.selftest("cuda")


def test_main_requires_checkpoints_or_selftest():
    with pytest.raises(SystemExit):
        harness.main(["--device", "cpu"])

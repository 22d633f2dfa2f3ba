"""The controls of ``correct``, on the card: a lower precision than the
configuration states has to come out not correct under the limits of
limits/*.json, while the program on the same seed comes out correct.

Eval: the program's own int8 member path (``--quantize int8s``: the
members' UNets in int8, the building extractor in bf16), and the plain
reference with fp8 operands, on a 2304 x 2304 region (4 patch positions,
16 visits a map).
Training: the plain reference with fp8 operands put in the program's
place, and the planted faults (half of each batch, an altered count, a
backward whose sign is wrong), on the first steps of a 2304 x 2304
region's epoch. The cells' own sizes were read the same way with
tools/calibrate.py (PERF.md). Run on the card:
``python -m pytest port_bench/tests -q -m card``; the last test reads the
same at the tiny cells on the CPU."""

import copy

import pytest
import torch

from port_bench.harness import spec
from port_bench.tools import calibrate

SEED = 2 ** 31 + 99


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _smaller(name):
    cell = spec.load_cell(name, bench=spec.with_held())
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["region"].update(height=2304, width=2304, n_regions=[3, 3])
    return cell


def _fails(reading, limits):
    return any(reading[k] > v for k, v in limits.items())


@pytest.mark.card
def test_eval_controls_fail():
    _card()
    import port_bench.run as R

    cell = _smaller("eval-bag5-sidecar")
    limits = spec.limits(cell.config_name)
    got = list(calibrate.eval_readings(R, spec, cell, [SEED], {SEED}))
    sides = {r["side"]: r for r in got}
    assert not _fails(sides["program"], limits)
    assert _fails(sides["control_int8s"], limits)
    assert _fails(sides["control_reference_fp8"], limits)


@pytest.mark.card
def test_train_controls_and_faults_fail():
    _card()
    import port_bench.run as R

    cell = _smaller("train-member-resident")
    limits = spec.limits(cell.config_name)
    got = list(calibrate.train_readings(R, spec, cell, [SEED], {SEED}))
    sides = {r["side"]: r for r in got}
    assert not _fails(sides["program"], limits)
    for side in ("control_fp8", "fault_half_batch", "fault_answer_altered", "fault_sign_flip"):
        assert _fails(sides[side], limits), side


@pytest.mark.parametrize("name", ["eval-bag5-sidecar", "train-member-resident"])
def test_controls_fail_on_the_cpu_too(name, tmp_path):
    """The same readings on the tests' tiny cells, on the CPU's plain paths."""
    import port_bench.run as R
    from port_bench.tests.tiny import tiny_cell

    cell = tiny_cell(name)
    limits = spec.limits(cell.config_name)
    kw = dict(device="cpu", cache=str(tmp_path))
    if cell.driver == "eval_map":
        got = calibrate.eval_readings(R, spec, cell, [SEED], {SEED}, **kw)
    else:
        got = calibrate.train_readings(R, spec, cell, [SEED], {SEED}, **kw)
    sides = {r["side"]: r for r in got}
    assert not _fails(sides.pop("program"), limits)
    assert sides and all(_fails(r, limits) for r in sides.values()), sides

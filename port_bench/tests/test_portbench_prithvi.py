"""The Prithvi member's cell on the CPU: its readers read nothing for other
drivers and without a trace, its counts equal hand-computed values at two
crop shapes, its bounds are the roofline's, its trace's second reduction
sorts attention and the update, its driver names every leaf of the
program's tree by the reference's keys, and the isolation walk sees its
reference."""

import json
import os

import pytest
import torch

from port_bench.harness import spec
from port_bench.harness.trace import reduce_trace
from port_bench.roofline import flops_prithvi as fp
from port_bench.roofline.flops import builder_flops_per_px, head_flops_per_px, peak_bytes, peak_flops
from port_bench.tests import test_portbench_isolation as iso

CELL = "train-prithvi300m-resident"
NEW = ("mfu.train_prithvi", "kernels_roofline.attention", "kernels_roofline.adam",
       "device.idle.train_prithvi", "train.idle_encoder_ms")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def cfg():
    return spec.load_cell(CELL).config


def test_the_cell_and_its_metrics_are_in_the_benchmark():
    b = spec.benchmark()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for n in NEW:
        assert per_layer[n]["workloads"] == [CELL]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["train_samples_per_s"]["workloads"]
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.driver == "train_epoch_prithvi"
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    assert set(spec.limits(cell.config_name)) == {"loss_rel", "popcount_rel", "grad1_leaf_gap",
                                                   "change_leaf_gap", "change_cos_gap",
                                                   "batch_misses"}
    with open(os.path.join(spec.BENCH_DIR, "limits", f"{cell.config_name}.json")) as f:
        readings = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
    for k, r in readings.items():
        assert r.get("exact") or r["lower"] < r["limit"] < r["upper"], k


def _record(cfg, driver="train_epoch_prithvi", trace=True):
    rec = {"driver": driver, "device_name": H100, "config": cfg, "window_s": 2.0,
           "units": [((2, 1024, 1024), [1.0, 2.0]), ((2, 2048, 2048), [3.0, 4.0])],
           "samples_hw": [[[700, 900], [1000, 333]], [[1900, 1800], [1500, 1700]]],
           "traced": [(2, 1024, 1024)], "traced_samples": [[[700, 900], [1000, 333]]],
           "traced_frozen": [False]}
    if trace:
        tr = {"window_s": 0.1, "busy_s": 0.075, "device_ops": [],
              "idle_gaps": [["step.forward", 0.004], ["prithvi.encoder", 0.002]],
              "device_s_by_function": {}, "launches_by_function": {}}
        rec["trace"] = tr
        rec["trace_prithvi"] = dict(tr, device_s_by_function={
            "attention_fwd": 0.01, "attention_bwd": 0.02, "adam": 0.005})
    return rec


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_elsewhere(cfg, name):
    read = spec.metric_reader(name)
    assert read(_record(cfg, driver="train_epoch")) is None
    assert read(_record(cfg, driver="eval_map")) is None
    if name != "mfu.train_prithvi":  # the window's host clock needs no trace
        assert read(_record(cfg, trace=False)) is None
    assert read(_record(cfg)) is not None


@pytest.mark.parametrize("h,w", [(700, 900), (1900, 1800)])
def test_counts_by_hand(cfg, h, w):
    n = -(-h // 16) * -(-w // 16) + 1
    d, depth, m = 1024, 24, 4096
    assert fp.tokens(cfg, h, w) == n
    attn = 4.0 * n * n * d * depth
    assert fp.attention_flops(cfg, n) == attn
    enc = 2.0 * (n - 1) * 6 * 256 * d + depth * (2 * n * d * 3 * d + 2 * n * d * d
                                                  + 2 * n * d * m * 2) + attn
    assert fp.encoder_flops(cfg, n) == pytest.approx(enc, rel=1e-12)
    neck = 2.0 * (n - 1) * d * 16 * 256
    px = h * w
    rest = 3 * head_flops_per_px() * px + builder_flops_per_px() * px
    assert fp.sample_flops(cfg, h, w, False, False) == pytest.approx(3 * enc + 3 * neck + rest)
    assert fp.sample_flops(cfg, h, w, True, True) == pytest.approx(enc + neck + rest)
    assert fp.sample_flops(cfg, h, w, True, False) == pytest.approx(enc + 3 * neck + rest)
    # the attention bound of a traced step that trains: 4 + 8 N^2 D a block
    rec = _record(cfg)
    rec["traced_samples"], rec["trace_prithvi"]["device_s_by_function"] = [[[h, w]]], {
        "attention_fwd": 1.0, "attention_bwd": 1.0}
    got = spec.metric_reader("kernels_roofline.attention")(rec)
    assert got == pytest.approx(100.0 * 3 * attn / peak_flops(H100, "bf16") / 2.0)


def test_parameter_count_and_update_bound(cfg):
    d, m = 1024, 4096
    block = 2 * 2 * d + 3 * d * d + 3 * d + d * d + d + 2 * d * m + m + d
    enc = 6 * 256 * d + d + d + 24 * block + 2 * d
    head = 16 * 64 + 64 + 2 * (64 * 64 + 64) + 64 * 2 + 2
    assert fp.param_count(cfg) == enc + d * 16 * 256 + 16 + head
    assert 303e6 < enc < 304e6
    rec = _record(cfg)
    got = spec.metric_reader("kernels_roofline.adam")(rec)
    want = 32.0 * fp.param_count(cfg) / peak_bytes(H100) / 0.005
    assert got == pytest.approx(100.0 * want)


def test_mfu_counts_the_window(cfg):
    rec = _record(cfg)
    tr = cfg["train"]
    flops = sum(fp.sample_flops(cfg, h, w, b * H * W > tr["limit1"], b * H * W > tr["limit2"])
                for ((b, H, W), _), hws in zip(rec["units"], rec["samples_hw"]) for h, w in hws)
    got = spec.metric_reader("mfu.train_prithvi")(rec)
    assert got == pytest.approx(100.0 * flops / 2.0 / peak_flops(H100, "bf16"))


def test_idle_readers(cfg):
    rec = _record(cfg)
    assert spec.metric_reader("device.idle.train_prithvi")(rec) == pytest.approx(25.0)
    assert spec.metric_reader("train.idle_encoder_ms")(rec) == pytest.approx(2.0)
    rec["trace"]["idle_gaps"] = [["outside the benchmark's spans", 0.01]]
    assert spec.metric_reader("train.idle_encoder_ms")(rec) is None


def test_second_reduction_sorts_attention_and_the_update(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.unit", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "ts": 1, "dur": 10,
           "name": "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>(Params)"},
          {"ph": "X", "cat": "kernel", "ts": 20, "dur": 20,
           "name": "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<T>(P)"},
          {"ph": "X", "cat": "kernel", "ts": 50, "dur": 3,
           "name": "popcorn::adam_norm_partial(popcorn::AdamLeaf const*, int, long long)"},
          {"ph": "X", "cat": "kernel", "ts": 60, "dur": 7,
           "name": "popcorn::adam_grid_step(popcorn::AdamLeaf const*, int)"},
          {"ph": "X", "cat": "kernel", "ts": 70, "dur": 5, "name": "sm90_xmma_gemm_bf16bf16"},
          {"ph": "X", "cat": "kernel", "ts": 76, "dur": 4, "name":
           "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_"
           "cga1x1x1_kernel0_0"},
          {"ph": "X", "cat": "kernel", "ts": 81, "dur": 6, "name":
           "cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_26_64x64x64_1x4x1_"
           "cga1x1x1_kernel0_0"},
          {"ph": "X", "cat": "kernel", "ts": 88, "dur": 2, "name":
           "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_64x64x64_4x1x1_"
           "cga1x1x1_kernel0_0"}]
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    with open(os.path.join(spec.BENCH_DIR, "roofline", "kernels_prithvi.json")) as f:
        table = json.load(f)
    driver = spec.driver_module("train_epoch_prithvi")
    kernels = driver._kernels(path)
    got = reduce_trace(path, driver.kernel_table(table, {n for n, _ in kernels}))
    assert got["device_s_by_function"] == pytest.approx(
        {"attention_fwd": 16e-6, "attention_bwd": 26e-6, "adam": 10e-6})
    assert got["launches_by_function"] == {"attention_fwd": 3, "attention_bwd": 2, "adam": 2}
    assert driver.device_shares(kernels) == pytest.approx(
        {"attention": 42 / 57, "gemm": 5 / 57, "update": 10 / 57}, abs=1e-4)


def test_driver_names_every_leaf_by_the_references_key():
    """Every leaf of a Prithvi member's tree maps to the reference's key
    and shape, one to one (a tiny tree of the program's layout)."""
    drv = spec.driver_module("train_epoch_prithvi")
    d, P = 8, 2
    tree = {("encoder", "patch_embed", "w"): (d, 6, P, P), ("encoder", "patch_embed", "b"): (d,),
            ("encoder", "cls_token"): (1, 1, d), ("encoder", "norm", "w"): (d,),
            ("encoder", "norm", "b"): (d,), ("neck", "w"): (d, 16, P, P), ("neck", "b"): (16,),
            ("head", "l1", "w"): (16, 64), ("head", "l4", "b"): (2,)}
    for leaf, shape in (("norm1", (d,)), ("qkv", (3 * d, d)), ("proj", (d, d)),
                        ("norm2", (d,)), ("fc1", (4 * d, d)), ("fc2", (d, 4 * d))):
        tree[("encoder", "blocks", "1", leaf, "w")] = shape
    want = {("encoder", "patch_embed", "w"): ("encoder.patch_embed.proj.weight", (d, 6, 1, P, P)),
            ("encoder", "cls_token"): ("encoder.cls_token", (1, 1, d)),
            ("encoder", "norm", "b"): ("encoder.norm.bias", (d,)),
            ("neck", "w"): ("neck.weight", (d, 16, P, P)),
            ("head", "l1", "w"): ("head.0.weight", (64, 16, 1, 1)),
            ("head", "l4", "b"): ("head.6.bias", (2,)),
            ("encoder", "blocks", "1", "qkv", "w"): ("encoder.blocks.1.attn.qkv.weight", (3 * d, d)),
            ("encoder", "blocks", "1", "fc2", "w"): ("encoder.blocks.1.mlp.fc2.weight", (d, 4 * d))}
    keys = {drv.reference_key(p) for p in tree}
    assert len(keys) == len(tree)
    for p, (key, shape) in want.items():
        assert drv.reference_key(p) == key
        assert tuple(drv.reference_layout(p, torch.zeros(tree[p])).shape) == shape


def test_the_isolation_walk_sees_the_prithvi_reference():
    files = {os.path.relpath(p, iso.BENCH) for p in iso._sources()}
    assert os.path.join("reference", "prithvi.py") in files
    assert not iso.top_level_imports(os.path.join(iso.BENCH, "reference", "prithvi.py")) & {
        "popcorn_tpu_torch", "jax", "popcorn_tpu"}

#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (popcorn_tpu_torch) on one NVIDIA GPU.

Phases, each printing one JSON line:
  1. device  — requires CUDA; the card's name and power limit, versions;
               TF32 off, so the plain versions are true float32;
  2. build   — compiles every kernel of csrc/ with nvcc (all at once);
  3. kernels — each kernel's wrapper at the main path's shapes (2048^2
               patch, real channel widths, the repo's DDA weights) held
               against its plain PyTorch version on the same inputs, with
               kernel, plain and library times and the least time the
               card could take (bound);
  4. model   — popcorn_forward on a small input, kernels against the CPU
               plain path;
  5. main    — the Bag-of-POPCORN eval through the eval CLI: a synthetic
               2304x2560 region, 5 members (DDA weights + seeded heads),
               patch 2048 / overlap 128, five GeoTIFFs and census metrics;
               every kernel's launch count must rise during it.
Then the {"kernels": [...]} summary, the nvidia-smi name/power line, and
last {"ok": true, "device": {...}}. Any failure raises: the script exits
non-zero and prints no result. Run from the repository root:

    python3 chip_smoke.py            # the whole run
    python3 chip_smoke.py --kernels  # phases 1-3 only (no result line)
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 on the CUDA
# cores and HBM3 bandwidth. The kernels run FP32 FMA on CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version: float32 in both with different summation
# orders (cuDNN/cuBLAS with TF32 off vs per-pixel FMA chains); observed
# errors are ~1e-6 relative, so 1e-4 leaves room and still catches any
# indexing or masking fault (those are O(1))
RTOL = ATOL = 1e-4
KERNEL_REPS = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = KERNEL_REPS) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(got, ref, name: str):
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(ref.abs().max()), 1e-30)
    ok = bool((err <= ATOL + RTOL * ref.abs()).all())
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {max_abs} beyond atol {ATOL} + rtol {RTOL}")
    return max_abs, max_rel


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true", help="stop after the kernel checks")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "popcorn_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, HERE)

    # ---------------------------------------------------------------- 1. device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    # ----------------------------------------------------------------- 2. build
    from popcorn_tpu_torch.nn import cuda_lib
    from popcorn_tpu_torch.nn import double_conv as A
    from popcorn_tpu_torch.nn import head as C
    from popcorn_tpu_torch.nn import up_block as B

    secs = cuda_lib.build(force=True)
    emit({"phase": "build", "sources": list(cuda_lib.KERNEL_SOURCES), "seconds": round(secs, 3)})

    # --------------------------------------------------------------- 3. kernels
    import torch.nn.functional as F

    from popcorn_tpu_torch.compat.weights import init_head, load_dda, to_torch

    unet, unet_bn = load_dda(device=dev)
    head = to_torch(init_head(0, biasinit=0.9407), dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, relu=False):
        x = torch.randn(*shape, device=dev, generator=g)
        return x.clamp_min(0) if relu else x

    def dc_library(p, bn, x):
        xc = x.permute(0, 3, 1, 2).contiguous()
        w1 = p["conv1"]["w"].permute(3, 2, 0, 1).contiguous()
        w2 = p["conv2"]["w"].permute(3, 2, 0, 1).contiguous()
        sc1, sh1 = bn["bn1"]["scale"][:, None, None], bn["bn1"]["shift"][:, None, None]
        sc2, sh2 = bn["bn2"]["scale"][:, None, None], bn["bn2"]["shift"][:, None, None]

        def run():
            y = torch.relu(F.conv2d(xc, w1, p["conv1"]["b"], padding=1) * sc1 + sh1)
            return torch.relu(F.conv2d(y, w2, p["conv2"]["b"], padding=1) * sc2 + sh2)

        return run

    def up_library(p, bn, x1, x2):
        x1c, x2c = x1.permute(0, 3, 1, 2).contiguous(), x2.permute(0, 3, 1, 2).contiguous()
        wt = p["tconv"]["w"].permute(0, 3, 1, 2).contiguous()  # (I,2,2,O) -> (I,O,2,2)
        dcp = p["conv"]
        w1 = dcp["conv1"]["w"].permute(3, 2, 0, 1).contiguous()
        w2 = dcp["conv2"]["w"].permute(3, 2, 0, 1).contiguous()
        sc1, sh1 = bn["bn1"]["scale"][:, None, None], bn["bn1"]["shift"][:, None, None]
        sc2, sh2 = bn["bn2"]["scale"][:, None, None], bn["bn2"]["shift"][:, None, None]

        def run():
            up = F.conv_transpose2d(x1c, wt, p["tconv"]["b"], stride=2)
            dy, dx = x2c.shape[2] - up.shape[2], x2c.shape[3] - up.shape[3]
            if dy or dx:
                up = F.pad(up, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
            y = torch.cat([x2c, up], 1)
            y = torch.relu(F.conv2d(y, w1, dcp["conv1"]["b"], padding=1) * sc1 + sh1)
            return torch.relu(F.conv2d(y, w2, dcp["conv2"]["b"], padding=1) * sc2 + sh2)

        return run

    def head_library(x, n_out):
        x2 = x.reshape(-1, 16)
        w = [head[k]["w"] for k in C.HEAD_LAYERS]
        b = [head[k]["b"] for k in C.HEAD_LAYERS]
        w4, b4 = w[3][:, :n_out].contiguous(), b[3][:n_out].contiguous()

        def run():
            h = torch.relu(torch.addmm(b[0], x2, w[0]))
            h = torch.relu(torch.addmm(b[1], h, w[1]))
            h = torch.relu(torch.addmm(b[2], h, w[2]))
            return torch.addmm(b4, h, w4)

        return run

    cases = []  # one per checked call: kernel, name, member-forward multiplicity

    def check_case(kernel, name, mult, kern_fn, plain_fn, lib_fn, flops, nbytes):
        got = kern_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        torch.cuda.synchronize()
        max_abs, max_rel = compare(got, ref, name)
        del got, ref
        k_ms = time_ms(kern_fn)
        p_ms = time_ms(plain_fn)
        l_ms = time_ms(lib_fn)
        b_ms, by = bound(flops, nbytes)
        case = {
            "phase": "kernel", "kernel": kernel, "case": name, "per_member_calls": mult,
            "max_abs_err": max_abs, "max_rel_err": max_rel, "rtol": RTOL, "atol": ATOL,
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        emit(case)
        cases.append(case)

    P = 2048
    # kernel A: every DoubleConv of one member stream at a 2048^2 patch, and
    # the builder's odd 519^2 down2 (2076 = 2048 + 2*14 after two pools)
    dc_cases = [
        ("inc_sar", unet["sar"]["inc"], unet_bn["sar"]["inc"], (1, P, P, 2), False, 1),
        ("inc_opt", unet["opt"]["inc"], unet_bn["opt"]["inc"], (1, P, P, 4), False, 1),
        ("down1", unet["sar"]["down1"], unet_bn["sar"]["down1"], (1, P // 2, P // 2, 8), True, 2),
        ("down2", unet["sar"]["down2"], unet_bn["sar"]["down2"], (1, P // 4, P // 4, 16), True, 2),
        ("down2_builder_odd", unet["opt"]["down2"], unet_bn["opt"]["down2"], (1, 519, 519, 16), True, 0),
    ]
    for name, p, bn, shape, relu, mult in dc_cases:
        x = rand(*shape, relu=relu)
        cin, cm, cout = shape[-1], p["conv1"]["w"].shape[3], p["conv2"]["w"].shape[3]
        npx = shape[0] * shape[1] * shape[2]
        flops = 2.0 * npx * 9 * (cin * cm + cm * cout)
        nbytes = 4.0 * (npx * (cin + cout) + 9 * (cin * cm + cm * cout) + 2 * (cm + cout))
        check_case(
            "double_conv", f"{name} {'x'.join(map(str, shape))}->{cout}", mult,
            lambda p=p, bn=bn, x=x: A.double_conv_cuda(p, bn, x),
            lambda p=p, bn=bn, x=x: A.double_conv_plain(p, bn, x),
            dc_library(p, bn, x), flops, nbytes,
        )
        del x

    # kernel B: up2 (coarse 512^2 x16 + skip 1024^2 x16) and up1
    up_cases = [
        ("up2", unet["sar"]["up2"], unet_bn["sar"]["up2"], (1, P // 4, P // 4, 16), (1, P // 2, P // 2, 16)),
        ("up1", unet["sar"]["up1"], unet_bn["sar"]["up1"], (1, P // 2, P // 2, 8), (1, P, P, 8)),
    ]
    for name, p, bn, s1, s2 in up_cases:
        x1, x2 = rand(*s1, relu=True), rand(*s2, relu=True)
        c1, cs = s1[-1], s2[-1]
        cu = p["tconv"]["w"].shape[3]
        cm, cout = p["conv"]["conv1"]["w"].shape[3], p["conv"]["conv2"]["w"].shape[3]
        npx = s2[0] * s2[1] * s2[2]
        flops = 2.0 * npx * (c1 * cu + 9 * ((cs + cu) * cm + cm * cout))
        nw = c1 * 4 * cu + cu + 9 * ((cs + cu) * cm + cm * cout) + 2 * (cm + cout)
        nbytes = 4.0 * (x1.numel() + x2.numel() + npx * cout + nw)
        check_case(
            "up_block", f"{name} {'x'.join(map(str, s1))}+{'x'.join(map(str, s2))}->{cout}", 2,
            lambda p=p, bn=bn, x1=x1, x2=x2: B.up_block_cuda(p, bn, x1, x2),
            lambda p=p, bn=bn, x1=x1, x2=x2: B.up_block_plain(p, bn, x1, x2),
            up_library(p, bn, x1, x2), flops, nbytes,
        )
        del x1, x2

    # kernel C: channel 0 (the member fold) and 2 channels, 2048^2 features
    feats = rand(1, P, P, 16, relu=True)
    npx = P * P
    for n_out, mult in ((1, 1), (2, 0)):
        flops = 2.0 * npx * (16 * 64 + 64 * 64 * 2 + 64 * n_out)
        nbytes = 4.0 * (npx * (16 + n_out) + 16 * 64 + 2 * 64 * 64 + 64 * 2 + 3 * 64 + 2)
        check_case(
            "head", f"head_{n_out}ch 1x{P}x{P}x16->{n_out}", mult,
            lambda n_out=n_out: C.head_cuda(head, feats, n_out),
            lambda n_out=n_out: C.head_plain(head, feats, n_out),
            head_library(feats, n_out), flops, nbytes,
        )
    del feats
    torch.cuda.empty_cache()
    if args.kernels:
        return

    # ----------------------------------------------------------------- 4. model
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda
    from popcorn_tpu_torch.config import ModelConfig
    from popcorn_tpu_torch.nn.popcorn import popcorn_forward

    mcfg = ModelConfig(biasinit=0.9407)
    params, consts = load_popcorn_from_dda(mcfg, head_seed=1)
    xs = torch.randn(1, 192, 160, 6, generator=torch.Generator().manual_seed(1))
    ref = popcorn_forward(params, consts, {"input": xs}, mcfg, padding=False)
    got = popcorn_forward(
        to_torch(params, dev), to_torch(consts, dev), {"input": xs.to(dev)}, mcfg, padding=False
    )
    m_abs, m_rel = compare(got["popdensemap"].cpu(), ref["popdensemap"], "model popdensemap")
    pc_rel = abs(float(got["popcount"][0]) - float(ref["popcount"][0])) / abs(float(ref["popcount"][0]))
    if not pc_rel <= 2e-4:
        raise AssertionError(f"model popcount relative error {pc_rel}")
    emit({"phase": "model", "input": [1, 192, 160, 6], "max_abs_err": m_abs,
          "max_rel_err": m_rel, "popcount_rel_err": pc_rel})

    # ------------------------------------------------------------------ 5. main
    import numpy as np

    from popcorn_tpu_torch.cli import eval as eval_cli
    from popcorn_tpu_torch.compat.weights import save_popcorn_checkpoint
    from popcorn_tpu_torch.data.synthetic import make_synthetic_region
    from popcorn_tpu_torch.io.geotiff import GeoTIFF

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        make_synthetic_region(os.path.join(tmp, "data"), "rwa", height=2304, width=2560,
                              n_regions=(4, 6), seed=42)
        members = []
        for i in range(5):
            params, consts = load_popcorn_from_dda(mcfg, head_seed=100 + i)
            members.append(os.path.join(tmp, f"m{i + 1}.pth"))
            save_popcorn_checkpoint(members[-1], params, consts)
        setup_s = time.perf_counter() - t0

        A.launches = B.launches = C.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = eval_cli.main([
            "--data_root", os.path.join(tmp, "data"), "-occmodel", "-senbuilds",
            "-S2", "-NIR", "-S1", "-treg", "rwa", "-tlevel", "coarse",
            "--num_workers", "4", "-r", *members,
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"double_conv": A.launches, "up_block": B.launches, "head": C.launches}
        peak = torch.cuda.max_memory_allocated(dev)

        if not all(v > 0 for v in launches.values()):
            raise AssertionError(f"a kernel was not launched on the main path: {launches}")
        bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite metrics: {bad}")
        r2 = stats["Population_AdjCensus_rwa_coarse/r2"]
        if not r2 > 0.9:
            raise AssertionError(f"AdjCensus coarse r2 {r2} <= 0.9")
        folders = glob.glob(os.path.join(tmp, "eval_outputs_ensemble_*"))
        if len(folders) != 1:
            raise AssertionError(f"expected one output folder, found {folders}")
        for tag in ("", "STD", "SCALE_rwa", "SCALE_STD", "ADJ_rwa"):
            path = os.path.join(folders[0], f"rwa_predictions{tag}.tif")
            with GeoTIFF(path) as gt:
                a = gt.read(1, squeeze=True)
            if a.shape != (2304, 2560) or not bool(np.isfinite(a).all()):
                raise AssertionError(f"{path}: shape {a.shape} or non-finite values")
            if tag == "" and not float(a.max()) > 0:
                raise AssertionError("the population map is all zero")
        n_patches = 4  # patch grid of a 2304x2560 region at 2048/128
        emit({
            "phase": "main", "members": 5, "patch": 2048, "overlap": 128,
            "region": [2304, 2560], "patches": n_patches, "setup_s": setup_s,
            "wall_s": wall, "patches_per_s": n_patches / wall,
            "peak_mem_bytes": peak, "launches": launches,
            "adj_coarse_r2": r2, "main_coarse_r2": stats["Population_MainCensus_rwa_coarse/r2"],
        })

    # ---------------------------------------------------------------- summary
    meta = {
        "double_conv": ("popcorn_tpu_torch/csrc/double_conv.cu", "popcorn_tpu/nn/pallas_conv.py:101"),
        "up_block": ("popcorn_tpu_torch/csrc/up_block.cu", "popcorn_tpu/nn/pallas_conv.py:472"),
        "head": ("popcorn_tpu_torch/csrc/head.cu", "popcorn_tpu/nn/pallas_packed_head.py:83"),
    }
    kernels = []
    for kname, (src, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == kname]
        on_path = [c for c in mine if c["per_member_calls"] > 0]
        tot = lambda key: sum(c[key] * c["per_member_calls"] for c in on_path)  # noqa: E731
        b_ops = sum(c["gflop"] * 1e9 * c["per_member_calls"] for c in on_path) / PEAK_FP32_FLOPS
        b_bytes = sum(c["mbytes"] * 1e6 * c["per_member_calls"] for c in on_path) / PEAK_HBM_BYTES
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": tot("library_ms"),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

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
               the launch counts of kernels A, B, C must rise during it;
  6. train_step — one training step (the repo's DDA weights, a seeded
               head, 2x192x160, a fixed sparsity mask) on the card against
               the CPU plain path in each memory tier (full gradient,
               encoder_no_grad, unet_no_grad): loss, every gradient leaf,
               frozen leaves exactly zero, the update, and launches of
               kernels A-D on the card;
  7. train   — the train CLI on the same region with the verify skill's
               flags (1 epoch, 6 weak samples): finite losses, moved head,
               launches of A, B, C and D, last_model.pth, which the eval
               CLI then turns into finite maps with AdjCensus r2 > 0.9.
               Then steady step times: the epoch's batches again through
               the trainer's step, each shape warmed once, and one
               full-width step at 2x2048^2, with its memory; a
               torch.profiler trace of each (train_profile lines) splits
               the step by kernel and gives the device's idle share.
Kernel D (the head backward) is checked in phase 3 at the train phase's
bucket shape (2x1024x1024) and at 2x2048^2. Then the {"kernels": [...]}
summary, the nvidia-smi name/power line, and last {"ok": true, "device":
{...}}. Any failure raises: the script exits non-zero and prints no
result. Run from the repository root:

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
# kernel D's weight gradients are sums over up to 8.4M pixels, formed in
# another order than cuBLAS's: held norm-relative, ||got-ref||/||ref||
NORM_RTOL = 1e-5
# Kernel D and the ReLU boundary. The backward's ReLU masks are
# discontinuous: where a hidden pre-activation lies within float32
# rounding of 0, the kernel and the plain version (cuBLAS) may take
# different masks, and dx and the weight gradients differ by a whole term
# there (seen at 2M px with random cotangents: dx max abs error 8.5e-3,
# norm-relative 3.7e-4; weight gradients 5.4e-4, their sums over zero-mean
# terms cancel). So kernel D is held twice: with the cotangent zeroed on
# the pixels whose pre-activations come within BOUNDARY of 0, dx elementwise
# at RTOL/ATOL and dx and the weight gradients norm-relative at NORM_RTOL;
# and on all pixels, norm-relative at RAW_NORM_RTOL.
BOUNDARY = 1e-4
RAW_NORM_RTOL = 3e-3
# the train step on the card against the CPU plain path, in each memory
# tier: float32 through cuDNN (TF32 off) vs the CPU's convs, two UNets and
# their backward; loss and popcount at rtol 1e-4, each gradient leaf
# norm-relative 1e-4, frozen leaves exactly zero. The update Adam makes of
# it is lr * g / (|g| + eps), which turns a float32 difference of a
# gradient near zero into up to the whole step: updates are held
# norm-relative 1e-2 (2.7e-3 seen on an H100, gradients 6.2e-5): a leaf
# whose gradient has the wrong sign moves by twice its step and fails it.
STEP_RTOL, STEP_UPDATE_RTOL = 1e-4, 1e-2
KERNEL_REPS = 10
# the train phase's larger batch: its 6 weak samples of the seeded
# 2304x2560 region's 4x6 admin grid come in the buckets 2x1024x1024 and
# 2x512x256 (the train phase checks that this one is among them)
TRAIN_BUCKET = (2, 1024, 1024)
# steady train-step timing: each bucket shape is run once untimed (cuDNN
# plan selection, allocator growth), then STEP_REPS times
STEP_REPS = 5


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


def profile_steps(case: str, run, step_ms: float, reps: int = 3) -> dict:
    """One torch.profiler trace over ``reps`` calls of the warmed ``run``:
    the device's busy time a call (the sum of its kernels and copies, which
    run on one stream), its idle share of the steady ``step_ms``, kernel
    launches a call, and the kernels and host ops that take the most time.
    A trace with no device events gives nulls, not a failure: it measures,
    it checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return e.self_device_time_total if hasattr(e, "self_device_time_total") else e.self_cuda_time_total

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t) * 1e3 / reps
    events = prof.key_averages()
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=dev_us, reverse=True)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    busy = sum(dev_us(e) for e in kern) / 1e3 / reps if kern else None
    return {
        "phase": "train_profile", "case": case, "reps": reps, "step_ms": step_ms,
        "traced_ms": traced_ms, "device_busy_ms": busy,
        "idle_share": None if busy is None else 1.0 - busy / step_ms,
        "kernel_launches": sum(e.count for e in kern) / reps,
        "top_kernels": [{"name": e.key[:100], "ms": dev_us(e) / 1e3 / reps, "calls": e.count / reps}
                        for e in kern[:15]],
        "top_host_ops": [{"name": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3 / reps,
                          "calls": e.count / reps} for e in host[:15]],
    }


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

    # kernel D: the head backward at the train phase's bucket and at a
    # 2x2048^2 step (8.4M px, under limit1's 9M: the full-gradient tier)
    def relu_boundary(x):
        """Pixels with a hidden pre-activation within BOUNDARY of 0: there
        the ReLU mask of the backward may differ between two float32
        evaluations of the same forward."""
        h = x.reshape(-1, 16)
        near = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
        for k in C.HEAD_LAYERS[:-1]:
            z = torch.addmm(head[k]["b"], h, head[k]["w"])
            near |= (z.abs() < BOUNDARY).any(1)
            h = torch.relu(z)
        return near

    def head_bwd_library(x, g):
        xl = x.reshape(-1, 16).detach().requires_grad_(True)
        w = [head[k]["w"].detach().requires_grad_(True) for k in C.HEAD_LAYERS]
        b = [head[k]["b"].detach().requires_grad_(True) for k in C.HEAD_LAYERS]
        h = torch.relu(torch.addmm(b[0], xl, w[0]))
        h = torch.relu(torch.addmm(b[1], h, w[1]))
        h = torch.relu(torch.addmm(b[2], h, w[2]))
        out = torch.addmm(b[3], h, w[3])
        g2 = g.reshape(-1, 2)

        def run():
            return torch.autograd.grad(out, [xl, *w, *b], g2, retain_graph=True)

        return run

    # multiply-adds a pixel: the h1..h3 recompute, then g3..g1 and dx, and
    # the same count again for dW4..dW1 (55,808 FLOPs)
    flops_px = 2.0 * ((16 * 64 + 2 * 64 * 64) + 2 * (64 * 2 + 2 * 64 * 64 + 64 * 16))
    wbytes = 4.0 * (16 * 64 + 2 * 64 * 64 + 64 * 2 + 3 * 64 + 2)
    for lead, mult in ((TRAIN_BUCKET, 1), ((2, P, P), 0)):
        x = rand(*lead, 16)
        gout = rand(*lead, 2)
        npx = math.prod(lead)
        name = f"head_bwd {'x'.join(map(str, lead))}x16"
        near = relu_boundary(x)
        boundary_share = float(near.float().mean())

        def errors(g):
            dx, grads = C.head_bwd_cuda(head, x, g)
            torch.cuda.synchronize()
            dx_ref, grads_ref = C.head_bwd_plain(head, x, g)
            torch.cuda.synchronize()
            err = (dx - dx_ref).abs()
            ok = bool((err <= ATOL + RTOL * dx_ref.abs()).all()) and bool(torch.isfinite(dx).all())
            return ok, float(err.max()), float(err.max() / dx_ref.abs().max()), max(
                float((a - r).norm() / r.norm().clamp_min(1e-30)) for a, r in zip(grads, grads_ref)
            ), float((dx - dx_ref).norm() / dx_ref.norm())

        # off the ReLU boundary (the cotangent zeroed on its pixels): tight
        ok, max_abs, max_rel, norm_rel, dx_rel = errors(gout * (~near).view(*lead, 1))
        # all pixels: only mask flips differ, held to the looser bound
        _, raw_abs, _, raw_norm_rel, raw_dx_rel = errors(gout)
        stats_d = {"max_abs_err": max_abs, "max_rel_err": max_rel, "grad_norm_rel_err": norm_rel,
                   "dx_norm_rel_err": dx_rel, "relu_boundary_share": boundary_share,
                   "raw_max_abs_err": raw_abs, "raw_grad_norm_rel_err": raw_norm_rel,
                   "raw_dx_norm_rel_err": raw_dx_rel}
        if not (ok and norm_rel <= NORM_RTOL and dx_rel <= NORM_RTOL
                and max(raw_norm_rel, raw_dx_rel) <= RAW_NORM_RTOL):
            emit({"phase": "kernel", "kernel": "head_bwd", "case": name, "failed": stats_d})
            raise AssertionError(f"{name}: kernel D disagrees with its plain version: {stats_d}")
        del near
        k_ms = time_ms(lambda x=x, gout=gout: C.head_bwd_cuda(head, x, gout))
        p_ms = time_ms(lambda x=x, gout=gout: C.head_bwd_plain(head, x, gout))
        l_ms = time_ms(head_bwd_library(x, gout))
        b_ms, by = bound(flops_px * npx, 4.0 * npx * (16 + 2 + 16) + wbytes * 2)
        case = {
            "phase": "kernel", "kernel": "head_bwd", "case": name, "per_member_calls": mult,
            **stats_d, "rtol": RTOL, "atol": ATOL, "norm_rtol": NORM_RTOL,
            "raw_norm_rtol": RAW_NORM_RTOL,
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
            "bound_by": by, "gflop": flops_px * npx / 1e9,
            "mbytes": (4.0 * npx * (16 + 2 + 16) + wbytes * 2) / 1e6,
        }
        emit(case)
        cases.append(case)
        del x, gout
        torch.cuda.empty_cache()
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

    eval_flags = ["-occmodel", "-senbuilds", "-S2", "-NIR", "-S1", "-treg", "rwa",
                  "-tlevel", "coarse", "--num_workers", "4"]

    def check_eval(stats, folder_glob):
        bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite metrics: {bad}")
        r2 = stats["Population_AdjCensus_rwa_coarse/r2"]
        if not r2 > 0.9:
            raise AssertionError(f"AdjCensus coarse r2 {r2} <= 0.9")
        folders = glob.glob(folder_glob)
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
        return r2

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        make_synthetic_region(data, "rwa", height=2304, width=2560, n_regions=(4, 6), seed=42)
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
        stats = eval_cli.main(["--data_root", data, *eval_flags, "-r", *members])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"double_conv": A.launches, "up_block": B.launches, "head": C.launches}
        peak = torch.cuda.max_memory_allocated(dev)
        if not all(v > 0 for v in launches.values()):
            raise AssertionError(f"a kernel was not launched on the main path: {launches}")
        r2 = check_eval(stats, os.path.join(tmp, "eval_outputs_ensemble_*"))
        n_patches = 4  # patch grid of a 2304x2560 region at 2048/128
        emit({
            "phase": "main", "members": 5, "patch": 2048, "overlap": 128,
            "region": [2304, 2560], "patches": n_patches, "setup_s": setup_s,
            "wall_s": wall, "patches_per_s": n_patches / wall,
            "peak_mem_bytes": peak, "launches": launches,
            "adj_coarse_r2": r2, "main_coarse_r2": stats["Population_MainCensus_rwa_coarse/r2"],
        })

        # ---------------------------------------------------------- 6. train_step
        from popcorn_tpu_torch.cli import train as train_cli
        from popcorn_tpu_torch.config import TrainConfig
        from popcorn_tpu_torch.data.normalize import NormStats
        from popcorn_tpu_torch.train import state as train_state

        tcfg = TrainConfig()
        params, consts = load_popcorn_from_dda(mcfg, head_seed=7)
        rng = np.random.default_rng(7)

        def train_batch(b, h, w):
            idx = np.arange(1, b + 1, dtype=np.float32)
            return {
                "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
                "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
                "admin_mask": np.where(rng.random((b, h, w)) < 0.7, idx[:, None, None],
                                       -1.0).astype(np.float32),
                "census_idx": idx,
                "y": rng.uniform(10, 1000, (b,)).astype(np.float32),
                "photometric": np.asarray([1.0, 0.9, 1.0, 1.1], np.float32),
            }

        small = train_batch(2, 192, 160)
        mask = torch.from_numpy(rng.random((2, 192, 160)) < 0.5)
        # the memory tiers: which UNet leaves each one freezes (the streams'
        # unused output convs never take a gradient in this configuration)
        tiers = {
            "full": dict(encoder_no_grad=False, unet_no_grad=False),
            "encoder_no_grad": dict(encoder_no_grad=True, unet_no_grad=False),
            "unet_no_grad": dict(encoder_no_grad=True, unet_no_grad=True),
        }

        def frozen(path, flags):
            return path[0] == "unet" and (
                flags["unet_no_grad"] or path[1] in ("sar_out", "opt_out", "fusion_out")
                or (flags["encoder_no_grad"] and len(path) > 2
                    and path[2] in ("inc", "down1", "down2")))

        steps = {}
        for where in (torch.device("cpu"), dev):
            p, cst = to_torch(params, where), to_torch(consts, where)
            steps[where.type] = (p, train_state.make_train_step(
                mcfg, tcfg, cst, NormStats(device=where), train_state.make_optimizer(tcfg)))
        old_c = dict(train_state.tree_flatten(steps["cpu"][0]))
        for tier, flags in tiers.items():
            res = {}
            for where in (torch.device("cpu"), dev):
                p, step = steps[where.type]
                tb = {k: torch.from_numpy(v).to(where) for k, v in small.items()}
                before = (A.launches, B.launches, C.launches, C.bwd_launches)
                grads, aux = step.grads(p, tb, mask=mask.to(where), **flags)
                new_p, _ = step.optimizer.update(grads, step.optimizer.init(p), p)
                after = (A.launches, B.launches, C.launches, C.bwd_launches)
                res[where.type] = (grads, aux, new_p, [a - b for a, b in zip(after, before)])
            (g_c, aux_c, n_c, _), (g_g, aux_g, n_g, tier_launches) = res["cpu"], res["cuda"]
            loss_rel = abs(float(aux_g["optimization_loss"]) - float(aux_c["optimization_loss"])) / abs(
                float(aux_c["optimization_loss"]))
            pc_rel = float(((aux_g["popcount"].cpu() - aux_c["popcount"]).abs()
                            / aux_c["popcount"].abs()).max())
            g_gpu = dict(train_state.tree_flatten(g_g))
            grad_rel, upd_rel, n_frozen = 0.0, 0.0, 0
            for path, ref in train_state.tree_flatten(g_c):
                got = g_gpu[path].cpu()
                name = train_state.keystr(path)
                if frozen(path, flags):
                    # a frozen leaf: an exact zero in both, not a small value
                    if bool(ref.any()) or bool(got.any()):
                        raise AssertionError(f"train step {tier}: {name} is frozen but has a gradient")
                    n_frozen += 1
                    continue
                if not float(ref.norm()) > 0:
                    raise AssertionError(f"train step {tier}: trainable {name} has no gradient")
                grad_rel = max(grad_rel, float((got - ref).norm() / ref.norm()))
            new_g = dict(train_state.tree_flatten(n_g))
            for path, new_ref in train_state.tree_flatten(n_c):
                du_ref = new_ref - old_c[path]
                du = new_g[path].cpu() - old_c[path]
                if float(du_ref.norm()) > 0:
                    upd_rel = max(upd_rel, float((du - du_ref).norm() / du_ref.norm()))
            # on the card every tier runs the head through kernels C and D,
            # and the builder (and the frozen blocks) through kernels A and B
            launched = dict(zip(("double_conv", "up_block", "head", "head_bwd"), tier_launches))
            step_ok = (loss_rel <= STEP_RTOL and pc_rel <= STEP_RTOL
                       and grad_rel <= STEP_RTOL and upd_rel <= STEP_UPDATE_RTOL
                       and all(v > 0 for v in launched.values()))
            emit({"phase": "train_step", "tier": tier, "ok": step_ok, "input": [2, 192, 160, 6],
                  "loss_cpu": float(aux_c["optimization_loss"]),
                  "loss_gpu": float(aux_g["optimization_loss"]), "loss_rel_err": loss_rel,
                  "popcount_rel_err": pc_rel, "grad_norm_rel_err_max": grad_rel,
                  "frozen_leaves": n_frozen, "update_norm_rel_err_max": upd_rel,
                  "card_launches": launched, "rtol": STEP_RTOL, "update_rtol": STEP_UPDATE_RTOL})
            if not step_ok:
                raise AssertionError(f"the {tier} train step on the card disagrees with the CPU plain path")
            del res, g_c, n_c, g_g, n_g
        del steps

        # --------------------------------------------------------------- 7. train
        A.launches = B.launches = C.launches = C.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = train_cli.main([
            "--data_root", data, "-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa",
            "-occmodel", "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse",
            "-e", "1", "-mws", "6", "-lt", "1", "-w", "4",
            "--save_dir", os.path.join(tmp, "outputs"),
        ])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = {"double_conv": A.launches, "up_block": B.launches,
                          "head": C.launches, "head_bwd": C.bwd_launches}
        train_peak = torch.cuda.max_memory_allocated(dev)
        if not all(v > 0 for v in train_launches.values()):
            raise AssertionError(f"a kernel was not launched in training: {train_launches}")
        with open(os.path.join(trainer.experiment_folder, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["optimization_loss/train"] for r in recs if "optimization_loss/train" in r]
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train losses {losses}")
        head0 = load_popcorn_from_dda(mcfg, head_seed=TrainConfig().seed)[0]["head"]
        moved = max(float((trainer.params["head"][k]["w"].cpu() - head0[k]["w"]).abs().max())
                    for k in C.HEAD_LAYERS)
        if not moved > 0:
            raise AssertionError("the head did not move in training")
        ck = os.path.join(trainer.experiment_folder, "last_model.pth")
        if not os.path.exists(ck):
            raise AssertionError(f"{ck} was not written")

        # steady step times on the epoch's own batches: the feed is seeded,
        # so epoch 0 yields them again; a plain loop over the trainer's
        # step, each bucket shape run once untimed, then STEP_REPS times
        from popcorn_tpu_torch.infer.sliding import _upload
        from popcorn_tpu_torch.train.trainer import TRAIN_KEYS

        epoch = [(b, trainer._tier_flags(b)) for b in trainer.feed.epoch(0)]
        epoch = [(b, f) for b, f in epoch if f is not None]
        shapes = [tuple(b["S2"].shape[:3]) for b, _ in epoch]
        if len(shapes) != len(losses):
            raise AssertionError(f"the replayed epoch has {len(shapes)} batches, "
                                 f"the run logged {len(losses)} steps")
        if math.prod(TRAIN_BUCKET) not in [math.prod(s) for s in shapes]:
            raise AssertionError(f"train batches {shapes}: none has TRAIN_BUCKET's pixels")

        def time_step(run):
            run()  # untimed first call at this shape
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ms = []
            for _ in range(STEP_REPS):
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return {"step_ms": ms, "median_ms": float(np.median(ms)),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}

        def trainer_step(dev_batch, flags):
            def run():
                _, _, aux = trainer.step_fn(trainer.params, trainer.opt_state, dev_batch,
                                            trainer.generator, **flags)
                float(aux["optimization_loss"])  # the trainer reads the loss every step
            return run

        buckets, profiles = {}, []
        for b, flags in epoch:
            shape = tuple(b["S2"].shape[:3])
            if shape in buckets:
                continue
            run = trainer_step(_upload(b, dev, TRAIN_KEYS), flags)
            buckets[shape] = {"shape": list(shape), **flags, **time_step(run)}
            profiles.append(profile_steps(f"train bucket {list(shape)}", run,
                                          buckets[shape]["median_ms"]))
        epoch_ms = sum(buckets[s]["median_ms"] for s in shapes)
        n_samples = sum(s[0] for s in shapes)
        del trainer, epoch
        torch.cuda.empty_cache()
        tstats = eval_cli.main(["--data_root", data, *eval_flags, "-r", ck, ck])
        t_r2 = check_eval(tstats, os.path.join(os.path.dirname(ck), "eval_outputs_ensemble_*"))

        # one full-width step at 2x2048^2 (8.4M px: the full-gradient tier)
        params, consts = load_popcorn_from_dda(mcfg, head_seed=7)
        step = train_state.make_train_step(mcfg, tcfg, to_torch(consts, dev), NormStats(device=dev),
                                           train_state.make_optimizer(tcfg))
        p = to_torch(params, dev)
        opt_state = step.optimizer.init(p)
        big = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(2, P, P).items()}
        gen = torch.Generator().manual_seed(0)

        def big_step():
            _, _, aux = step(p, opt_state, big, gen)
            float(aux["optimization_loss"])

        big_t = time_step(big_step)
        profiles.append(profile_steps(f"full-width step {[2, P, P]}", big_step, big_t["median_ms"]))
        emit({
            "phase": "train", "steps": len(shapes), "batch_shapes": [list(s) for s in shapes],
            "buckets": list(buckets.values()), "step_reps": STEP_REPS,
            "median_step_ms": float(np.median([buckets[s]["median_ms"] for s in shapes])),
            "epoch_step_ms": epoch_ms, "samples_per_s": n_samples / (epoch_ms / 1e3),
            "cli_wall_s": train_wall, "cli_peak_mem_bytes": train_peak, "losses": losses,
            "head_max_move": moved, "launches": train_launches,
            "ckpt_eval_adj_coarse_r2": t_r2,
            "full_width_step": {"input": [2, P, P, 6], **big_t},
        })
        for prof in profiles:
            emit(prof)
        del big, p, opt_state, step
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- summary
    launches = {**launches, "head_bwd": train_launches["head_bwd"]}
    meta = {
        "double_conv": ("popcorn_tpu_torch/csrc/double_conv.cu", "popcorn_tpu/nn/pallas_conv.py:101"),
        "up_block": ("popcorn_tpu_torch/csrc/up_block.cu", "popcorn_tpu/nn/pallas_conv.py:472"),
        "head": ("popcorn_tpu_torch/csrc/head.cu", "popcorn_tpu/nn/pallas_packed_head.py:83"),
        "head_bwd": ("popcorn_tpu_torch/csrc/head_bwd.cu", "popcorn_tpu/nn/pallas_head.py:56"),
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

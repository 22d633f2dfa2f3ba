#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (popcorn_tpu_torch) on one NVIDIA GPU.

Phases, each printing one JSON line:
  1. device  — requires CUDA; the card's name and power limit, versions;
               TF32 off, so the plain versions are true float32;
  2. build   — compiles every kernel of csrc/ with nvcc (all at once),
               then one build_report line a source: registers, spills
               and shared memory of each kernel (ptxas -v), and for A-D
               the tensor-core MMAs (HMMA) in their SASS, which must be
               there in every instantiation;
  3. kernels — each kernel's wrapper at the main path's shapes (2048^2
               patch, real channel widths, the repo's DDA weights) held
               against its plain PyTorch version on the same inputs, with
               kernel (the wrapper's call, host work included), device
               (the kernel alone, from a profiler trace), plain and
               library times and the least time the
               card could take (bound; for A-D at float32 accuracy on the
               tensor cores, with the CUDA-core figure beside it as
               bound_fp32_ms); kernels A, B and C again in their bf16
               modes (the CLIs' default compute dtype), held to their
               plain versions at BF16_ULP and bounded at the bf16 tensor
               rate with 2-byte I/O. The int8 kernels E-H take their
               inputs from one member's streams on a seeded 2048^2 input
               (static scales calibrated on it for E and F), plus the
               builder's odd 519^2 blocks (G, H) and a w4a8 case (E); their
               int8 outputs must equal their plain versions' bit for bit;
  4. model   — popcorn_forward on a small input, kernels against the CPU
               plain path, in float32 and in bf16;
  5. main    — the Bag-of-POPCORN eval through the eval CLI: a synthetic
               2304x2560 region, 5 members (DDA weights + seeded heads),
               patch 2048 / overlap 128, five GeoTIFFs and census metrics,
               at the CLI's default compute dtype (bf16) with the launch
               counts of kernels A, B, C in their bf16 modes exactly
               MAIN_LAUNCHES per patch, then once with --compute_dtype
               float32 (the float32 modes, the same counts): the two maps
               correlated >= DTYPE_MAP_CORR, AdjCensus r2 within
               DTYPE_R2_TOL; each with the sliding window's wall split
               (feed wait, dispatch, finalize); then the bf16 eval with
               its maps stitched on the host (as above the device-stitch
               budget), its GeoTIFFs within STITCH_RTOL and census
               metrics within STITCH_STAT_TOL of the first run's;
  6. quant   — the same eval at the default dtype with --quantize int8s,
               w4a8 and int8, then int8 with pallas_stream=True (the
               builder quantized too) through the Evaluator, then
               unquantized again: finite GeoTIFFs, every census r2 within
               QUANT_R2_BOUND of the main run, a population map correlated
               >= QUANT_MAP_CORR with it, and the launch counts of every
               kernel equal to QUANT_LAUNCHES per patch; wall time and
               patches/s of each;
  7. train_step — one training step (the repo's DDA weights, a seeded
               head, 2x192x160, a fixed sparsity mask) on the card against
               the CPU plain path in each memory tier (full gradient,
               encoder_no_grad, unet_no_grad): loss, every gradient leaf,
               frozen leaves exactly zero, the update, and launches of
               kernels A-D on the card; then the full tier in bf16, held
               at the bf16 bounds (STEP_BF16_RTOL);
  8. train   — the train CLI on the same region with the verify skill's
               flags at its default dtype (bf16; 1 epoch, 6 weak
               samples): finite losses, moved head, launches of A and B
               (bf16), C and D (float32, as fused_head), last_model.pth,
               which the eval CLI then turns into finite maps with
               AdjCensus r2 > 0.9. Then steady step times: the epoch's
               batches again through the trainer's step, each shape
               warmed once, and one full-width step at 2x2048^2 in bf16
               and in float32, with its memory; a torch.profiler trace of
               each (train_profile lines) splits the step by kernel and
               gives the device's idle share.
Kernel D (the head backward) is checked in phase 3 at the train phase's
bucket shape (2x1024x1024) and at 2x2048^2. Then the {"kernels": [...]}
summary, the nvidia-smi name/power line, and last {"ok": true, "device":
{...}}. Any failure raises: the script exits non-zero and prints no
result. Run from the repository root:

    python3 chip_smoke.py            # the whole run
    python3 chip_smoke.py --kernels  # phases 1-3 only (no result line)
    python3 chip_smoke.py --kernels --ab DIR
        # also times, case by case, the kernels built from the csrc/ of
        # another checkout DIR (an earlier commit, unpacked by git archive)
        # under the same wrappers: parent, change, change, parent, as
        # parent_* fields of each kernel line (its outputs are not checked)
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
# cores, dense TF32 and INT8 on the tensor cores, and HBM3 bandwidth. The
# float kernels A-D are held to the least time at float32 accuracy: three
# dense TF32 passes a product (the 3xTF32 split, which they run), with
# the FP32 CUDA-core figure beside it (bound_fp32_ms). The int8 kernels
# E-H are held to the card's int8 peak, though they run __dp4a on the CUDA
# cores.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
# what each float kernel's float32 mode is designed against
DESIGNED_AGAINST = {"double_conv": "tf32x3", "up_block": "tf32x3", "head": "tf32x3",
                    "head_bwd": "tf32x3"}
# the kernels that must hold tensor-core MMAs (HMMA in their SASS), by
# source and the name of their kernel functions
TENSOR_CORE_KERNELS = {"double_conv": "double_conv_kernel", "up_block": "up_block_kernel",
                       "head": "head_kernel", "head_bwd": "head_bwd_kernel"}
PEAK_HBM_BYTES = 3.35e12
# no PyTorch call computes an int8 convolution (cuDNN's int8 path is not
# reachable from torch), so the int8 kernels have no library yardstick
NO_INT8_LIBRARY = "no PyTorch call computes an int8 convolution"
# phase quant: the JAX package's census bound for a quantized eval
# (tests/test_quantize_acceptance.py:27) and the map correlation it asks of
# the int8 forward (tests/test_pallas_conv.py::test_int8_popcorn_forward_close)
QUANT_R2_BOUND = 0.02
QUANT_MAP_CORR = 0.99
# launches per 2048^2 5-member patch: 2 streams x (3 DoubleConv + 2 Up) a
# member and the builder's 6 + 4 (float unless pallas_stream), the head once
# a member; the float kernels in the default dtype's (bf16) modes
MAIN_LAUNCHES = {"double_conv_bf16": 36, "up_block_bf16": 24, "head_bf16": 5}
QUANT_LAUNCHES = {
    "int8s": {"double_conv_qs": 30, "up_block_qs": 20, "double_conv_bf16": 6,
              "up_block_bf16": 4, "head_bf16": 5},
    "w4a8": {"double_conv_qs": 30, "up_block_qs": 20, "double_conv_bf16": 6,
             "up_block_bf16": 4, "head_bf16": 5},
    "int8": {"double_conv_q": 30, "up_block_q": 20, "double_conv_bf16": 6, "up_block_bf16": 4,
             "head_bf16": 5},
    "int8+pallas_stream": {"double_conv_q": 36, "up_block_q": 24, "head_bf16": 5},
    # the unquantized eval again, last: the main phase's run is the
    # process's first eval and pays its first-call costs, so the modes are
    # timed between two unquantized runs
    "unquantized": MAIN_LAUNCHES,
}
# main: the bf16 eval against the float32 one on the same members. bf16
# keeps about 3 significant digits through two UNets and the head; the
# JAX package's own bf16 maps correlate 0.9994 with its float32 maps
# (tests/test_torch_bf16.py's region), and the census r2 of the adjusted
# map moves by the map's rounding only
DTYPE_MAP_CORR = 0.999
DTYPE_R2_TOL = 1e-3
# main: the eval stitched on the host against the same eval stitched on the
# card: the same patch maps added in the same order, in float32 on both
# sides (tests/test_multichip.py::test_device_stitch_matches_host's rtol),
# and census metrics of the same maps
STITCH_RTOL = 1e-5
STITCH_STAT_TOL = 1e-6
# kernel vs plain version: float32 in both with different summation
# orders (cuDNN/cuBLAS with TF32 off vs 3xTF32 tensor-core sums); observed
# errors are ~1e-6 relative, so 1e-4 leaves room and still catches any
# indexing or masking fault (those are O(1))
RTOL = ATOL = 1e-4
# the bf16 modes against their plain versions (which round in the same
# places): |got - ref| <= BF16_ULP * (|ref| + max|ref|), about one bf16
# ulp of the value and of the block's scale, since float32 sums taken in
# another order can flip a bf16 rounding; fewer than BF16_DIFF_SHARE of the
# values may differ at all (tests/test_torch_bf16.py's bound)
BF16_ULP = 2.0 ** -7
BF16_DIFF_SHARE = 0.01
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
# the bf16 train step on the card against the CPU's: both round to bf16
# after every op of the trainable UNets (cuDNN's bf16 convs against the
# CPU's) and in the frozen blocks' kernels, so their gradients agree to
# bf16 precision: loss and popcount at rtol 1e-2, the gradient leaves as
# one vector at relative L2 1e-2 and correlation >= 0.999
# (tests/test_torch_bf16.py's bound against the JAX step)
STEP_BF16_RTOL, STEP_BF16_CORR = 1e-2, 0.999
# the bf16 forward on the card against the CPU's (both the kernels'
# rounding): tests/test_torch_bf16.py's bound against the JAX package's
# Pallas-route semantics
MODEL_BF16_CORR = 0.9999
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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def float_bounds(kernel: str, flops: float, nbytes: float) -> dict:
    """A float kernel's bounds: bound_ms at float32 accuracy on the tensor
    cores (TF32_PASSES dense TF32 passes), bound_fp32_ms on the CUDA
    cores, and the least operations time the summary adds up (ops_ms)."""
    b_ms, by = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
    b32_ms, by32 = bound(flops, nbytes, PEAK_FP32_FLOPS)
    return {"bound_ms": b_ms, "bound_by": by, "bound_fp32_ms": b32_ms, "bound_fp32_by": by32,
            "designed_against": DESIGNED_AGAINST[kernel],
            "ops_ms": TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3}


def dev_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    return e.self_device_time_total if hasattr(e, "self_device_time_total") else e.self_cuda_time_total


def device_ms(fn, function: str, reps: int = KERNEL_REPS):
    """The device time a call of ``function`` (a part of the kernel's name)
    takes, from a torch.profiler trace over ``reps`` warmed calls of
    ``fn``: the kernel alone, without the wrapper's host work and its small
    conversion kernels, which time_ms counts where the kernel is faster
    than the host. None if the trace holds no such kernel: it measures, it
    checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and function in e.key]
    if not mine:
        return None
    return sum(dev_us(e) for e in mine) / 1e3 / reps


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
    """A float kernel's output against its plain version's: float32 at
    RTOL/ATOL, bf16 at the BF16_ULP bound. Returns the max abs and
    relative errors and the share of values that differ."""
    import torch

    bf16 = got.dtype == torch.bfloat16
    if ref.dtype != got.dtype:
        raise AssertionError(f"{name}: dtype {got.dtype} vs {ref.dtype}")
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    max_abs = float(err.max())
    ref_max = float(ref.abs().max())
    max_rel = max_abs / max(ref_max, 1e-30)
    share = float((got != ref).float().mean())
    if bf16:
        ok = bool((err <= BF16_ULP * (ref.abs() + ref_max)).all()) and share < BF16_DIFF_SHARE
        if not ok:
            raise AssertionError(f"{name}: max_abs_err {max_abs}, {share:.4%} of the values "
                                 f"differ, beyond the bf16 bound {BF16_ULP} x (|ref| + max|ref|)")
    elif not bool((err <= ATOL + RTOL * ref.abs()).all()):
        raise AssertionError(f"{name}: max_abs_err {max_abs} beyond atol {ATOL} + rtol {RTOL}")
    return max_abs, max_rel, share


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true", help="stop after the kernel checks")
    ap.add_argument("--ab", metavar="DIR", default=None,
                    help="also time the kernels of the checkout DIR in each kernel case")
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
    # registers, spills and shared memory of every kernel (ptxas -v), and
    # the tensor-core MMAs in the SASS of A-D
    for name in cuda_lib.KERNEL_SOURCES:
        rec = {"phase": "build_report", "source": name,
               "ptxas": cuda_lib.ptxas_usage(cuda_lib.build_logs[name])}
        if name in TENSOR_CORE_KERNELS:
            hmma = cuda_lib.sass_count(name, "HMMA")
            rec["sass_hmma"] = hmma
            mains = [v for f, v in hmma.items() if TENSOR_CORE_KERNELS[name] in f]
            if not mains or min(mains) == 0:
                emit(rec)
                raise AssertionError(f"csrc/{name}.cu: a kernel holds no tensor-core MMA: {hmma}")
        emit(rec)

    # the other checkout's kernels, for --ab: built from its csrc/ with the
    # same flags, loaded in place of this checkout's around a timing
    ab_libs = {}
    if args.ab is not None:
        import ctypes

        ab_dir = os.path.join(os.path.abspath(args.ab), "popcorn_tpu_torch", "csrc")
        out_dir = os.path.join(cuda_lib.BUILD_DIR, "ab")
        os.makedirs(out_dir, exist_ok=True)
        procs = {n: subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                                      os.path.join(out_dir, f"lib{n}.so"),
                                      os.path.join(ab_dir, f"{n}.cu")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for n in cuda_lib.KERNEL_SOURCES}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {ab_dir}/{n}.cu:\n{log}")
            ab_libs[n] = ctypes.CDLL(os.path.join(out_dir, f"lib{n}.so"))
        emit({"phase": "ab_build", "dir": args.ab, "sources": list(ab_libs)})

    def ab_times(source, fn, function):
        """Wrapper and device times of ``fn`` with the other checkout's
        library of ``source`` and with this one's, in the order parent,
        change, change, parent: the wrappers find a library in cuda_lib's
        table of loaded ones, where the other one stands in for a timing."""
        own = cuda_lib.load(source)
        times = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            cuda_lib._libs[source] = ab_libs[source] if side == "parent" else own
            try:
                times[side].append((time_ms(fn), device_ms(fn, function)))
            finally:
                cuda_lib._libs[source] = own
            torch.cuda.synchronize()
        return {f"{side}_{k}": [t[i] for t in v] for side, v in times.items()
                for i, k in enumerate(("kernel_ms", "device_ms"))}

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
        """The block as cuDNN convs and elementwise ops in x's dtype."""
        dt = x.dtype
        xc = x.permute(0, 3, 1, 2).contiguous()
        w1 = p["conv1"]["w"].permute(3, 2, 0, 1).contiguous().to(dt)
        w2 = p["conv2"]["w"].permute(3, 2, 0, 1).contiguous().to(dt)
        b1, b2 = p["conv1"]["b"].to(dt), p["conv2"]["b"].to(dt)
        sc1, sh1 = (bn["bn1"][k][:, None, None].to(dt) for k in ("scale", "shift"))
        sc2, sh2 = (bn["bn2"][k][:, None, None].to(dt) for k in ("scale", "shift"))

        def run():
            y = torch.relu(F.conv2d(xc, w1, b1, padding=1) * sc1 + sh1)
            return torch.relu(F.conv2d(y, w2, b2, padding=1) * sc2 + sh2)

        return run

    def up_library(p, bn, x1, x2):
        dt = x2.dtype
        x1c, x2c = x1.permute(0, 3, 1, 2).contiguous(), x2.permute(0, 3, 1, 2).contiguous()
        wt = p["tconv"]["w"].permute(0, 3, 1, 2).contiguous().to(dt)  # (I,2,2,O) -> (I,O,2,2)
        bt = p["tconv"]["b"].to(dt)
        dcp = p["conv"]
        w1 = dcp["conv1"]["w"].permute(3, 2, 0, 1).contiguous().to(dt)
        w2 = dcp["conv2"]["w"].permute(3, 2, 0, 1).contiguous().to(dt)
        b1, b2 = dcp["conv1"]["b"].to(dt), dcp["conv2"]["b"].to(dt)
        sc1, sh1 = (bn["bn1"][k][:, None, None].to(dt) for k in ("scale", "shift"))
        sc2, sh2 = (bn["bn2"][k][:, None, None].to(dt) for k in ("scale", "shift"))

        def run():
            up = F.conv_transpose2d(x1c, wt, bt, stride=2)
            dy, dx = x2c.shape[2] - up.shape[2], x2c.shape[3] - up.shape[3]
            if dy or dx:
                up = F.pad(up, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
            y = torch.cat([x2c, up], 1)
            y = torch.relu(F.conv2d(y, w1, b1, padding=1) * sc1 + sh1)
            return torch.relu(F.conv2d(y, w2, b2, padding=1) * sc2 + sh2)

        return run

    def head_library(x, n_out):
        dt = x.dtype
        x2 = x.reshape(-1, 16)
        w = [head[k]["w"].to(dt) for k in C.HEAD_LAYERS]
        b = [head[k]["b"].to(dt) for k in C.HEAD_LAYERS]
        w4, b4 = w[3][:, :n_out].contiguous(), b[3][:n_out].contiguous()

        def run():
            h = torch.relu(torch.addmm(b[0], x2, w[0]))
            h = torch.relu(torch.addmm(b[1], h, w[1]))
            h = torch.relu(torch.addmm(b[2], h, w[2]))
            return torch.addmm(b4, h, w4)

        return run

    cases = []  # one per checked call: kernel, name, member-forward multiplicity

    def check_case(kernel, name, mult, kern_fn, plain_fn, lib_fn, flops, nbytes,
                   peak=None):
        """Hold the kernel against its plain version (int8 outputs bit for
        bit, float ones at RTOL/ATOL), time both and the library call (None:
        there is none), and record the case."""
        got = kern_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        torch.cuda.synchronize()
        if got.dtype == torch.int8:
            if got.shape != ref.shape or ref.dtype != torch.int8:
                raise AssertionError(f"{name}: {got.shape} int8 vs {ref.shape} {ref.dtype}")
            n_diff = int((got != ref).sum())
            if n_diff:
                raise AssertionError(f"{name}: {n_diff} int8 codes differ from the plain version's")
            max_abs = max_rel = 0.0
            share = 0.0
        else:
            max_abs, max_rel, share = compare(got, ref, name)
        bf16 = got.dtype == torch.bfloat16
        del got, ref
        function = kernel.replace("_bf16", "") + "_kernel"
        k_ms = time_ms(kern_fn)
        d_ms = device_ms(kern_fn, function)
        ab = ab_times(kernel.replace("_bf16", ""), kern_fn, function) if ab_libs else {}
        p_ms = time_ms(plain_fn)
        l_ms = time_ms(lib_fn) if lib_fn is not None else None
        if peak is None:  # a float32 kernel (A-D)
            bounds = float_bounds(kernel, flops, nbytes)
        else:
            b_ms, by = bound(flops, nbytes, peak)
            bounds = {"bound_ms": b_ms, "bound_by": by, "ops_ms": flops / peak * 1e3,
                      "peak_ops_per_s": peak}
        tol = ({"bf16_ulp": BF16_ULP, "diff_share_max": BF16_DIFF_SHARE} if bf16
               else {"rtol": RTOL, "atol": ATOL})
        case = {
            "phase": "kernel", "kernel": kernel, "case": name, "per_member_calls": mult,
            "max_abs_err": max_abs, "max_rel_err": max_rel, "diff_share": share, **tol,
            "kernel_ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "library_ms": l_ms,
            **bounds, "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **ab,
        }
        if lib_fn is None:
            case["library_note"] = NO_INT8_LIBRARY
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
    bf16 = torch.bfloat16
    for name, p, bn, shape, relu, mult in dc_cases:
        x32 = rand(*shape, relu=relu)
        cin, cm, cout = shape[-1], p["conv1"]["w"].shape[3], p["conv2"]["w"].shape[3]
        npx = shape[0] * shape[1] * shape[2]
        flops = 2.0 * npx * 9 * (cin * cm + cm * cout)
        for x, esz, kernel, peak in ((x32, 4, "double_conv", None),
                                     (x32.to(bf16), 2, "double_conv_bf16", PEAK_BF16_FLOPS)):
            nbytes = esz * (npx * (cin + cout) + 9 * (cin * cm + cm * cout)) + 4.0 * 2 * (cm + cout)
            check_case(
                kernel, f"{name} {'x'.join(map(str, shape))}->{cout}", mult,
                lambda p=p, bn=bn, x=x: A.double_conv_cuda(p, bn, x),
                lambda p=p, bn=bn, x=x: A.double_conv_plain(p, bn, x),
                dc_library(p, bn, x), flops, nbytes, peak,
            )
        del x, x32

    # kernel B: up2 (coarse 512^2 x16 + skip 1024^2 x16) and up1
    up_cases = [
        ("up2", unet["sar"]["up2"], unet_bn["sar"]["up2"], (1, P // 4, P // 4, 16), (1, P // 2, P // 2, 16)),
        ("up1", unet["sar"]["up1"], unet_bn["sar"]["up1"], (1, P // 2, P // 2, 8), (1, P, P, 8)),
    ]
    for name, p, bn, s1, s2 in up_cases:
        x1_32, x2_32 = rand(*s1, relu=True), rand(*s2, relu=True)
        c1, cs = s1[-1], s2[-1]
        cu = p["tconv"]["w"].shape[3]
        cm, cout = p["conv"]["conv1"]["w"].shape[3], p["conv"]["conv2"]["w"].shape[3]
        npx = s2[0] * s2[1] * s2[2]
        flops = 2.0 * npx * (c1 * cu + 9 * ((cs + cu) * cm + cm * cout))
        nw = c1 * 4 * cu + 9 * ((cs + cu) * cm + cm * cout)
        for x1, x2, esz, kernel, peak in (
            (x1_32, x2_32, 4, "up_block", None),
            (x1_32.to(bf16), x2_32.to(bf16), 2, "up_block_bf16", PEAK_BF16_FLOPS),
        ):
            nbytes = esz * (x1.numel() + x2.numel() + npx * cout + nw) + 4.0 * (cu + 2 * (cm + cout))
            check_case(
                kernel, f"{name} {'x'.join(map(str, s1))}+{'x'.join(map(str, s2))}->{cout}", 2,
                lambda p=p, bn=bn, x1=x1, x2=x2: B.up_block_cuda(p, bn, x1, x2),
                lambda p=p, bn=bn, x1=x1, x2=x2: B.up_block_plain(p, bn, x1, x2),
                up_library(p, bn, x1, x2), flops, nbytes, peak,
            )
        del x1, x2, x1_32, x2_32

    # kernel C: channel 0 (the member fold) at 2048^2 in float32 and bf16,
    # and the training forward's 2 channels at the train bucket
    feats = rand(1, P, P, 16, relu=True)
    for x, n_out, mult, kernel, esz, peak in (
        (feats, 1, 1, "head", 4, None),
        (feats.to(bf16), 1, 1, "head_bf16", 2, PEAK_BF16_FLOPS),
        (rand(*TRAIN_BUCKET, 16, relu=True), 2, 0, "head", 4, None),
    ):
        npx = x.numel() // 16
        flops = 2.0 * npx * (16 * 64 + 64 * 64 * 2 + 64 * n_out)
        nbytes = (esz * (npx * (16 + n_out) + 16 * 64 + 2 * 64 * 64 + 64 * 2)
                  + 4.0 * (3 * 64 + 2))
        check_case(
            kernel, f"head_{n_out}ch {'x'.join(map(str, x.shape))}->{n_out}", mult,
            lambda x=x, n_out=n_out: C.head_cuda(head, x, n_out),
            lambda x=x, n_out=n_out: C.head_plain(head, x, n_out),
            head_library(x, n_out), flops, nbytes, peak,
        )
    del feats, x

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
        d_ms = device_ms(lambda x=x, gout=gout: C.head_bwd_cuda(head, x, gout), "head_bwd_kernel")
        p_ms = time_ms(lambda x=x, gout=gout: C.head_bwd_plain(head, x, gout))
        l_ms = time_ms(head_bwd_library(x, gout))
        case = {
            "phase": "kernel", "kernel": "head_bwd", "case": name, "per_member_calls": mult,
            **stats_d, "rtol": RTOL, "atol": ATOL, "norm_rtol": NORM_RTOL,
            "raw_norm_rtol": RAW_NORM_RTOL,
            "kernel_ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "library_ms": l_ms,
            **float_bounds("head_bwd", flops_px * npx, 4.0 * npx * (16 + 2 + 16) + wbytes * 2),
            "gflop": flops_px * npx / 1e9,
            "mbytes": (4.0 * npx * (16 + 2 + 16) + wbytes * 2) / 1e6,
        }
        emit(case)
        cases.append(case)
        del x, gout
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    # kernels E-H (int8), on one member's streams at a seeded 2048^2 input:
    # E and F on the static path's codes, with scales calibrated on that
    # input; G and H on the float stream's activations (kernels A and B);
    # plus the builder's odd 519^2 down2 and 519^2 -> 1038^2 up2 at 2076^2
    # (G, H) and a w4a8 down1 (E). Each block's input is the previous
    # block's output, which the check has just held to the plain version.
    from popcorn_tpu_torch.nn import quant as Q
    from popcorn_tpu_torch.nn.ops import max_pool_2x2, reflect_pad

    def dc_cost(x, p, in_b, out_b):
        npx, cin = x.shape[0] * x.shape[1] * x.shape[2], x.shape[3]
        cm, cout = p["conv1"]["w"].shape[3], p["conv2"]["w"].shape[3]
        macs = 9 * (cin * cm + cm * cout)
        return 2.0 * npx * macs, npx * (cin * in_b + cout * out_b) + macs + 4.0 * 2 * (cm + cout)

    def up_cost(x1, x2, p, in_b, out_b):
        npx, cs, c1 = x2.shape[0] * x2.shape[1] * x2.shape[2], x2.shape[3], x1.shape[3]
        cu = p["tconv"]["w"].shape[3]
        cm, cout = p["conv"]["conv1"]["w"].shape[3], p["conv"]["conv2"]["w"].shape[3]
        macs_px = c1 * cu + 9 * ((cs + cu) * cm + cm * cout)
        nw = c1 * 4 * cu + 9 * ((cs + cu) * cm + cm * cout)
        return (2.0 * npx * macs_px,
                (x1.numel() + x2.numel()) * in_b + npx * cout * out_b + nw + 4.0 * (5 * cu + 3 * cm + 2 * cout))

    def shape_name(*ts):
        return "+".join("x".join(map(str, t.shape)) for t in ts)

    def e_case(name, mult, stream, block, xq, s_x, s_y1, s_out, wbits=8):
        p, bn = unet[stream][block], unet_bn[stream][block]
        a, fo = A.qs_args(p, bn, s_x, s_y1, s_out, wbits), s_out is None
        ops, nb = dc_cost(xq, p, 1, 4 if fo else 1)
        check_case("double_conv_qs", f"{name} {shape_name(xq)}", mult,
                   lambda: A.double_conv_qs_cuda(*a, xq, fo), lambda: A.double_conv_qs_plain(*a, xq, fo),
                   None, ops, nb, PEAK_INT8_OPS)
        return A.double_conv_qs_cuda(*a, xq, fo)

    def f_case(name, mult, stream, block, x1q, x2q, s_x1, s_x2, s_up, s_y1, s_out):
        p, bn = unet[stream][block], unet_bn[stream][block]
        a, fo = B.qs_args(p, bn, s_x1, s_x2, s_up, s_y1, s_out), s_out is None
        ops, nb = up_cost(x1q, x2q, p, 1, 4 if fo else 1)
        check_case("up_block_qs", f"{name} {shape_name(x1q, x2q)}", mult,
                   lambda: B.up_block_qs_cuda(*a, x1q, x2q, fo),
                   lambda: B.up_block_qs_plain(*a, x1q, x2q, fo), None, ops, nb, PEAK_INT8_OPS)
        return B.up_block_qs_cuda(*a, x1q, x2q, fo)

    def g_case(name, mult, stream, block, x):
        p, bn = unet[stream][block], unet_bn[stream][block]
        a = A.q_args(p, bn)
        ops, nb = dc_cost(x, p, 4, 4)
        check_case("double_conv_q", f"{name} {shape_name(x)}", mult,
                   lambda: A.double_conv_q_cuda(*a, x), lambda: A.double_conv_q_plain(*a, x),
                   None, ops, nb, PEAK_INT8_OPS)

    def h_case(name, mult, stream, block, x1, x2):
        p, bn = unet[stream][block], unet_bn[stream][block]
        a = B.q_args(p, bn)
        ops, nb = up_cost(x1, x2, p, 4, 4)
        check_case("up_block_q", f"{name} {shape_name(x1, x2)}", mult,
                   lambda: B.up_block_q_cuda(*a, x1, x2), lambda: B.up_block_q_plain(*a, x1, x2),
                   None, ops, nb, PEAK_INT8_OPS)

    x6 = torch.randn(1, P, P, 6, device=dev, generator=g)
    xs, xo = x6[..., :2].contiguous(), x6[..., 2:].contiguous()
    s, so = (Q.calibrate_stream(unet[k], unet_bn[k], xx) for k, xx in (("sar", xs), ("opt", xo)))
    qx1 = e_case("inc_sar", 1, "sar", "inc", Q.quantize_static(xs, s["in"]), s["in"], s["inc_y1"], s["inc_out"])
    e_case("inc_opt", 1, "opt", "inc", Q.quantize_static(xo, so["in"]), so["in"], so["inc_y1"], so["inc_out"])
    qd1 = e_case("down1", 2, "sar", "down1", max_pool_2x2(qx1), s["inc_out"], s["down1_y1"], s["down1_out"])
    e_case("down1_w4a8", 0, "sar", "down1", max_pool_2x2(qx1), s["inc_out"], s["down1_y1"],
           s["down1_out"], wbits=4)
    qd2 = e_case("down2", 2, "sar", "down2", max_pool_2x2(qd1), s["down1_out"], s["down2_y1"], s["down2_out"])
    qu2 = f_case("up2", 2, "sar", "up2", qd2, qd1, s["down2_out"], s["down1_out"], s["up2_up"],
                 s["up2_y1"], s["up2_out"])
    f_case("up1_float_out", 2, "sar", "up1", qu2, qx1, s["up2_out"], s["inc_out"], s["up1_up"],
           s["up1_y1"], None)
    del qx1, qd1, qd2, qu2
    with torch.no_grad():
        fx1 = A.double_conv_cuda(unet["sar"]["inc"], unet_bn["sar"]["inc"], xs)
        fd1 = A.double_conv_cuda(unet["sar"]["down1"], unet_bn["sar"]["down1"], max_pool_2x2(fx1))
        fd2 = A.double_conv_cuda(unet["sar"]["down2"], unet_bn["sar"]["down2"], max_pool_2x2(fd1))
        fu2 = B.up_block_cuda(unet["sar"]["up2"], unet_bn["sar"]["up2"], fd2, fd1)
    g_case("inc_sar", 1, "sar", "inc", xs)
    g_case("inc_opt", 1, "opt", "inc", xo)
    g_case("down1", 2, "sar", "down1", max_pool_2x2(fx1))
    g_case("down2", 2, "sar", "down2", max_pool_2x2(fd1))
    h_case("up2", 2, "sar", "up2", fd2, fd1)
    h_case("up1", 2, "sar", "up1", fu2, fx1)
    del fx1, fd1, fd2, fu2
    # the builder: 2048^2 reflect-padded by 14 to 2076^2, 519^2 at down2
    xb = reflect_pad(xs, 14).contiguous()
    with torch.no_grad():
        bx1 = A.double_conv_cuda(unet["sar"]["inc"], unet_bn["sar"]["inc"], xb)
        bd1 = A.double_conv_cuda(unet["sar"]["down1"], unet_bn["sar"]["down1"], max_pool_2x2(bx1))
        bd2 = A.double_conv_cuda(unet["sar"]["down2"], unet_bn["sar"]["down2"], max_pool_2x2(bd1))
    g_case("down2_builder_odd", 0, "sar", "down2", max_pool_2x2(bd1))
    h_case("up2_builder_odd", 0, "sar", "up2", bd2, bd1)
    del x6, xs, xo, xb, bx1, bd1, bd2
    torch.cuda.empty_cache()
    if args.kernels:
        return

    # ----------------------------------------------------------------- 4. model
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda
    from popcorn_tpu_torch.config import ModelConfig
    from popcorn_tpu_torch.nn.popcorn import popcorn_forward

    import dataclasses

    import numpy as np

    mcfg = ModelConfig(biasinit=0.9407)
    params, consts = load_popcorn_from_dda(mcfg, head_seed=1)
    xs = torch.randn(1, 192, 160, 6, generator=torch.Generator().manual_seed(1))
    ref = popcorn_forward(params, consts, {"input": xs}, mcfg, padding=False)
    got = popcorn_forward(
        to_torch(params, dev), to_torch(consts, dev), {"input": xs.to(dev)}, mcfg, padding=False
    )
    m_abs, m_rel, _ = compare(got["popdensemap"].cpu(), ref["popdensemap"], "model popdensemap")
    pc_rel = abs(float(got["popcount"][0]) - float(ref["popcount"][0])) / abs(float(ref["popcount"][0]))
    if not pc_rel <= 2e-4:
        raise AssertionError(f"model popcount relative error {pc_rel}")
    # bf16: the kernels' bf16 modes against the plain versions on the CPU,
    # which round in the same places; sums in another order can flip a
    # rounding, and a flip travels through the later blocks
    mcfg_bf = dataclasses.replace(mcfg, compute_dtype="bfloat16")
    ref_bf = popcorn_forward(params, consts, {"input": xs}, mcfg_bf, padding=False)
    got_bf = popcorn_forward(to_torch(params, dev), to_torch(consts, dev), {"input": xs.to(dev)},
                             mcfg_bf, padding=False)
    a = ref_bf["popdensemap"].double().ravel()
    b = got_bf["popdensemap"].cpu().double().ravel()
    bf_rel = float((b - a).norm() / a.norm())
    bf_corr = float(np.corrcoef(a.numpy(), b.numpy())[0, 1])
    emit({"phase": "model", "input": [1, 192, 160, 6], "max_abs_err": m_abs,
          "max_rel_err": m_rel, "popcount_rel_err": pc_rel, "bf16_map_rel_l2": bf_rel,
          "bf16_map_corr": bf_corr, "bf16_rel_l2_max": STEP_BF16_RTOL,
          "bf16_corr_min": MODEL_BF16_CORR})
    if not (bf_rel <= STEP_BF16_RTOL and bf_corr >= MODEL_BF16_CORR):
        raise AssertionError(f"model bf16 popdensemap: relative L2 {bf_rel}, correlation {bf_corr}")

    # ------------------------------------------------------------------ 5. main
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

        counters = {"double_conv": (A, "launches"), "double_conv_bf16": (A, "launches_bf16"),
                    "up_block": (B, "launches"), "up_block_bf16": (B, "launches_bf16"),
                    "head": (C, "launches"), "head_bf16": (C, "launches_bf16"),
                    "double_conv_qs": (A, "launches_qs"), "up_block_qs": (B, "launches_qs"),
                    "double_conv_q": (A, "launches_q"), "up_block_q": (B, "launches_q")}

        def reset_launches():
            for mod, attr in counters.values():
                setattr(mod, attr, 0)

        def read_launches():
            return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

        n_patches = 4  # patch grid of a 2304x2560 region at 2048/128

        def run_eval(tag, extra=(), want=None, config=None, timings=None):
            """One eval of the 5 members, from a folder of links to them
            where it writes its outputs: through the eval CLI with the
            ``extra`` flags, or through the Evaluator with ``config`` (a
            function of the CLI's ModelConfig). Launch counts are checked
            against ``want`` per patch; ``timings`` receives the sliding
            window's split. Returns the stats, wall seconds, launches and
            the output folder's glob."""
            from popcorn_tpu_torch.cli.args import eval_config_from_args, eval_parser, model_config_from_args
            from popcorn_tpu_torch.config import DataPaths
            from popcorn_tpu_torch.infer.evaluator import Evaluator

            mdir = os.path.join(tmp, tag)
            os.makedirs(mdir)
            links = []
            for m in members:
                links.append(os.path.join(mdir, os.path.basename(m)))
                os.symlink(m, links[-1])
            argv = ["--data_root", data, *eval_flags, "-r", *links, *extra]
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if config is None:
                out = eval_cli.main(argv, timings=timings)
            else:
                a = eval_parser().parse_args(argv)
                out = Evaluator(DataPaths(data), config(model_config_from_args(a)),
                                eval_config_from_args(a), device=dev).test_target(
                                    save=True, timings=timings)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got_l = read_launches()
            want_l = {k: want.get(k, 0) * n_patches for k in counters}
            if got_l != want_l:
                raise AssertionError(f"eval {tag}: launches {got_l}, expected {want_l}")
            folder_glob = os.path.join(mdir, "eval_outputs_ensemble_*")
            check_eval(out, folder_glob)
            return out, secs, got_l, folder_glob

        def read_map(folder_glob, tag=""):
            path = os.path.join(glob.glob(folder_glob)[0], f"rwa_predictions{tag}.tif")
            with GeoTIFF(path) as gt:
                return gt.read(1, squeeze=True).astype(np.float64)

        def adj_r2(st):
            return {k: v for k, v in st.items() if "AdjCensus" in k and k.endswith("/r2")}

        # the CLI's default dtype (bf16), then float32
        torch.cuda.reset_peak_memory_stats(dev)
        split, split32, split_host = {}, {}, {}
        stats, wall, launches, main_glob = run_eval("main", want=MAIN_LAUNCHES, timings=split)
        peak = torch.cuda.max_memory_allocated(dev)
        main_map = read_map(main_glob)
        want32 = {k.replace("_bf16", ""): v for k, v in MAIN_LAUNCHES.items()}
        stats32, wall32, launches32, glob32 = run_eval(
            "main_float32", ("--compute_dtype", "float32"), want32, timings=split32)
        # the bf16 eval again with its maps stitched on the host, as a
        # region above the device-stitch budget would have them (the budget
        # set to 0): the same forward, so the same maps and census metrics
        from popcorn_tpu_torch.infer import sliding
        budget = sliding._DEVICE_STITCH_BUDGET_BYTES
        sliding._DEVICE_STITCH_BUDGET_BYTES = 0
        try:
            stats_h, wall_h, _, glob_h = run_eval("main_host_stitch", want=MAIN_LAUNCHES,
                                                  config=lambda c: c, timings=split_host)
        finally:
            sliding._DEVICE_STITCH_BUDGET_BYTES = budget
        stitch_diff = {}
        for tag in ("", "STD", "SCALE_rwa", "SCALE_STD", "ADJ_rwa"):
            a_h, a_d = read_map(glob_h, tag), read_map(main_glob, tag)
            stitch_diff[tag or "map"] = float(np.abs(a_h - a_d).max() / max(np.abs(a_d).max(), 1e-30))
        stat_diff = max(abs(stats_h[k] - stats[k]) for k in stats)
        if max(stitch_diff.values()) > STITCH_RTOL or stat_diff > STITCH_STAT_TOL:
            raise AssertionError(f"host-stitched eval: map differences {stitch_diff}, "
                                 f"census metrics differ by up to {stat_diff}")
        dtype_corr = float(np.corrcoef(main_map.ravel(), read_map(glob32).ravel())[0, 1])
        dtype_r2 = {k: v - adj_r2(stats32)[k] for k, v in adj_r2(stats).items()}
        r2 = stats["Population_AdjCensus_rwa_coarse/r2"]
        emit({
            "phase": "main", "members": 5, "patch": 2048, "overlap": 128,
            "region": [2304, 2560], "patches": n_patches, "setup_s": setup_s,
            "compute_dtype": "bfloat16", "wall_s": wall, "patches_per_s": n_patches / wall,
            "peak_mem_bytes": peak, "launches": launches,
            "adj_coarse_r2": r2, "main_coarse_r2": stats["Population_MainCensus_rwa_coarse/r2"],
            "timings": split["rwa"],
            "float32": {"wall_s": wall32, "patches_per_s": n_patches / wall32,
                        "launches": launches32, "timings": split32["rwa"],
                        "adj_coarse_r2": stats32["Population_AdjCensus_rwa_coarse/r2"]},
            "host_stitch": {"wall_s": wall_h, "timings": split_host["rwa"],
                            "max_rel_diff": stitch_diff, "census_max_abs_diff": stat_diff,
                            "rtol": STITCH_RTOL, "census_tol": STITCH_STAT_TOL},
            "map_corr_bf16_float32": dtype_corr, "map_corr_min": DTYPE_MAP_CORR,
            "adj_r2_deltas": dtype_r2, "adj_r2_tol": DTYPE_R2_TOL,
        })
        if not (dtype_corr >= DTYPE_MAP_CORR and max(abs(d) for d in dtype_r2.values()) <= DTYPE_R2_TOL):
            raise AssertionError(f"bf16 vs float32 eval: map correlation {dtype_corr}, "
                                 f"AdjCensus r2 deltas {dtype_r2}")

        # ---------------------------------------------------------------- 6. quant
        quant_launches = {}
        for mode, want in QUANT_LAUNCHES.items():
            if mode == "int8+pallas_stream":
                # the JAX package has no CLI flag for it: the config through
                # the Evaluator, which runs run_sliding_inference with it
                stats_q, q_wall, got_l, folder_glob = run_eval(
                    f"quant_{mode}", want=want,
                    config=lambda c: dataclasses.replace(c, quantize="int8", pallas_stream=True))
            else:
                extra = () if mode == "unquantized" else ("--quantize", mode)
                stats_q, q_wall, got_l, folder_glob = run_eval(f"quant_{mode}", extra, want)
            quant_launches[mode] = got_l
            q_r2 = stats_q["Population_AdjCensus_rwa_coarse/r2"]
            deltas = {k: stats_q[k] - stats[k] for k in stats if k.endswith("/r2")}
            q_map = read_map(folder_glob)
            corr = float(np.corrcoef(main_map.ravel(), q_map.ravel())[0, 1])
            emit({
                "phase": "quant", "mode": mode, "compute_dtype": "bfloat16", "patches": n_patches,
                "wall_s": q_wall, "patches_per_s": n_patches / q_wall, "main_wall_s": wall,
                "main_patches_per_s": n_patches / wall, "launches": got_l,
                "r2_deltas": deltas, "r2_bound": QUANT_R2_BOUND, "map_corr": corr,
                "map_corr_min": QUANT_MAP_CORR, "adj_coarse_r2": q_r2,
            })
            if max(abs(d) for d in deltas.values()) > QUANT_R2_BOUND or not corr >= QUANT_MAP_CORR:
                raise AssertionError(f"quant {mode}: census r2 deltas {deltas}, map correlation {corr}")

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

        # the full tier in bf16 (the CLIs' default): card against CPU
        flags = tiers["full"]
        res = {}
        for where in (torch.device("cpu"), dev):
            step = train_state.make_train_step(mcfg_bf, tcfg, to_torch(consts, where),
                                               NormStats(device=where),
                                               train_state.make_optimizer(tcfg))
            tb = {k: torch.from_numpy(v).to(where) for k, v in small.items()}
            before = (A.launches_bf16, B.launches_bf16, C.launches, C.bwd_launches)
            grads, aux = step.grads(to_torch(params, where), tb, mask=mask.to(where), **flags)
            after = (A.launches_bf16, B.launches_bf16, C.launches, C.bwd_launches)
            res[where.type] = (dict(train_state.tree_flatten(grads)), aux,
                               [x - y for x, y in zip(after, before)])
        (g_c, aux_c, _), (g_g, aux_g, tier_launches) = res["cpu"], res["cuda"]
        loss_rel = abs(float(aux_g["optimization_loss"]) - float(aux_c["optimization_loss"])) / abs(
            float(aux_c["optimization_loss"]))
        pc_rel = float(((aux_g["popcount"].cpu() - aux_c["popcount"]).abs()
                        / aux_c["popcount"].abs()).max())
        trainable = [k for k in g_c if not frozen(k, flags)]
        frozen_ok = all(not bool(g_c[k].any()) and not bool(g_g[k].any())
                        for k in g_c if frozen(k, flags))
        moved = all(float(g_c[k].norm()) > 0 for k in trainable)
        vc = torch.cat([g_c[k].ravel() for k in trainable]).double()
        vg = torch.cat([g_g[k].cpu().ravel() for k in trainable]).double()
        grad_rel = float((vg - vc).norm() / vc.norm())
        grad_corr = float(np.corrcoef(vc.numpy(), vg.numpy())[0, 1])
        launched = dict(zip(("double_conv_bf16", "up_block_bf16", "head", "head_bwd"), tier_launches))
        step_ok = (loss_rel <= STEP_BF16_RTOL and pc_rel <= STEP_BF16_RTOL and frozen_ok and moved
                   and grad_rel <= STEP_BF16_RTOL and grad_corr >= STEP_BF16_CORR
                   and all(v > 0 for v in launched.values()))
        emit({"phase": "train_step", "tier": "full", "compute_dtype": "bfloat16", "ok": step_ok,
              "input": [2, 192, 160, 6], "loss_cpu": float(aux_c["optimization_loss"]),
              "loss_gpu": float(aux_g["optimization_loss"]), "loss_rel_err": loss_rel,
              "popcount_rel_err": pc_rel, "grad_rel_l2": grad_rel, "grad_corr": grad_corr,
              "frozen_leaves_zero": frozen_ok, "card_launches": launched,
              "rtol": STEP_BF16_RTOL, "corr_min": STEP_BF16_CORR})
        if not step_ok:
            raise AssertionError("the bf16 train step on the card disagrees with the CPU plain path")
        del res, g_c, g_g

        # --------------------------------------------------------------- 7. train
        reset_launches()
        C.bwd_launches = 0
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
        # at the default dtype: the builder's blocks in bf16, the training
        # head in float32 (kernels C and D, as fused_head)
        train_launches = {"double_conv_bf16": A.launches_bf16, "up_block_bf16": B.launches_bf16,
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

        # full-tier steps on seeded batches at the train bucket and at full
        # width, 2x2048^2 (8.4M px: the full-gradient tier), in bf16 and in
        # float32
        params, consts = load_popcorn_from_dda(mcfg, head_seed=7)
        p = to_torch(params, dev)
        gen = torch.Generator().manual_seed(0)
        dtype_steps = {}
        for cdt, cfg in (("bfloat16", mcfg_bf), ("float32", mcfg)):
            step = train_state.make_train_step(cfg, tcfg, to_torch(consts, dev),
                                               NormStats(device=dev), train_state.make_optimizer(tcfg))
            opt_state = step.optimizer.init(p)
            for lead in (TRAIN_BUCKET, (2, P, P)):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(*lead).items()}

                def one_step(step=step, opt_state=opt_state, batch=batch):
                    _, _, aux = step(p, opt_state, batch, gen)
                    float(aux["optimization_loss"])

                t = time_step(one_step)
                dtype_steps.setdefault(cdt, []).append({"input": [*lead, 6], **t})
                if lead[1] == P:
                    profiles.append(profile_steps(f"full-width step {list(lead)} {cdt}", one_step,
                                                  t["median_ms"]))
                del batch, one_step
            del step, opt_state
        emit({
            "phase": "train", "steps": len(shapes), "batch_shapes": [list(s) for s in shapes],
            "buckets": list(buckets.values()), "step_reps": STEP_REPS,
            "median_step_ms": float(np.median([buckets[s]["median_ms"] for s in shapes])),
            "epoch_step_ms": epoch_ms, "samples_per_s": n_samples / (epoch_ms / 1e3),
            "cli_wall_s": train_wall, "cli_peak_mem_bytes": train_peak, "losses": losses,
            "head_max_move": moved, "launches": train_launches,
            "ckpt_eval_adj_coarse_r2": t_r2, "compute_dtype": "bfloat16",
            "seeded_steps": dtype_steps,
        })
        for prof in profiles:
            emit(prof)
        del p
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- summary
    # each kernel's launches from the run of its own path: A-C in bf16 the
    # main eval at the default dtype, in float32 its float32 run, D
    # training, E/F the int8s eval, G/H the int8 eval
    launches = {**{k: launches[k] for k in MAIN_LAUNCHES},
                **{k: launches32[k] for k in ("double_conv", "up_block", "head")},
                "head_bwd": train_launches["head_bwd"],
                "double_conv_qs": quant_launches["int8s"]["double_conv_qs"],
                "up_block_qs": quant_launches["int8s"]["up_block_qs"],
                "double_conv_q": quant_launches["int8"]["double_conv_q"],
                "up_block_q": quant_launches["int8"]["up_block_q"]}
    meta = {
        "double_conv": ("popcorn_tpu_torch/csrc/double_conv.cu", "popcorn_tpu/nn/pallas_conv.py:101"),
        "double_conv_bf16": ("popcorn_tpu_torch/csrc/double_conv.cu",
                             "popcorn_tpu/nn/pallas_conv.py:101"),
        "up_block": ("popcorn_tpu_torch/csrc/up_block.cu", "popcorn_tpu/nn/pallas_conv.py:472"),
        "up_block_bf16": ("popcorn_tpu_torch/csrc/up_block.cu", "popcorn_tpu/nn/pallas_conv.py:472"),
        "head": ("popcorn_tpu_torch/csrc/head.cu", "popcorn_tpu/nn/pallas_packed_head.py:41"),
        "head_bf16": ("popcorn_tpu_torch/csrc/head.cu", "popcorn_tpu/nn/pallas_packed_head.py:83"),
        "head_bwd": ("popcorn_tpu_torch/csrc/head_bwd.cu", "popcorn_tpu/nn/pallas_head.py:56"),
        "double_conv_qs": ("popcorn_tpu_torch/csrc/double_conv_qs.cu", "popcorn_tpu/nn/pallas_conv.py:235"),
        "up_block_qs": ("popcorn_tpu_torch/csrc/up_block_qs.cu", "popcorn_tpu/nn/pallas_conv.py:282"),
        "double_conv_q": ("popcorn_tpu_torch/csrc/double_conv_q.cu", "popcorn_tpu/nn/pallas_conv.py:163"),
        "up_block_q": ("popcorn_tpu_torch/csrc/up_block_q.cu", "popcorn_tpu/nn/pallas_conv.py:533"),
    }
    kernels = []
    for kname, (src, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == kname]
        on_path = [c for c in mine if c["per_member_calls"] > 0]
        tot = lambda key: sum(c[key] * c["per_member_calls"] for c in on_path)  # noqa: E731
        b_ops = sum(c["ops_ms"] * c["per_member_calls"] for c in on_path)
        b_bytes = sum(c["mbytes"] * 1e6 * c["per_member_calls"] for c in on_path) / PEAK_HBM_BYTES * 1e3
        no_lib = any(c["library_ms"] is None for c in on_path)
        no_dev = any(c["device_ms"] is None for c in on_path)
        entry = {
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": tot("kernel_ms"), "device_ms": None if no_dev else tot("device_ms"),
            "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": None if no_lib else tot("library_ms"),
        }
        if kname in DESIGNED_AGAINST:
            entry["bound_fp32_ms"] = tot("bound_fp32_ms")
            entry["designed_against"] = DESIGNED_AGAINST[kname]
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

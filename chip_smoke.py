#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (popcorn_tpu_torch) on one NVIDIA GPU.

Phases, each printing one JSON line:
  1. device  — requires CUDA; the card's name and power limit, versions;
               TF32 off, so the plain versions are true float32;
  2. build   — compiles every kernel of csrc/ with nvcc (all at once),
               then one build_report line a source: registers, spills
               and shared memory of each kernel (ptxas -v), and the
               tensor-core MMAs in the SASS of A-D (HMMA) and of E-H
               (IMMA, with no __dp4a: IDP.4A), which must be there in
               every instantiation;
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
               int8 outputs, and E's and F's float outputs, must equal
               their plain versions' bit for bit; G and H again in their
               bf16 modes and F's up1 with bf16 features, the eval's
               default; their library time is the plain version with its
               integer products on torch._int_mm;
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
               (feed wait, upload, dispatch, finalize); then the bf16 eval
               with its maps stitched on the host (as above the
               device-stitch budget), its GeoTIFFs within STITCH_RTOL and
               census metrics within STITCH_STAT_TOL of the first run's.
               These runs take the device-resident season mosaics (the
               default with a device stitch); the feeds line holds them
               against the same eval through the host patch feed (the four
               stitched GeoTIFFs bit-equal), with both timings splits, then
               --transport bf16 (census r2 within TRANSPORT_R2_BOUND of the
               exact run) and a run with NaNs in one S1 window (exactly one
               patch through the host feed);
  6. quant   — the same eval at the default dtype with --quantize int8s,
               w4a8 and int8, then int8 with pallas_stream=True (the
               builder quantized too) through the Evaluator, int8 and
               int8s at --compute_dtype float32 (H's float32 mode, F's
               float32 features), then unquantized again: finite GeoTIFFs, every census r2 within
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
               AdjCensus r2 > 0.9. The CLI must have taken the
               device-resident training feed; the train_feed line holds its
               epoch-0 batches, and the season-rotating feed's samples,
               bit-equal to the host feed's, and gives the cost gate's
               report from probes on the card. Then steady step times: the epoch's
               batches again through the trainer's step, each shape
               warmed once, and one full-width step at 2x2048^2 in bf16
               and in float32, with its memory; a torch.profiler trace of
               each (train_profile lines) splits the step by kernel and
               gives the device's idle share;
  9. no_fused_head — the 5-member eval with --no_fused_head at bf16 and
               at float32: A and B launched as in main and C not at all,
               each map correlated >= DTYPE_MAP_CORR with main's run of its
               dtype and census r2 within NO_FUSED_R2_BOUND; then a 2-step
               train CLI run with the flag: no C, no D, finite losses;
 10. timeseries — builtup: the time-series CLI on dated frames made of
               the region's season mosaics (two dates, both orbits) at its
               1024/64 patches in float32, with exactly 6 A and 4 B
               launches a patch call; one frame's orbit map against the
               plain versions on the CPU (BUILTUP_ATOL), the written map
               against the orbits' mean, a profiled patch call
               (timeseries_profile line); population: the CLI over two
               steps (this region and one from seed 43) with the 5 members
               at 2048/128 in bf16, each step's maps bit-equal to
               run_sliding_inference called directly, totals.csv;
 11. dda     — DDA extractor training through its CLI on a synthetic
               manifest of 256^2 tiles (8 labeled + 8 unlabeled a batch,
               3 epochs): the loss falls; one step on the card against the
               CPU from the same weights (adam_step_agreement); the
               exported checkpoint through create_building_score on the
               card (6 A, 4 B);
 12. dist    — ranks and whole frames: the eval CLI with --spatial at
               bf16 and float32 on one rank (A, B, C launched once a
               frame), its interior held to the stitched eval of the same
               dtype (SPATIAL_INTERIOR) and its outer ring non-zero where
               the stitched map is 0; the builder in 512-row chunks and
               the member fold in 1024-row strips against the whole frame
               (STRIP_TOL); the builtup time series with --spatial against
               its patch path (BUILTUP_PATCH_TOL); the two-process
               rehearsal (dist/multihost.py) with both workers on cuda:0
               over gloo against one rank (loss, stepped parameters, the
               ensemble fold's sum; A-D launched in each worker's step);
               the Evaluator with the patches over two data ranks and with
               the members over two ensemble ranks, both on cuda:0 over
               gloo (dist/launch.py), rank 0's written map against the
               one-rank map (RANKED_MAP_TOL), rank 0 alone writing the one
               output folder and the census, and each rank's launches
               exact;
 13. spatial_train — --spatial_train: one seeded 1x4096x2048 crop (the
               DDA weights, a seeded head, a drawn sparsity mask) through
               the train step on one rank and with its rows over two ranks
               on cuda:0 over gloo, in float32 and bf16, the two ranks held
               to the one rank (SPATIAL_* constants), each rank launching
               exactly 6 A and 4 B in the dtype's mode and 1 C and 1 D,
               with each rank's step ms and peak memory beside the one
               rank's; then the train CLI's --spatial_train on the same two
               ranks against the one-rank CLI (first loss at the bf16
               bound), rank 0 alone writing last_model.pth, which the eval
               CLI turns into finite maps;
 14. prep    — a region built by the port's tools (popcorn_tpu_torch/
               tools/, each run as ``python -m``) from the main region:
               its coarse and fine admin rectangles as GeoJSON polygons
               with a census CSV through preprocess_census (boundary rasters
               bit-equal, census idx, bbox, count and POP20 equal), its
               season mosaics cut into raw tiles and merged by merge_tiffs
               (bit-equal, uint16 and float32 with NaNs), their sidecars by
               build_raster_cache (byte-equal to the direct reader); the
               bf16 5-member eval on it, its device feed reading the
               sidecars (exactly MAIN_LAUNCHES a patch), against the same
               eval on the region as written: the five GeoTIFFs bit-equal and
               the census metrics equal; then parity_released --selftest on
               the card (A-C in float32, E and F under int8s, the eval CLI's
               metrics equal to the harness's) and dryrun_multichip(2) on two
               ranks of cuda:0 over gloo.
Each of phases 9-14 prints its wall seconds.
Kernel D (the head backward) is checked in phase 3 at the train phase's
bucket shape (2x1024x1024), at 2x2048^2 and at a spatial rank's kept rows
(1x2048x2048, as kernel C's 2-channel forward). The optimizer update
(csrc/adam.cu, one call of two kernels a train step) follows E-H in phase
3, over the DDA member's 62 leaves and a Prithvi-EO-2.0-300M member's 308
against Optimizer.update_plain. Then the {"kernels": [...]}
summary, the nvidia-smi name/power line, and last {"ok": true, "device":
{...}}. Any failure raises: the script exits non-zero and prints no
result. Run from the repository root:

    python3 chip_smoke.py            # the whole run
    python3 chip_smoke.py --kernels  # phases 1-3 only (no result line)
    python3 chip_smoke.py --kernels --ab DIR
        # also times, case by case, the kernels built from the csrc/ of
        # another checkout DIR (an earlier commit, unpacked by git archive)
        # under the same wrappers: parent, change, change, parent, as
        # parent_* fields of each kernel line (its outputs are not checked;
        # a mode the parent lacks runs its nearest entry with the parent's
        # conversions around it)
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

# The card's published dense peaks, read in main from the port's one table
# (popcorn_tpu_torch/utils/flops.py::device_peak_flops, by the card's name;
# an H100 SXM: FP32 67 TFLOP/s on the CUDA cores, TF32 495, bf16 989 and
# int8 1,979 TOP/s on the tensor cores), and HBM3 bandwidth. The float
# kernels A-D are held to the least time at float32 accuracy: three dense
# TF32 passes a product (the 3xTF32 split, which they run), with the FP32
# CUDA-core figure beside it (bound_fp32_ms). The int8 kernels E-H, on the
# int8 tensor cores (mma.sync), are held to the card's dense int8 peak.
PEAK = {}  # 'fp32', 'tf32', 'bf16', 'int8' -> FLOP/s (int8: OP/s)
TF32_PASSES = 3
# what each float kernel's float32 mode is designed against
DESIGNED_AGAINST = {"double_conv": "tf32x3", "up_block": "tf32x3", "head": "tf32x3",
                    "head_bwd": "tf32x3"}
# the kernels that must hold tensor-core MMAs in their SASS, by source:
# the name of their kernel functions and the MMA's opcode (HMMA for float
# operands, IMMA for int8), and for the int8 ones no __dp4a (IDP.4A)
TENSOR_CORE_KERNELS = {"double_conv": ("double_conv_kernel", "HMMA"),
                       "up_block": ("up_block_kernel", "HMMA"),
                       "head": ("head_kernel", "HMMA"), "head_bwd": ("head_bwd_kernel", "HMMA"),
                       "double_conv_qs": ("double_conv_qs_kernel", "IMMA"),
                       "up_block_qs": ("up_block_qs_kernel", "IMMA"),
                       "double_conv_q": ("double_conv_q_kernel", "IMMA"),
                       "up_block_q": ("up_block_q_kernel", "IMMA")}
NO_TENSOR_CORE_OPCODE = {"IMMA": "IDP.4A"}
PEAK_HBM_BYTES = 3.35e12
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
    # F's up2 with int8 out, its up1 with bf16 features
    "int8s": {"double_conv_qs": 30, "up_block_qs": 10, "up_block_qs_bf16": 10,
              "double_conv_bf16": 6, "up_block_bf16": 4, "head_bf16": 5},
    "w4a8": {"double_conv_qs": 30, "up_block_qs": 10, "up_block_qs_bf16": 10,
             "double_conv_bf16": 6, "up_block_bf16": 4, "head_bf16": 5},
    # G and H in their bf16 modes only
    "int8": {"double_conv_q_bf16": 30, "up_block_q_bf16": 20, "double_conv_bf16": 6,
             "up_block_bf16": 4, "head_bf16": 5},
    "int8+pallas_stream": {"double_conv_q_bf16": 36, "up_block_q_bf16": 24, "head_bf16": 5},
    # the float32 modes on their path, at --compute_dtype float32: G's and
    # H's, and F's up2 with int8 out and its up1 with float32 features
    "int8_float32": {"double_conv_q": 30, "up_block_q": 20, "double_conv": 6, "up_block": 4,
                     "head": 5},
    "int8s_float32": {"double_conv_qs": 30, "up_block_qs": 20, "double_conv": 6,
                      "up_block": 4, "head": 5},
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
# main: the device-resident feed against the host feed on the same region.
# The same tensors reach the same forward in the same order, so the four
# stitched GeoTIFFs must be bit-equal; the ADJ map and the census metrics
# divide by segment sums that index_add_ forms with atomic adds on the
# card, whose order varies from run to run, so they are held at the host
# stitch's bounds above. --transport bf16 against the exact run: the JAX
# package's census bound for it (tests/test_transport.py:147).
TRANSPORT_R2_BOUND = 0.02
# main: the NaN-hybrid run writes NaNs here into the S1 mosaic of the eval's
# season: only the first patch's window (rows 0-2047, cols 0-2047) holds
# this 32-pixel NaN tile, so exactly one patch takes the host feed
NAN_ROWS, NAN_COLS = slice(2, 6), slice(3, 7)
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
# no_fused_head: the eval with the head as four 1x1 convs against the
# fused run of the same dtype: the same products in another order (bf16:
# rounded after each layer, as in JAX's unfused head), so the maps agree to
# the dtype's precision; census r2 at the JAX package's bound for an eval
# that rounds differently (QUANT_R2_BOUND)
NO_FUSED_R2_BOUND = 0.02
# timeseries: the builtup map (a probability in [0, 1]) from kernels A and B
# in float32 (3xTF32 on the tensor cores) against the plain versions on the
# CPU, max abs
BUILTUP_ATOL = 1e-4
# dda: the CLI's learning rate (the JAX package's learning test uses 3e-3;
# at the default 1e-4 the loss of 3 short epochs need not fall), and the
# card's step against the CPU's from the same weights: float32 with TF32
# off on both sides, BatchNorm's backward subtracting batch means of the
# gradient (a cancellation), so gradients norm-relative 1e-3; updates as
# the train_step phase holds them, over the elements whose gradients agree
# in sign and exceed DDA_GRAD_FLOOR (100 Adam eps), the others (at most
# DDA_HELD_SHARE of them) moved by at most lr on both sides
DDA_LR = 1e-3
DDA_GRAD_RTOL = 1e-3
DDA_GRAD_FLOOR = 1e-6
DDA_HELD_SHARE = 0.05
# dist: the whole-frame eval's interior (beyond the stitched eval's
# 128-px ring) against the stitched eval of the same dtype
# (tests/test_spatial.py:158's bound); the builder in 512-row chunks and
# the member fold in 1024-row strips against the whole frame
# (tests/test_spatial.py:248); the builtup time series' whole frame against
# its patch path (tests/test_spatial.py:133); the two-rank rehearsal
# against one rank: loss, the stepped parameters (tests/test_spatial.py:
# 212-216, the JAX bounds for a sharded step) and the ensemble fold's sum;
# the two-rank evals' maps against the one-rank map
SPATIAL_INTERIOR = dict(rtol=2e-4, atol=2e-5)
STRIP_TOL = dict(rtol=1e-5, atol=1e-6)
BUILTUP_PATCH_TOL = dict(rtol=2e-5, atol=2e-6)
REHEARSAL_LOSS_RTOL, REHEARSAL_PARAMS = 1e-5, dict(rtol=1e-4, atol=1e-7)
RANKED_MAP_TOL = dict(rtol=1e-5, atol=1e-6)
RING = 128
KERNEL_REPS = 10
# device_ms: the most traces it takes to find one that holds every launch
TRACE_TRIES = 3
# the train phase's larger batch: its 6 weak samples of the seeded
# 2304x2560 region's 4x6 admin grid come in the buckets 2x1024x1024 and
# 2x512x256 (the train phase checks that this one is among them)
TRAIN_BUCKET = (2, 1024, 1024)
# steady train-step timing: each bucket shape is run once untimed (cuDNN
# plan selection, allocator growth), then STEP_REPS times
STEP_REPS = 5
# spatial_train: one seeded crop at the top of the bucket ladder (8.39M px,
# under limit1's 9M: the full-gradient tier) whose rows split over two
# ranks on cuda:0, SPATIAL_KEPT kept rows each; the model is the repo's DDA
# weights with a head seeded SPATIAL_HEAD_SEED, the sparsity mask drawn
# from SPATIAL_MASK_SEED. Float32 (TF32 off) against one rank at the
# rehearsal's bounds (REHEARSAL_*, the JAX test's for a row-sharded step):
# loss, popcount and every stepped parameter; beside them each gradient
# leaf norm-relative STEP_RTOL and each update norm-relative
# STEP_UPDATE_RTOL, as phase train_step holds the card to the CPU. The
# elementwise parameter bound is the fragile one: the reference's clip
# (0.01 of the global norm) leaves many gradient elements near Adam's eps
# (1e-8), where lr g / (|g| + eps) turns a float32 difference in the
# gradient into a share of lr, so the line reports how many parameters
# fall outside it. bf16 at the train_step phase's bounds (STEP_BF16_*).
# Each rank's step launches
# SPATIAL_LAUNCHES of the kernels: the builder's blocks in the dtype's
# mode, and the training head (float32 in both) once forward, once back.
SPATIAL_CROP = (1, 4096, 2048)
SPATIAL_KEPT = (1, 2048, 2048)
SPATIAL_HEAD_SEED, SPATIAL_MASK_SEED = 7, 11
SPATIAL_LAUNCHES = {
    "float32": {"double_conv": 6, "up_block": 4, "double_conv_bf16": 0, "up_block_bf16": 0,
                "head": 1, "head_bf16": 0, "head_bwd": 1},
    "bfloat16": {"double_conv": 0, "up_block": 0, "double_conv_bf16": 6, "up_block_bf16": 4,
                 "head": 1, "head_bf16": 0, "head_bwd": 1},
}


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


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def float_bounds(kernel: str, flops: float, nbytes: float) -> dict:
    """A float kernel's bounds: bound_ms at float32 accuracy on the tensor
    cores (TF32_PASSES dense TF32 passes), bound_fp32_ms on the CUDA
    cores, and the least operations time the summary adds up (ops_ms)."""
    b_ms, by = bound(TF32_PASSES * flops, nbytes, PEAK["tf32"])
    b32_ms, by32 = bound(flops, nbytes, PEAK["fp32"])
    return {"bound_ms": b_ms, "bound_by": by, "bound_fp32_ms": b32_ms, "bound_fp32_by": by32,
            "designed_against": DESIGNED_AGAINST[kernel],
            "ops_ms": TF32_PASSES * flops / PEAK["tf32"] * 1e3}


def dev_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    return e.self_device_time_total if hasattr(e, "self_device_time_total") else e.self_cuda_time_total


def device_ms(fn, function: str, reps: int = KERNEL_REPS):
    """The device time a call of ``function`` (a part of the kernel's name)
    takes, from a torch.profiler trace over ``reps`` warmed calls of
    ``fn``: the kernel alone, without the wrapper's host work and its small
    conversion kernels, which time_ms counts where the kernel is faster
    than the host. With ``function`` empty, every kernel and copy of the
    call. None if the trace holds no such kernel. The trace must hold every
    launch: ``function`` once a call, each kernel of an empty one a whole
    number of times a call: a trace that does not is taken again, at most
    TRACE_TRIES times in all. If every trace lost records of a named
    ``function`` (one kernel, launched once a call), the time is the mean
    of the launches the last trace holds, when it holds at least half of
    them, and a ``trace_loss`` line says how many; else it raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        # one profiling cycle, its events kept whole (acc_events)
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and function in e.key]
        if not mine:
            return None
        lost = {e.key[:80]: e.count for e in mine
                if (e.count != reps if function else e.count % reps)}
        if not lost:
            return sum(dev_us(e) for e in mine) / 1e3 / reps
    if function and len(mine) == 1 and reps // 2 <= mine[0].count < reps:
        emit({"phase": "trace_loss", "function": function, "calls": reps,
              "recorded": mine[0].count, "traces": TRACE_TRIES})
        return dev_us(mine[0]) / 1e3 / mine[0].count
    raise AssertionError(f"device_ms: {TRACE_TRIES} traces of {reps} calls each, the last with "
                         f"{lost} launches of {function or 'the call'}'s kernels")


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


def adam_step_agreement(ref_params, got_params, before) -> dict:
    """One Adam step of the same weights on two devices: each leaf's
    gradient norm-relative, and the updates norm-relative over the elements
    whose two gradients agree in sign and exceed DDA_GRAD_FLOOR. Adam moves
    an element by about lr * sign(g), so elsewhere (a rounding-level
    gradient, or a conv bias before a training-mode BatchNorm, whose
    gradient is zero in exact arithmetic) the moves may differ by up to 2
    lr: those elements are counted and their largest move is returned."""
    import torch

    from popcorn_tpu_torch.train.state import tree_flatten

    grad_rel = upd_rel = held_move = 0.0
    n_held = n_all = 0
    worst = None
    got_leaves = dict(tree_flatten(got_params))
    for path, ref_p in tree_flatten(ref_params):
        got_p = got_leaves[path]
        g_ref, g_got = ref_p.grad.cpu(), got_p.grad.cpu()
        u_ref = ref_p.detach().cpu() - before[path]
        u_got = got_p.detach().cpu() - before[path]
        pre_bn = path[-1] == "b" and path[-2] in ("conv1", "conv2")
        held = torch.ones_like(g_ref, dtype=torch.bool) if pre_bn else (
            (torch.sign(g_ref) != torch.sign(g_got)) | (g_ref.abs() <= DDA_GRAD_FLOOR))
        if bool(held.any()):
            held_move = max(held_move, float(u_ref[held].abs().max()), float(u_got[held].abs().max()))
        if pre_bn:
            continue
        n_held += int(held.sum())
        n_all += held.numel()
        rel = float((g_got - g_ref).norm() / g_ref.norm())
        if rel > grad_rel:
            grad_rel, worst = rel, ".".join(path)
        keep = ~held
        upd_rel = max(upd_rel, float((u_got[keep] - u_ref[keep]).norm() / u_ref[keep].norm()))
    return {"grad_max_norm_rel": grad_rel, "grad_worst_leaf": worst, "update_max_norm_rel": upd_rel,
            "held_elements": n_held, "elements": n_all, "held_max_move": held_move}


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


# The library yardstick of the int8 kernels E-H: each plain version with
# its integer products on torch._int_mm, PyTorch's int8 GEMM (int32 sums),
# convolutions as an im2col of nine shifted views of the codes with K
# zero-padded to a multiple of 8. Timed beside the kernels; the port never
# calls it.


def int_mm_conv3x3(xq, wq, same=True):
    """conv3x3_codes (nn/quant.py) through torch._int_mm, as float32."""
    import torch
    import torch.nn.functional as F

    if same:
        xq = F.pad(xq, (0, 0, 1, 1, 1, 1))
    n, hp, wp, cin = xq.shape
    h, w = hp - 2, wp - 2
    k = 9 * cin
    kp = -(-k // 8) * 8
    cols = torch.cat([xq[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)], -1)
    cols = F.pad(cols.reshape(-1, k), (0, kp - k))
    wm = F.pad(wq.reshape(k, -1), (0, 0, 0, kp - k))
    return torch._int_mm(cols, wm).reshape(n, h, w, -1).float()


def int_mm_tconv(x1q, wtq):
    """The transposed conv's integer sums (B, h, 2, w, 2, Cu) through
    torch._int_mm, as float32 (up_block_qs_plain's einsum)."""
    import torch

    b, h, w, c1 = x1q.shape
    acc = torch._int_mm(x1q.reshape(-1, c1), wtq.reshape(c1, -1)).float()
    return acc.reshape(b, h, w, 2, 2, -1).permute(0, 1, 3, 2, 4, 5)


def dc_qs_library(w1q, e1, g1, w2q, e2, g2, xq, float_out):
    """double_conv_qs_plain (kernel E) with torch._int_mm products."""
    import torch

    from popcorn_tpu_torch.nn.quant import requant

    y1q = requant(int_mm_conv3x3(xq, w1q), e1, g1, 0.0)
    acc2 = int_mm_conv3x3(y1q, w2q)
    if float_out:
        return torch.relu(acc2 * e2 + g2)
    return requant(acc2, e2, g2, 0.0)


def dc_q_library(w1q, d1, t1, w2q, d2, t2, x):
    """double_conv_q_plain (kernel G) with torch._int_mm products."""
    import torch

    from popcorn_tpu_torch.nn.quant import inside_tiles, quantize_tiles, tiles, untile

    b, h, w, _ = x.shape
    xq, sx = quantize_tiles(tiles(x.float(), 2))
    y1 = torch.relu(int_mm_conv3x3(xq, w1q, same=False) * (d1 * sx) + t1)
    y1 = torch.where(inside_tiles(b, h, w, 1, x.device), y1, 0.0)
    y1q, sy = quantize_tiles(y1)
    out = torch.relu(int_mm_conv3x3(y1q, w2q, same=False) * (d2 * sy) + t2)
    return untile(out, b, h, w)


def up_qs_library(wtq, et, gt, waq, ea, wbq, eb, g1, w2q, e2, g2, x1q, x2q, float_out):
    """up_block_qs_plain (kernel F) with torch._int_mm products."""
    import torch

    from popcorn_tpu_torch.nn.ops import pad_to_match
    from popcorn_tpu_torch.nn.quant import QMAX, requant

    b, h, w, _ = x1q.shape
    up = requant(int_mm_tconv(x1q, wtq), et[:, None], gt, -QMAX).reshape(b, 2 * h, 2 * w, wtq.shape[3])
    upq = pad_to_match(up, x2q)
    y1 = int_mm_conv3x3(x2q, waq) * ea + int_mm_conv3x3(upq, wbq) * eb
    y1q = torch.clamp(torch.round(y1 + g1), 0.0, QMAX).to(torch.int8)
    acc2 = int_mm_conv3x3(y1q, w2q)
    if float_out:
        return torch.relu(acc2 * e2 + g2)
    return requant(acc2, e2, g2, 0.0)


def up_q_library(wtq, dt, tt, waq, da, wbq, db, t1, w2q, d2, t2, x1, x2):
    """up_block_q_plain (kernel H) with torch._int_mm products."""
    import torch
    import torch.nn.functional as F

    from popcorn_tpu_torch.nn.quant import inside_tiles, quantize_tiles, tiles, untile

    b, hh, ww, _ = x2.shape
    _, h, w, _ = x1.shape
    oy, ox = (hh - 2 * h) // 2, (ww - 2 * w) // 2
    dev = x2.device
    x2q, s2x = quantize_tiles(tiles(x2.float(), 2))
    pad = (0, 0, ox, ww - 2 * w - ox, oy, hh - 2 * h - oy)
    src = x1.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    x1q, s1x = quantize_tiles(tiles(F.pad(src, pad), 2))
    tap = (torch.arange(2, device=dev)[:, None] * 2 + torch.arange(2, device=dev)[None, :]).float()
    tap = tap.repeat(h, w)[None, :, :, None]
    region = F.pad(torch.cat([tap + 1.0, torch.ones_like(tap)], dim=-1), pad)
    region = tiles(region, 2).repeat(b, 1, 1, 1)
    inside, tap = region[..., 1:] > 0, (region[..., 0] - 1.0).clamp_min(0).long()
    c1 = x1q.shape[-1]
    up_acc = torch.stack([torch._int_mm(x1q.reshape(-1, c1), wtq[:, k // 2, k % 2, :].contiguous())
                          .reshape(*x1q.shape[:3], -1).float() for k in range(4)], dim=-2)
    up_acc = up_acc.gather(-2, tap[..., None, None].expand(*tap.shape, 1, up_acc.shape[-1]))[..., 0, :]
    up = up_acc * (dt.reshape(4, -1)[tap] * s1x) + tt
    upq, su = quantize_tiles(torch.where(inside, up, 0.0))
    acc_a = int_mm_conv3x3(x2q, waq, same=False)
    acc_b = int_mm_conv3x3(upq, wbq, same=False)
    y1 = torch.relu(acc_a * (da * s2x) + acc_b * (db * su) + t1)
    y1 = torch.where(inside_tiles(b, hh, ww, 1, dev), y1, 0.0)
    y1q, sy = quantize_tiles(y1)
    out = torch.relu(int_mm_conv3x3(y1q, w2q, same=False) * (d2 * sy) + t2)
    return untile(out, b, hh, ww)


def close_report(got, ref, rtol: float, atol: float) -> dict:
    """Max abs and max relative (to |ref|) difference, and whether
    |got - ref| <= atol + rtol |ref| holds everywhere."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    return {"max_abs": float(d.max()), "max_rel": float((d / np.maximum(np.abs(ref), 1e-30)).max()),
            "ok": bool((d <= atol + rtol * np.abs(ref)).all())}


def ranked_eval(data: str, members: list, flags: list, out: str, n_data: int,
                n_ensemble: int) -> None:
    """One of two ranks sharing cuda:0 over gloo (dist/launch.py spawns
    them): the Evaluator of the eval CLI's command line (its default
    dtype) with the patches over ``n_data`` ranks and the members over
    ``n_ensemble``, writing its products next to ``members`` (rank 0
    only). Every rank writes its wall time, kernel launches, output folder
    and census metric count to ``out``.rank<r>.json."""
    import torch

    from popcorn_tpu_torch.cli.args import eval_config_from_args, eval_parser, model_config_from_args
    from popcorn_tpu_torch.config import DataPaths
    from popcorn_tpu_torch.dist.mesh import make_mesh
    from popcorn_tpu_torch.infer.evaluator import Evaluator
    from popcorn_tpu_torch.nn import double_conv as A
    from popcorn_tpu_torch.nn import head as C
    from popcorn_tpu_torch.nn import up_block as B

    mesh = make_mesh(n_data, devices=["cuda:0"] * 2, n_ensemble=n_ensemble)
    a = eval_parser().parse_args(["--data_root", data, *flags, "-r", *members])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = Evaluator(DataPaths(data), model_config_from_args(a), eval_config_from_args(a), mesh=mesh)
    stats = ev.test_target(save=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(f"{out}.rank{mesh.rank}.json", "w") as f:
        json.dump({"rank": mesh.rank, "backend": mesh.backend, "wall_s": wall,
                   "folder": ev.experiment_folder, "n_metrics": len(stats),
                   "writes": ev.logger is not None,
                   "launches": {"double_conv_bf16": A.launches_bf16, "up_block_bf16": B.launches_bf16,
                                "head_bf16": C.launches_bf16, "double_conv": A.launches,
                                "up_block": B.launches, "head": C.launches}}, f)


def train_losses_of(folder: str) -> list:
    """The logged optimization loss of every step of a training run (its
    metrics.jsonl)."""
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["optimization_loss/train"] for r in recs if "optimization_loss/train" in r]

def spatial_crop() -> dict:
    """The spatial_train phase's seeded batch: one SPATIAL_CROP crop with
    S2, S1, photometric values, a target and an admin mask of four census
    ids in regions with wavy borders, pad elsewhere; the sample is id 2."""
    import numpy as np

    b, h, w = SPATIAL_CROP
    rng = np.random.default_rng(SPATIAL_HEAD_SEED)
    yy, xx = np.mgrid[0:h, 0:w] / np.asarray([h, w], np.float32)[:, None, None]
    ids = 1 + (xx + 0.07 * np.sin(yy * 19.0) > 0.5) + 2 * (yy + 0.03 * np.cos(xx * 23.0) > 0.5)
    admin = np.where((xx - 0.83) ** 2 + ((yy - 0.07) * h / w) ** 2 < 0.01, -1, ids).astype(np.float32)
    return {
        "S2": rng.uniform(0, 4000, (b, h, w, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (b, h, w, 2)).astype(np.float32),
        "admin_mask": admin[None].repeat(b, 0),
        "census_idx": np.full((b,), 2.0, np.float32),
        "y": np.full((b,), 2.0e4, np.float32),
        "photometric": np.asarray([1.0, 0.9, 1.0, 1.1], np.float32),
    }


def spatial_train_steps(mesh, dev) -> dict:
    """The spatial_train phase's step on ``mesh``'s rows of spatial_crop()
    (None: the plain step of one rank), in float32 and in bf16: each run
    once checked, with its kernel launches counted, and once timed. By
    dtype: loss, popcount, the gradients summed over the ranks and the
    stepped parameters (on the host), the timed step's ms, the checked
    step's peak device memory and launches."""
    import numpy as np
    import torch

    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda, to_torch
    from popcorn_tpu_torch.config import ModelConfig, TrainConfig
    from popcorn_tpu_torch.data.normalize import NormStats
    from popcorn_tpu_torch.dist.mesh import shard_batch_spatial
    from popcorn_tpu_torch.nn import double_conv as A
    from popcorn_tpu_torch.nn import head as C
    from popcorn_tpu_torch.nn import up_block as B
    from popcorn_tpu_torch.train import state as train_state
    from popcorn_tpu_torch.train.trainer import ROW_KEYS

    counters = {"double_conv": (A, "launches"), "up_block": (B, "launches"),
                "double_conv_bf16": (A, "launches_bf16"), "up_block_bf16": (B, "launches_bf16"),
                "head": (C, "launches"), "head_bf16": (C, "launches_bf16"),
                "head_bwd": (C, "bwd_launches")}
    tcfg = TrainConfig()
    host = shard_batch_spatial(spatial_crop(), mesh, row_keys=ROW_KEYS)
    batch = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
             for k, v in host.items()}
    out = {"row_block": host.get("row_block")}
    for cdt in ("float32", "bfloat16"):
        mcfg = ModelConfig(biasinit=0.9407, compute_dtype=cdt)
        params, consts = load_popcorn_from_dda(mcfg, head_seed=SPATIAL_HEAD_SEED)
        p = to_torch(params, dev)
        step = train_state.make_train_step(mcfg, tcfg, to_torch(consts, dev), NormStats(device=dev),
                                           train_state.make_optimizer(tcfg), mesh=mesh)

        def run():
            grads, aux = step.grads(p, batch, torch.Generator().manual_seed(SPATIAL_MASK_SEED))
            if step.mesh is not None:
                grads = step.reduce_grads(grads)
            new, _ = step.optimizer.update(grads, step.optimizer.init(p), p)
            return grads, aux, new

        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        grads, aux, new = run()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        rec = {"loss": float(aux["optimization_loss"]), "popcount": aux["popcount"].cpu().numpy(),
               "grads": {k: v.cpu() for k, v in train_state.tree_flatten(grads)},
               "params": {k: v.cpu() for k, v in train_state.tree_flatten(new)},
               "peak_mem_bytes": peak, "launches": launches}
        del grads, aux, new
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        out[cdt] = rec
        del step, p
        torch.cuda.empty_cache()
    return out


def spatial_train_rank(out: str) -> None:
    """One of two ranks sharing cuda:0 over gloo (dist/launch.py spawns
    them): spatial_train_steps on this rank's rows, saved to
    ``out``.rank<r>.pt."""
    import torch

    from popcorn_tpu_torch.dist.mesh import make_mesh

    mesh = make_mesh(2, devices=["cuda:0"] * 2)
    rec = spatial_train_steps(mesh, mesh.device)
    rec["backend"] = mesh.backend
    torch.save(rec, f"{out}.rank{mesh.rank}.pt")


def spatial_train_cli(argv: list, out: str) -> None:
    """One of two ranks sharing cuda:0 over gloo: the train CLI's command
    line ``argv`` (with --spatial_train) through its Trainer on the two
    ranks' grid, as the CLI's own ranks build it on two cards. Every rank
    writes its wall time, experiment folder, whether it writes, and its
    kernel launches to ``out``.rank<r>.json."""
    import torch

    from popcorn_tpu_torch.cli.args import model_config_from_args, train_config_from_args, train_parser
    from popcorn_tpu_torch.config import DataPaths
    from popcorn_tpu_torch.dist.mesh import make_mesh
    from popcorn_tpu_torch.nn import double_conv as A
    from popcorn_tpu_torch.nn import head as C
    from popcorn_tpu_torch.nn import up_block as B
    from popcorn_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(2, devices=["cuda:0"] * 2)
    a = train_parser().parse_args(argv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = Trainer(DataPaths(a.data_root), model_config_from_args(a), train_config_from_args(a),
                      device=a.device, mesh=mesh)
    trainer.train()
    torch.cuda.synchronize()
    with open(f"{out}.rank{mesh.rank}.json", "w") as f:
        json.dump({"rank": mesh.rank, "backend": mesh.backend, "wall_s": time.perf_counter() - t0,
                   "folder": trainer.experiment_folder, "writes": trainer.is_root,
                   "feed": trainer.feed_choice,
                   "launches": {"double_conv_bf16": A.launches_bf16, "up_block_bf16": B.launches_bf16,
                                "head": C.launches, "head_bwd": C.bwd_launches}}, f)


# prep: the tool-built region's tiles, a grid of PREP_TILES row x column
# bands of unequal sizes (the raw tiles a download leaves)
PREP_TILES = (2, 3)


def run_tool(name: str, *args) -> float:
    """``python -m popcorn_tpu_torch.tools.<name> args`` as a user runs it,
    from the checkout's root; returns its wall seconds. Raises with the
    tool's output when it exits non-zero."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"popcorn_tpu_torch.tools.{name}", *args], cwd=HERE,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise AssertionError(f"tools.{name} {list(args)} exited {r.returncode}:\n{r.stdout[-4000:]}")
    return time.perf_counter() - t0


def bits(a):
    """The array's bytes as unsigned integers of its width: equal bits, NaNs
    included."""
    import numpy as np

    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool((bits(a) == bits(b)).all())


def admin_layers(data: str, out: str) -> dict:
    """Phase prep, step 1: each admin level of the synthetic region ``data``
    (its census rows' rectangles, data/synthetic.py) as GeoJSON polygons in
    world coordinates through the S2 mosaic's transform, on whole pixel
    edges, with a census CSV keyed by ADM. Returns {level: (geojson, csv,
    the tool's level name)}. The first rectangle is rasterized alone first
    (geo/rasterize.py::rasterize_polygon) and must fill exactly its pixels."""
    import numpy as np
    import pandas as pd

    from popcorn_tpu_torch.config import DATALOCATIONS, SEASONS, DataPaths
    from popcorn_tpu_torch.data.dataset import parse_bbox
    from popcorn_tpu_torch.geo.rasterize import rasterize_polygon
    from popcorn_tpu_torch.io.geotiff import GeoTIFF

    paths = DataPaths(data)
    with GeoTIFF(paths.modality_path("rwa", "S2", SEASONS[0])) as g:
        ox, pw, _, oy, _, ph = g.transform
        shape = g.shape
    os.makedirs(out, exist_ok=True)
    layers = {}
    for level, files in DATALOCATIONS["rwa"].items():
        census = pd.read_csv(paths.census_path("rwa", level))
        feats = []
        for row in census.itertuples():
            r0, r1, c0, c1 = parse_bbox(row.bbox)
            if row.count != (r1 - r0) * (c1 - c0):
                raise AssertionError(f"{level} region {row.idx} is not its bbox's rectangle")
            ring = [[ox + c * pw, oy + r * ph] for r, c in ((r0, c0), (r0, c1), (r1, c1), (r1, c0), (r0, c0))]
            feats.append({"type": "Feature", "properties": {"ADM": f"R{row.idx}"},
                          "geometry": {"type": "Polygon", "coordinates": [ring]}})
        if not layers:
            rings = [np.asarray(feats[0]["geometry"]["coordinates"][0], np.float64)]
            r0, r1, c0, c1 = parse_bbox(census.bbox[0])
            want = np.zeros(shape, bool)
            want[r0:r1, c0:c1] = True
            got = rasterize_polygon(rings, shape, (ox, pw, oy, ph))
            if not np.array_equal(got, want):
                raise AssertionError(f"region {census.idx[0]}: the rasterized rectangle fills "
                                     f"{int(got.sum())} pixels, {int((got != want).sum())} of "
                                     "them off its bbox")
        gj, csv = os.path.join(out, f"adm_{level}.geojson"), os.path.join(out, f"census_{level}.csv")
        with open(gj, "w") as f:
            json.dump({"type": "FeatureCollection", "features": feats}, f)
        pd.DataFrame({"ADM": [f"R{i}" for i in census.idx], "POP20": census.POP20}).to_csv(csv, index=False)
        tool_level = files["boundary"][len("boundaries_"):-len(".tif")]
        layers[level] = (gj, csv, tool_level)
    return layers


def cut_tiles(data: str, prep: str) -> int:
    """Phase prep, step 3: each season mosaic of ``data`` cut into
    PREP_TILES raw tiles under ``prep``'s raw_tile_dir, in its dtype (S2
    uint16, S1 float32 with its NaN nodata) and georeferenced. Returns the
    number of tiles written."""
    import numpy as np

    from popcorn_tpu_torch.config import SEASONS, DataPaths
    from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff

    src, dst = DataPaths(data), DataPaths(prep)
    n = 0
    for season in SEASONS:
        for mod in ("S2", "S1"):
            with GeoTIFF(src.modality_path("rwa", mod, season)) as g:
                a = g.read(None, raw=True)
                ox, pw, _, oy, _, ph = g.transform
                nodata = g.nodata
            # band edges off the even split by 7 px a band
            rows, cols = ([0, *(n * i // k + 7 * i for i in range(1, k)), n]
                          for n, k in zip(a.shape[1:], PREP_TILES))
            tdir = dst.raw_tile_dir("rwa", mod, season)
            os.makedirs(tdir, exist_ok=True)
            for i in range(PREP_TILES[0]):
                for j in range(PREP_TILES[1]):
                    r0, r1, c0, c1 = rows[i], rows[i + 1], cols[j], cols[j + 1]
                    write_geotiff(os.path.join(tdir, f"tile_{i}_{j}.tif"), a[:, r0:r1, c0:c1],
                                  transform=(ox + c0 * pw, pw, oy + r0 * ph, -ph), nodata=nodata,
                                  dtype=a.dtype)
                    n += 1
    return n


def prep_region(data: str, tmp: str) -> tuple:
    """Phase prep, steps 1-4: a region built by the port's tools from the
    synthetic region ``data`` (its admin rectangles, census values and
    season mosaics), each tool run as a user runs it, with every product
    held to ``data``'s. Returns (the new data root, the phase record, the
    checks by name)."""
    import numpy as np
    import pandas as pd

    from popcorn_tpu_torch.config import SEASONS, DataPaths
    from popcorn_tpu_torch.data.dataset import parse_bbox
    from popcorn_tpu_torch.io import raster_cache
    from popcorn_tpu_torch.io.geotiff import GeoTIFF

    src = DataPaths(data)
    prep = os.path.join(tmp, "prep_data")
    dst = DataPaths(prep)
    secs, checks = {}, {}
    t0 = time.perf_counter()
    layers = admin_layers(data, os.path.join(tmp, "prep_inputs"))
    secs["layers"] = time.perf_counter() - t0
    template = src.modality_path("rwa", "S2", SEASONS[0])
    out_dir = os.path.dirname(dst.boundary_path("rwa", "coarse"))
    census_rows = {}
    for level, (gj, csv, tool_level) in layers.items():
        secs[f"preprocess_census_{level}"] = run_tool(
            "preprocess_census", "--boundaries", gj, "--census", csv, "--join-col", "ADM",
            "--pop-col", "POP20", "--template", template, "--out-dir", out_dir, "--level", tool_level)
        with GeoTIFF(dst.boundary_path("rwa", level)) as g:
            got, got_t = g.read(1, squeeze=True), g.transform
        with GeoTIFF(src.boundary_path("rwa", level)) as g:
            want, want_t = g.read(1, squeeze=True), g.transform
        checks[f"boundaries_{level}"] = same_bits(got, want) and got_t == want_t
        a = pd.read_csv(dst.census_path("rwa", level))
        b = pd.read_csv(src.census_path("rwa", level))
        checks[f"census_{level}"] = bool(
            list(a.idx) == list(b.idx) and list(a.POP20) == list(b.POP20)
            and list(a["count"]) == list(b["count"])
            and [parse_bbox(s) for s in a.bbox] == [parse_bbox(s) for s in b.bbox])
        census_rows[level] = len(a)
    t0 = time.perf_counter()
    n_tiles = cut_tiles(data, prep)
    secs["cut_tiles"] = time.perf_counter() - t0
    secs["merge_tiffs"] = run_tool("merge_tiffs", "--data_root", prep, "--region", "rwa")
    mosaics = [(mod, season) for season in SEASONS for mod in ("S2", "S1")]
    merged = {}
    for mod, season in mosaics:
        with GeoTIFF(dst.modality_path("rwa", mod, season)) as g:
            got, got_t = g.read(None, raw=True), g.transform
        with GeoTIFF(src.modality_path("rwa", mod, season)) as g:
            want, want_t = g.read(None, raw=True), g.transform
        merged[f"{mod}{season}"] = str(got.dtype)
        checks[f"merged_{mod}{season}"] = same_bits(got, want) and got_t == want_t
    secs["build_raster_cache"] = run_tool("build_raster_cache", "--data_root", prep, "--region", "rwa")
    for mod, season in mosaics:
        path = dst.modality_path("rwa", mod, season)
        mm = raster_cache.open_cache(path)
        with GeoTIFF(path) as g:
            direct = g.read(None, raw=True)
        checks[f"sidecar_{mod}{season}"] = mm is not None and same_bits(np.asarray(mm), direct)
    rec = {"region": list(want.shape[1:]), "levels": {
        level: {"tool_level": tl, "regions": census_rows[level]} for level, (_, _, tl) in layers.items()},
        "tiles": n_tiles, "mosaics": merged, "seconds": secs}
    return prep, rec, checks


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
    from popcorn_tpu_torch.utils.flops import device_peak_flops

    PEAK.update({k: device_peak_flops(dev, k) for k in ("fp32", "tf32", "bf16", "int8")})
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda, "peaks": PEAK,
    })
    if None in PEAK.values():
        raise SystemExit(f"chip_smoke: no published peaks for {torch.cuda.get_device_name(0)} "
                         "in popcorn_tpu_torch/utils/flops.py")

    # ----------------------------------------------------------------- 2. build
    from popcorn_tpu_torch.nn import cuda_lib
    from popcorn_tpu_torch.nn import double_conv as A
    from popcorn_tpu_torch.nn import head as C
    from popcorn_tpu_torch.nn import up_block as B

    secs = cuda_lib.build(force=True)
    emit({"phase": "build", "sources": list(cuda_lib.KERNEL_SOURCES), "seconds": round(secs, 3)})
    # registers, spills and shared memory of every kernel (ptxas -v), and
    # the tensor-core MMAs in the SASS of A-H (none of E-H's instructions a
    # __dp4a)
    for name in cuda_lib.KERNEL_SOURCES:
        rec = {"phase": "build_report", "source": name,
               "ptxas": cuda_lib.ptxas_usage(cuda_lib.build_logs[name])}
        if name in TENSOR_CORE_KERNELS:
            function, opcode = TENSOR_CORE_KERNELS[name]
            mma = cuda_lib.sass_count(name, opcode)
            rec[f"sass_{opcode.lower()}"] = mma
            mains = [v for f, v in mma.items() if function in f]
            bad = opcode not in ("HMMA", "IMMA") or not mains or min(mains) == 0
            if opcode in NO_TENSOR_CORE_OPCODE:
                other = NO_TENSOR_CORE_OPCODE[opcode]
                off = {f: v for f, v in cuda_lib.sass_count(name, other).items() if function in f}
                rec[f"sass_{other.lower().replace('.', '')}"] = off
                bad = bad or any(off.values())
            if bad:
                emit(rec)
                raise AssertionError(f"csrc/{name}.cu: a kernel holds no tensor-core MMA "
                                     f"({opcode}) or a __dp4a: {rec}")
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
                 for n in cuda_lib.KERNEL_SOURCES
                 if os.path.exists(os.path.join(ab_dir, f"{n}.cu"))}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {ab_dir}/{n}.cu:\n{log}")
            ab_libs[n] = ctypes.CDLL(os.path.join(out_dir, f"lib{n}.so"))
        emit({"phase": "ab_build", "dir": args.ab, "sources": list(ab_libs)})

    def ab_times(source, fn, function, parent_fn=None):
        """Wrapper and device times of ``fn`` with the other checkout's
        library of ``source`` and with this one's, in the order parent,
        change, change, parent: the wrappers find a library in cuda_lib's
        table of loaded ones, where the other one stands in for a timing.
        ``parent_fn`` runs in ``fn``'s place on the parent's side (a mode
        the parent's library lacks, through its nearest entry); the
        device time is then the sum of all the call's kernels."""
        own = cuda_lib.load(source)
        times = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            cuda_lib._libs[source] = ab_libs[source] if side == "parent" else own
            run = parent_fn if side == "parent" and parent_fn is not None else fn
            try:
                times[side].append((time_ms(run), device_ms(run, "" if parent_fn else function)))
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
                   peak=None, exact=False, ab_parent=None):
        """Hold the kernel against its plain version (int8 outputs bit for
        bit, and with ``exact`` any output; float ones at RTOL/ATOL, bf16
        at BF16_ULP), time both and the library call, and record the case.
        ``ab_parent``: what --ab times on the parent's side instead of
        ``kern_fn`` (ab_times)."""
        got = kern_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        torch.cuda.synchronize()
        if exact and got.dtype != torch.int8:
            n_diff = int((got != ref).sum()) if got.dtype == ref.dtype else -1
            if got.shape != ref.shape or n_diff:
                raise AssertionError(f"{name}: {n_diff} values differ from the plain version's "
                                     f"(or dtype {got.dtype} vs {ref.dtype})")
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
        source = kernel.replace("_bf16", "")
        ab = ab_times(source, kern_fn, function, ab_parent) if ab_libs else {}
        p_ms = time_ms(plain_fn)
        l_ms = time_ms(lib_fn)
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
        if exact:
            case["exact"] = True
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
                                     (x32.to(bf16), 2, "double_conv_bf16", PEAK["bf16"])):
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
            (x1_32.to(bf16), x2_32.to(bf16), 2, "up_block_bf16", PEAK["bf16"]),
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
    # and the training forward's 2 channels at the train bucket and at a
    # spatial rank's kept rows
    feats = rand(1, P, P, 16, relu=True)
    for x, n_out, mult, kernel, esz, peak in (
        (feats, 1, 1, "head", 4, None),
        (feats.to(bf16), 1, 1, "head_bf16", 2, PEAK["bf16"]),
        (rand(*TRAIN_BUCKET, 16, relu=True), 2, 0, "head", 4, None),
        (rand(*SPATIAL_KEPT, 16, relu=True), 2, 0, "head", 4, None),
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

    # kernel D: the head backward at the train phase's bucket, at a
    # 2x2048^2 step (8.4M px, under limit1's 9M: the full-gradient tier) and
    # at a spatial rank's kept rows of the spatial_train phase's crop
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
    for lead, mult in ((TRAIN_BUCKET, 1), ((2, P, P), 0), (SPATIAL_KEPT, 0)):
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
                   lambda: dc_qs_library(*a, xq, fo), ops, nb, PEAK["int8"], exact=True)
        return A.double_conv_qs_cuda(*a, xq, fo)

    def f_case(name, mult, stream, block, x1q, x2q, s_x1, s_x2, s_up, s_y1, s_out, odt=None):
        """Kernel F: int8 out (s_out), float32 features, or (odt bf16)
        bf16 features, which must be the plain version's float32 features
        rounded to bf16: the integer sums are exact and the epilogue
        rounds as the plain version, so the float features are equal bit
        for bit too."""
        p, bn = unet[stream][block], unet_bn[stream][block]
        a, fo = B.qs_args(p, bn, s_x1, s_x2, s_up, s_y1, s_out), s_out is None
        bf = odt == bf16
        ops, nb = up_cost(x1q, x2q, p, 1, (2 if bf else 4) if fo else 1)
        to = (lambda t: t.to(bf16)) if bf else (lambda t: t)
        check_case("up_block_qs_bf16" if bf else "up_block_qs", f"{name} {shape_name(x1q, x2q)}", mult,
                   lambda: B.up_block_qs_cuda(*a, x1q, x2q, fo, odt),
                   lambda: to(B.up_block_qs_plain(*a, x1q, x2q, fo)),
                   lambda: to(up_qs_library(*a, x1q, x2q, fo)), ops, nb, PEAK["int8"], exact=True,
                   ab_parent=(lambda: B.up_block_qs_cuda(*a, x1q, x2q, fo).to(bf16)) if bf else None)
        return B.up_block_qs_cuda(*a, x1q, x2q, fo, odt)

    def g_case(name, mult, stream, block, x):
        """Kernel G in float32, and in its bf16 mode on the same input
        rounded to bf16, held to the plain version's float32 output
        rounded to bf16 at BF16_ULP (float32 outputs at RTOL/ATOL)."""
        p, bn = unet[stream][block], unet_bn[stream][block]
        a = A.q_args(p, bn)
        for xm, esz, kernel in ((x, 4, "double_conv_q"), (x.to(bf16), 2, "double_conv_q_bf16")):
            ops, nb = dc_cost(xm, p, esz, esz)
            to = (lambda t: t.to(xm.dtype))
            check_case(kernel, f"{name} {shape_name(xm)}", mult,
                       lambda: A.double_conv_q_cuda(*a, xm), lambda: to(A.double_conv_q_plain(*a, xm.float())),
                       lambda: to(dc_q_library(*a, xm.float())), ops, nb, PEAK["int8"],
                       ab_parent=((lambda: A.double_conv_q_cuda(*a, xm.float()).to(bf16))
                                  if esz == 2 else None))

    def h_case(name, mult, stream, block, x1, x2):
        """Kernel H in float32, and in its bf16 mode on the same inputs
        rounded to bf16, held to the plain version's float32 output
        rounded to bf16 at BF16_ULP (float32 outputs at RTOL/ATOL, as PR
        3's kernel)."""
        p, bn = unet[stream][block], unet_bn[stream][block]
        a = B.q_args(p, bn)
        for x1m, x2m, esz, kernel in ((x1, x2, 4, "up_block_q"),
                                      (x1.to(bf16), x2.to(bf16), 2, "up_block_q_bf16")):
            ops, nb = up_cost(x1m, x2m, p, esz, esz)
            to = (lambda t: t.to(x2m.dtype))
            check_case(kernel, f"{name} {shape_name(x1m, x2m)}", mult,
                       lambda: B.up_block_q_cuda(*a, x1m, x2m),
                       lambda: to(B.up_block_q_plain(*a, x1m.float(), x2m.float())),
                       lambda: to(up_q_library(*a, x1m.float(), x2m.float())), ops, nb,
                       PEAK["int8"],
                       ab_parent=((lambda: B.up_block_q_cuda(*a, x1m.float(), x2m.float()).to(bf16))
                                  if esz == 2 else None))

    x6 = torch.randn(1, P, P, 6, device=dev, generator=g)
    xs, xo = x6[..., :2].contiguous(), x6[..., 2:].contiguous()
    s, so = (Q.calibrate_stream(unet[k], unet_bn[k], xx) for k, xx in (("sar", xs), ("opt", xo)))
    qx1 = e_case("inc_sar", 1, "sar", "inc", Q.quantize_static(xs, s["in"]), s["in"], s["inc_y1"], s["inc_out"])
    e_case("inc_opt", 1, "opt", "inc", Q.quantize_static(xo, so["in"]), so["in"], so["inc_y1"], so["inc_out"])
    qd1 = e_case("down1", 2, "sar", "down1", max_pool_2x2(qx1), s["inc_out"], s["down1_y1"], s["down1_out"])
    e_case("down1_w4a8", 0, "sar", "down1", max_pool_2x2(qx1), s["inc_out"], s["down1_y1"],
           s["down1_out"], wbits=4)
    # E's float32 output (a stream's last block; not on the eval's path)
    e_case("down1_float_out", 0, "sar", "down1", max_pool_2x2(qx1), s["inc_out"], s["down1_y1"], None)
    qd2 = e_case("down2", 2, "sar", "down2", max_pool_2x2(qd1), s["down1_out"], s["down2_y1"], s["down2_out"])
    qu2 = f_case("up2", 2, "sar", "up2", qd2, qd1, s["down2_out"], s["down1_out"], s["up2_up"],
                 s["up2_y1"], s["up2_out"])
    # up1's float features: bf16 on the eval's default path, float32 on
    # the int8s eval's at --compute_dtype float32
    f_case("up1_float_out", 2, "sar", "up1", qu2, qx1, s["up2_out"], s["inc_out"], s["up1_up"],
           s["up1_y1"], None)
    f_case("up1_bf16_out", 2, "sar", "up1", qu2, qx1, s["up2_out"], s["inc_out"], s["up1_up"],
           s["up1_y1"], None, bf16)
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

    # the optimizer update (csrc/adam.cu) over the DDA member's 62 trainable
    # leaves and a Prithvi-EO-2.0-300M member's 308, at the members'
    # defaults (clip 0.01, engaged), gradients shaped as the train step's (a
    # conv weight's the permuted OIHW tensor; every 4-dimensional leaf's
    # here); no TPU kernel: the JAX package leaves it to XLA (optax).
    # kernel_ms is the whole Optimizer.update with its host work, plain_ms
    # the plain chain (update_plain, the path before the kernel); device_ms
    # the norm's and the step's kernels, each launched once a call; the
    # bound is 32 bytes a parameter at the HBM rate (28 for the update, 4
    # for the norm's read of the gradients)
    from popcorn_tpu_torch.compat.weights import load_popcorn_from_dda
    from popcorn_tpu_torch.config import ModelConfig, TrainConfig
    from popcorn_tpu_torch.nn.init import init_prithvi_member
    from popcorn_tpu_torch.train import adam as ADAM
    from popcorn_tpu_torch.train import state as opt_state_mod

    def adam_case(member, mparams):
        mflat = opt_state_mod.tree_flatten(mparams)
        mgrads = opt_state_mod.tree_unflatten(
            (q, (rand(v.shape[3], v.shape[2], v.shape[0], v.shape[1]).permute(2, 3, 1, 0)
                 if v.dim() == 4 else rand(*v.shape))) for q, v in mflat)
        opt = opt_state_mod.make_optimizer(TrainConfig())
        ostate = opt.init(mparams)
        got_p, got_s = opt.update(mgrads, ostate, mparams)
        ref_p, ref_s = opt.update_plain(mgrads, ostate, mparams)
        torch.cuda.synchronize()

        def flat_of(tree):
            return [v for _, v in opt_state_mod.tree_flatten(tree)]

        adam_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                       for t, r in ((got_s["mu"], ref_s["mu"]), (got_s["nu"], ref_s["nu"]))
                       for a, b in zip(flat_of(t), flat_of(r)) if b.any())
        # the parameters at rtol 1e-5 and 1e-5 of a step absolute
        step_err = max(float(((a - b).abs() - 1e-5 * b.abs()).max())
                       for a, b in zip(flat_of(got_p), flat_of(ref_p)))
        n_par = sum(v.numel() for _, v in mflat)
        if not (adam_err <= 1e-5 and step_err <= 1e-5 * opt.learning_rate):
            raise AssertionError(f"adam ({member}): the kernel disagrees with the plain chain: "
                                 f"moments {adam_err}, params {step_err}")
        del got_p, got_s, ref_p, ref_s

        def adam_run():
            return opt.update(mgrads, ostate, mparams)

        launches_before = ADAM.launches
        k_ms = time_ms(adam_run)
        if ADAM.launches - launches_before != KERNEL_REPS + 2:
            raise AssertionError(f"adam: {ADAM.launches - launches_before} launches in "
                                 f"{KERNEL_REPS + 2} updates")
        t0 = time.perf_counter()
        for _ in range(KERNEL_REPS):
            adam_run()
        host_ms = (time.perf_counter() - t0) * 1e3 / KERNEL_REPS
        torch.cuda.synchronize()
        # each kernel's device time; device_ms raises unless the trace holds
        # each once a call
        norm_ms = device_ms(adam_run, "adam_norm_partial")
        step_ms = device_ms(adam_run, "adam_grid_step")
        p_ms = time_ms(lambda: opt.update_plain(mgrads, ostate, mparams))
        nbytes = 32.0 * n_par
        b_ms, by = bound(0.0, nbytes, PEAK["fp32"])
        lay = opt.kernel.layout
        case = {"phase": "kernel", "kernel": "adam", "case": f"{member} {len(mflat)} leaves {n_par}",
                "per_member_calls": 0, "moments_max_rel_err": adam_err, "max_abs_err": step_err,
                "kernel_ms": k_ms, "host_issue_ms": host_ms,
                "device_ms": None if None in (norm_ms, step_ms) else norm_ms + step_ms,
                "norm_device_ms": norm_ms, "step_device_ms": step_ms, "plain_ms": p_ms,
                "library_ms": None, "bound_ms": b_ms, "bound_by": by, "mbytes": nbytes / 1e6,
                "chunk": lay.chunk, "blocks": -(-lay.total // lay.chunk), "launches_a_call": 2}
        emit(case)
        cases.append(case)
        del mparams, mgrads, ostate
        torch.cuda.empty_cache()

    adam_case("member", to_torch(load_popcorn_from_dda(ModelConfig(biasinit=0.9407),
                                                       head_seed=1)[0], dev))
    adam_case("prithvi_eo2_300m member",
              init_prithvi_member(1, ModelConfig(feature_extractor="prithvi_eo2_300m",
                                                 biasinit=0.9407), dev)[0])
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
                    "up_block_qs_bf16": (B, "launches_qs_bf16"),
                    "double_conv_q": (A, "launches_q"), "double_conv_q_bf16": (A, "launches_q_bf16"),
                    "up_block_q": (B, "launches_q"), "up_block_q_bf16": (B, "launches_q_bf16")}

        def reset_launches():
            for mod, attr in counters.values():
                setattr(mod, attr, 0)

        def read_launches():
            return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

        n_patches = 4  # patch grid of a 2304x2560 region at 2048/128

        def run_eval(tag, extra=(), want=None, config=None, timings=None, units=n_patches,
                     root=data):
            """One eval of the 5 members on the region at ``root``, from a
            folder of links to them where it writes its outputs: through the
            eval CLI with the ``extra`` flags, or through the Evaluator with
            ``config`` (a function of the CLI's ModelConfig). Launch counts
            are checked against ``want`` per patch (per ``units``: the
            whole-frame eval has one a season); ``timings`` receives the
            sliding window's split. Returns the stats, wall seconds,
            launches and the output folder's glob."""
            from popcorn_tpu_torch.cli.args import eval_config_from_args, eval_parser, model_config_from_args
            from popcorn_tpu_torch.config import DataPaths
            from popcorn_tpu_torch.infer.evaluator import Evaluator

            mdir = os.path.join(tmp, tag)
            os.makedirs(mdir)
            links = []
            for m in members:
                links.append(os.path.join(mdir, os.path.basename(m)))
                os.symlink(m, links[-1])
            argv = ["--data_root", root, *eval_flags, "-r", *links, *extra]
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if config is None:
                out = eval_cli.main(argv, timings=timings)
            else:
                a = eval_parser().parse_args(argv)
                out = Evaluator(DataPaths(root), config(model_config_from_args(a)),
                                eval_config_from_args(a), device=dev).test_target(
                                    save=True, timings=timings)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got_l = read_launches()
            want_l = {k: want.get(k, 0) * units for k in counters}
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

        # the feeds: the runs above took the device-resident season mosaics
        # (the default with a device stitch); the same bf16 eval through the
        # host patch feed, then with --transport bf16, then with NaNs in one
        # S1 window (the NaN hybrid: one patch through the host feed)
        import shutil

        from popcorn_tpu_torch.config import SEASONS, DataPaths
        from popcorn_tpu_torch.io.geotiff import write_geotiff

        split_hf, split_b16, split_nan = {}, {}, {}
        stats_hf, wall_hf, _, glob_hf = run_eval("main_host_feed", ("--device_feed", "off"),
                                                 MAIN_LAUNCHES, timings=split_hf)
        feed_diff = {}
        for tag in ("", "STD", "SCALE_rwa", "SCALE_STD", "ADJ_rwa"):
            a_h, a_d = read_map(glob_hf, tag), read_map(main_glob, tag)
            feed_diff[tag or "map"] = float(np.abs(a_h - a_d).max() / max(np.abs(a_d).max(), 1e-30))
        feed_stat_diff = max(abs(stats_hf[k] - stats[k]) for k in stats)
        stats_b16, wall_b16, _, _ = run_eval("main_transport_bf16", ("--transport", "bf16"),
                                             MAIN_LAUNCHES, timings=split_b16)
        b16_deltas = {k: stats_b16[k] - stats[k] for k in stats if k.endswith("/r2")}
        s1_path = DataPaths(data).modality_path("rwa", "S1", SEASONS[0])
        backup = os.path.join(tmp, "s1_backup.tif")
        shutil.copy(s1_path, backup)
        with GeoTIFF(s1_path) as gt:
            s1 = gt.read()
        s1[:, NAN_ROWS, NAN_COLS] = np.nan
        write_geotiff(s1_path, s1, template=backup)
        try:
            stats_nan, wall_nan, _, _ = run_eval("main_nan_hybrid", want=MAIN_LAUNCHES,
                                                 timings=split_nan)
        finally:
            shutil.copy(backup, s1_path)
        t_dev, t_host, t_nan = split["rwa"], split_hf["rwa"], split_nan["rwa"]
        emit({
            "phase": "feeds", "patches": n_patches,
            "device_feed": {"wall_s": wall, "timings": t_dev},
            "host_feed": {"wall_s": wall_hf, "timings": t_host, "max_rel_diff": feed_diff,
                          "census_max_abs_diff": feed_stat_diff},
            "transport_bf16": {"wall_s": wall_b16, "timings": split_b16["rwa"],
                               "r2_deltas": b16_deltas, "r2_bound": TRANSPORT_R2_BOUND},
            "nan_hybrid": {"wall_s": wall_nan, "timings": t_nan,
                           "adj_coarse_r2": stats_nan["Population_AdjCensus_rwa_coarse/r2"]},
        })
        if not (all(feed_diff[k] == 0.0 for k in ("map", "STD", "SCALE_rwa", "SCALE_STD"))
                and feed_diff["ADJ_rwa"] <= STITCH_RTOL and feed_stat_diff <= STITCH_STAT_TOL):
            raise AssertionError(f"device feed vs host feed: map differences {feed_diff}, "
                                 f"census metrics differ by up to {feed_stat_diff}")
        if t_dev.get("n_device_patches") != n_patches or "n_device_patches" in t_host:
            raise AssertionError(f"feed choice: device-feed run {t_dev}, host-feed run {t_host}")
        if max(abs(d) for d in b16_deltas.values()) > TRANSPORT_R2_BOUND:
            raise AssertionError(f"--transport bf16: census r2 deltas {b16_deltas}")
        if not (t_nan["n_patches"] == n_patches and t_nan["n_device_patches"] == n_patches - 1):
            raise AssertionError(f"NaN hybrid: {t_nan}")

        # ---------------------------------------------------------------- 6. quant
        quant_launches, split_q, wall_q = {}, {}, {}
        for mode, want in QUANT_LAUNCHES.items():
            if mode == "int8+pallas_stream":
                # the JAX package has no CLI flag for it: the config through
                # the Evaluator, which runs run_sliding_inference with it
                stats_q, q_wall, got_l, folder_glob = run_eval(
                    f"quant_{mode}", want=want, timings=split_q.setdefault(mode, {}),
                    config=lambda c: dataclasses.replace(c, quantize="int8", pallas_stream=True))
            else:
                quant, _, cdt = mode.partition("_")
                extra = (() if mode == "unquantized" else ("--quantize", quant)) + (
                    ("--compute_dtype", cdt) if cdt else ())
                stats_q, q_wall, got_l, folder_glob = run_eval(
                    f"quant_{mode}", extra, want, timings=split_q.setdefault(mode, {}))
            quant_launches[mode], wall_q[mode] = got_l, q_wall
            q_r2 = stats_q["Population_AdjCensus_rwa_coarse/r2"]
            deltas = {k: stats_q[k] - stats[k] for k in stats if k.endswith("/r2")}
            q_map = read_map(folder_glob)
            corr = float(np.corrcoef(main_map.ravel(), q_map.ravel())[0, 1])
            emit({
                "phase": "quant", "mode": mode, "patches": n_patches,
                "compute_dtype": "float32" if mode.endswith("float32") else "bfloat16",
                "wall_s": q_wall, "patches_per_s": n_patches / q_wall, "main_wall_s": wall,
                "main_patches_per_s": n_patches / wall, "launches": got_l,
                "r2_deltas": deltas, "r2_bound": QUANT_R2_BOUND, "map_corr": corr,
                "map_corr_min": QUANT_MAP_CORR, "adj_coarse_r2": q_r2,
                "timings": split_q[mode]["rwa"],
            })
            if max(abs(d) for d in deltas.values()) > QUANT_R2_BOUND or not corr >= QUANT_MAP_CORR:
                raise AssertionError(f"quant {mode}: census r2 deltas {deltas}, map correlation {corr}")

        # the two feeds again, warm: the quant phase's last (unquantized)
        # eval took the device feed; the host feed once more after it, so
        # the main phase's first (cold) device-feed run is bracketed
        split_hl = {}
        _, wall_hl, _, glob_hl = run_eval("host_feed_last", ("--device_feed", "off"),
                                          MAIN_LAUNCHES, timings=split_hl)
        same_hl = all(np.array_equal(read_map(glob_hl, tag), read_map(main_glob, tag))
                      for tag in ("", "STD", "SCALE_rwa", "SCALE_STD"))
        emit({"phase": "feeds_steady", "patches": n_patches,
              "device_feed": {"wall_s": wall_q["unquantized"], "timings": split_q["unquantized"]["rwa"]},
              "host_feed": {"wall_s": wall_hl, "timings": split_hl["rwa"]},
              "stitched_maps_equal": same_hl})
        if not same_hl:
            raise AssertionError("the last host-feed eval's stitched maps differ from the first's")

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
                before = (A.launches, B.launches, C.launches, C.bwd_launches, ADAM.launches)
                grads, aux = step.grads(p, tb, mask=mask.to(where), **flags)
                new_p, _ = step.optimizer.update(grads, step.optimizer.init(p), p)
                after = (A.launches, B.launches, C.launches, C.bwd_launches, ADAM.launches)
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
            # the builder (and the frozen blocks) through kernels A and B,
            # and the update as one call of adam.cu
            launched = dict(zip(("double_conv", "up_block", "head", "head_bwd", "adam"),
                                tier_launches))
            step_ok = (loss_rel <= STEP_RTOL and pc_rel <= STEP_RTOL
                       and grad_rel <= STEP_RTOL and upd_rel <= STEP_UPDATE_RTOL
                       and all(v > 0 for v in launched.values()) and launched["adam"] == 1)
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

        # the training feed: the CLI's run took the device-resident feed;
        # its epoch-0 batches against the host WeaksupFeed's, and the
        # season-rotating feed's samples against the host feed's (its
        # batches are grouped by season, so samples are compared, with no
        # augmentation, as tests/test_torch_device_weaksup.py does), all
        # fetched to the host and held bit for bit; then the cost gate's
        # probes on the card
        from popcorn_tpu_torch.data.device_weaksup import DeviceWeaksupFeed, resident_layout
        from popcorn_tpu_torch.data.feed import WeaksupFeed
        from popcorn_tpu_torch.data.feed_select import gate_report, gather_gate_inputs, prefer_rotation
        from popcorn_tpu_torch.infer.sliding import _upload

        if trainer.feed_choice != "resident":
            raise AssertionError(f"the train CLI took the {trainer.feed_choice} feed on the card")
        cpu = torch.device("cpu")

        def fetched(batch):
            """A batch as the step sees it, on the host: the host feed's
            arrays through the upload, the device feed's tensors fetched."""
            out = {}
            for k, v in batch.items():
                if isinstance(v, torch.Tensor) or k in ("S2", "S1", "VIIRS", "building_counts",
                                                        "building_segmentation", "admin_mask"):
                    out[k] = _upload(batch, cpu, (k,))[k].cpu()
                else:
                    out[k] = torch.from_numpy(np.asarray(v))
            return out

        def same_batch(a, b):
            a, b = fetched(a), fetched(b)
            return set(a) == set(b) and all(
                a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and torch.equal(a[k], b[k])
                for k in a)

        def timed_epoch(feed):
            t = time.perf_counter()
            out = list(feed.epoch(0))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        kw = trainer.feed_kw
        dev_b, dev_s = timed_epoch(trainer.feed)
        host_b, host_s = timed_epoch(WeaksupFeed(trainer.train_datasets, **kw))
        feed_ok = len(dev_b) == len(host_b) > 0 and all(map(same_batch, host_b, dev_b))
        plain = {**kw, "augment": False, "drop_last": False}

        def samples(batches):
            out = {}
            for b in map(fetched, batches):
                for i in range(len(b["census_idx"])):
                    out[(float(b["census_idx"][i]), int(b["season"][i]))] = [
                        b[k][i] for k in ("S2", "S1", "admin_mask", "y")]
            return out

        rot_feed = DeviceWeaksupFeed(trainer.train_datasets, rotate=True, device=dev, **plain)
        rot_b, rot_s = timed_epoch(rot_feed)
        rs, hs = samples(rot_b), samples(list(WeaksupFeed(trainer.train_datasets, **plain).epoch(0)))
        rot_ok = rs.keys() == hs.keys() and len(hs) > 0 and all(
            a.dtype == b.dtype and torch.equal(a, b) for k in hs for a, b in zip(hs[k], rs[k]))
        lay = resident_layout(trainer.train_datasets, kw["bucket_ladder"], kw["transport"])
        gate = gather_gate_inputs(WeaksupFeed(trainer.train_datasets, **kw),
                                  n_samples=len(trainer.feed.index),
                                  swap_bytes=lay["slice_bytes"] * len(lay["seasons"]), device=dev)
        emit({"phase": "train_feed", "feed": trainer.feed_choice, "batches": len(dev_b),
              "parity": feed_ok, "epoch_s": dev_s, "host_epoch_s": host_s,
              "rotating": {"samples": len(rs), "parity": rot_ok, "epoch_s": rot_s},
              "resident_bytes": lay["need_full"], "gate_report": gate_report(gate),
              "gate_prefers_rotation": prefer_rotation(gate),
              "link_bytes_per_s": gate.link_bytes_per_s, "host_items_per_s": gate.host_items_per_s})
        if not (feed_ok and rot_ok):
            raise AssertionError(f"training feed parity: resident {feed_ok}, rotating {rot_ok}")
        del dev_b, host_b, rot_b, rot_feed, rs, hs

        # steady step times on the epoch's own batches: the feed is seeded,
        # so epoch 0 yields them again; a plain loop over the trainer's
        # step, each bucket shape run once untimed, then STEP_REPS times
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

        # ------------------------------------------------------ 9. no_fused_head
        # the head as four 1x1 convs (--no_fused_head): the 5-member eval at
        # bf16 and at float32, each launching A and B as the main phase does
        # and C not at all, its map held to the fused run of its dtype; then
        # the train CLI, which launches neither C nor D
        t_phase = time.perf_counter()
        no_head = {k: v for k, v in MAIN_LAUNCHES.items() if not k.startswith("head")}
        nf_runs = {}
        for cdt, ref_glob, ref_stats, want in (
                ("bfloat16", main_glob, stats, no_head),
                ("float32", glob32, stats32, {k.replace("_bf16", ""): v for k, v in no_head.items()})):
            extra = ("--no_fused_head",) + (("--compute_dtype", cdt) if cdt == "float32" else ())
            split_nf = {}
            st_nf, wall_nf, got_l, glob_nf = run_eval(f"no_fused_head_{cdt}", extra, want,
                                                      timings=split_nf)
            corr = float(np.corrcoef(read_map(ref_glob).ravel(), read_map(glob_nf).ravel())[0, 1])
            deltas = {k: st_nf[k] - ref_stats[k] for k in ref_stats if k.endswith("/r2")}
            nf_runs[cdt] = {"wall_s": wall_nf, "launches": got_l, "map_corr": corr,
                            "r2_deltas": deltas, "timings": split_nf["rwa"]}
            if not corr >= DTYPE_MAP_CORR or max(abs(d) for d in deltas.values()) > NO_FUSED_R2_BOUND:
                raise AssertionError(f"--no_fused_head at {cdt}: map correlation {corr}, "
                                     f"census r2 deltas {deltas}")
        # one member's head at a 2048^2 patch: kernel C against the four
        # 1x1 convs, in each dtype (CUDA events, KERNEL_REPS calls)
        nf_head = {}
        feats = torch.randn((1, P, P, 16), device=dev)
        head_p = to_torch(init_head(0, biasinit=0.9407), dev)
        with torch.no_grad():
            for cdt, tdt in (("bfloat16", torch.bfloat16), ("float32", None)):
                fx = feats.to(tdt) if tdt is not None else feats
                nf_head[cdt] = {"kernel_c_ms": time_ms(lambda: C.head_apply(head_p, fx, n_out=1)),
                                "unfused_ms": time_ms(lambda: C.head_unfused(head_p, fx, tdt))}
        del feats, fx
        reset_launches()
        C.bwd_launches = 0
        t0 = time.perf_counter()
        trainer = train_cli.main([
            "--data_root", data, "-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa",
            "-occmodel", "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse",
            "-e", "1", "-mws", "6", "-lt", "1", "-w", "4", "--no_fused_head",
            "--save_dir", os.path.join(tmp, "outputs_no_fused_head"),
        ])
        torch.cuda.synchronize()
        nf_train_wall = time.perf_counter() - t0
        nf_train_launches = {**read_launches(), "head_bwd": C.bwd_launches}
        with open(os.path.join(trainer.experiment_folder, "metrics.jsonl")) as f:
            nf_losses = [r["optimization_loss/train"] for r in map(json.loads, f)
                         if "optimization_loss/train" in r]
        del trainer
        emit({"phase": "no_fused_head", "evals": nf_runs, "head_2048": nf_head,
              "map_corr_min": DTYPE_MAP_CORR,
              "r2_bound": NO_FUSED_R2_BOUND, "train": {"wall_s": nf_train_wall,
                                                       "launches": nf_train_launches,
                                                       "losses": nf_losses},
              "seconds": time.perf_counter() - t_phase})
        if (nf_train_launches["head"] or nf_train_launches["head_bf16"] or nf_train_launches["head_bwd"]
                or not nf_train_launches["double_conv_bf16"] or not nf_losses
                or not all(math.isfinite(v) for v in nf_losses)):
            raise AssertionError(f"--no_fused_head training: launches {nf_train_launches}, "
                                 f"losses {nf_losses}")

        # --------------------------------------------------------- 10. timeseries
        # builtup: dated frames on the region's season mosaics (S2, with S1 of
        # its season as the descending orbit and of the next season as the
        # ascending one) through the CLI at its 1024/64 patches, float32;
        # then population: two steps (the region above, seed 42, and a
        # second made from seed 43) through the CLI with the 5 members at
        # 2048/128 in the default bf16
        from popcorn_tpu_torch.cli import timeseries as ts_cli
        from popcorn_tpu_torch.data.dataset import PopulationDataset, patch_grid
        from popcorn_tpu_torch.infer import timeseries as ts
        from popcorn_tpu_torch.infer.evaluator import load_member
        from popcorn_tpu_torch.infer.sliding import run_sliding_inference

        t_phase = time.perf_counter()
        dp = DataPaths(data)
        dates = ("2023-03-20", "2023-06-21")
        spec = {"s2": [], "s1_desc": [], "s1_asc": []}
        for i, date in enumerate(dates):
            spec["s2"].append({"date": date, "path": dp.modality_path("rwa", "S2", SEASONS[i])})
            spec["s1_desc"].append({"date": date, "path": dp.modality_path("rwa", "S1", SEASONS[i])})
            spec["s1_asc"].append({"date": date, "path": dp.modality_path("rwa", "S1", SEASONS[i + 1])})
        frames_json = os.path.join(tmp, "frames.json")
        with open(frames_json, "w") as f:
            json.dump(spec, f)
        n_bu = len(patch_grid((2304, 2560), 1024, 64, fourseasons=False)) * 2 * len(dates)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = ts_cli.main(["builtup", "--frames", frames_json, "--out-dir", os.path.join(tmp, "builtup")])
        torch.cuda.synchronize()
        bu_wall = time.perf_counter() - t0
        bu_launches = read_launches()
        want_bu = {k: 0 for k in counters}
        want_bu.update(double_conv=6 * n_bu, up_block=4 * n_bu)
        if bu_launches != want_bu or len(written) != len(dates):
            raise AssertionError(f"builtup: launches {bu_launches}, expected {want_bu}; wrote {written}")
        # the first frame against the plain versions on the CPU, one orbit
        # at a time, and the written map against the card's orbit maps
        _, bconsts = load_popcorn_from_dda(mcfg)
        s2f = ts._read_frame(spec["s2"][0]["path"], (3, 2, 1, 4))
        orbit = {k: ts._read_frame(spec[k][0]["path"], (1, 2)) for k in ("s1_desc", "s1_asc")}
        t0 = time.perf_counter()
        cpu_desc = ts.builtup_map(bconsts, mcfg, s2f, orbit["s1_desc"], device="cpu")
        bu_cpu_s = time.perf_counter() - t0
        card = {k: ts.builtup_map(bconsts, mcfg, s2f, v, device=dev) for k, v in orbit.items()}
        with GeoTIFF(written[0]) as gt:
            bu_map = gt.read(1, squeeze=True)
        bu_err = float(np.abs(card["s1_desc"] - cpu_desc).max())
        bu_avg_err = float(np.abs(bu_map - (card["s1_desc"] + card["s1_asc"]) / 2.0).max())
        bu_rec = {"frames": len(dates), "orbits": 2, "patch": 1024, "overlap": 64,
                  "frame": [2304, 2560], "patches_per_frame": n_bu // (2 * len(dates)),
                  "wall_s": bu_wall, "launches": bu_launches, "cpu_max_abs_err": bu_err,
                  "cpu_bound": BUILTUP_ATOL, "cpu_one_orbit_s": bu_cpu_s,
                  "written_vs_orbit_mean_max_abs": bu_avg_err,
                  "map_range": [float(bu_map.min()), float(bu_map.max())]}
        if not (bu_err <= BUILTUP_ATOL and bu_avg_err <= 1e-6 and 0 <= bu_map.min()
                and bu_map.max() <= 1 and bool(np.isfinite(bu_map).all())):
            raise AssertionError(f"builtup maps: {bu_rec}")
        # one 1024^2 patch's score (1052^2 after the 14 px reflect pad)
        # warmed, and a profiler trace of it: A's and B's device ms a call
        score_fn = ts.make_score_fn(bconsts, mcfg, device=dev)
        crop = (s2f[:1024, :1024], orbit["s1_desc"][:1024, :1024])
        score_fn(*crop)
        t0 = time.perf_counter()
        for _ in range(KERNEL_REPS):
            score_fn(*crop)  # returns a host array: synchronised
        bu_rec["patch_ms"] = (time.perf_counter() - t0) * 1e3 / KERNEL_REPS
        bu_prof = profile_steps("builtup patch 1024^2 float32", lambda: score_fn(*crop),
                                bu_rec["patch_ms"])
        bu_prof["phase"] = "timeseries_profile"

        data43 = os.path.join(tmp, "data43")
        make_synthetic_region(data43, "rwa", height=2304, width=2560, n_regions=(4, 6), seed=43)
        steps = [{"label": "2023", "data_root": data, "region": "rwa"},
                 {"label": "2024", "data_root": data43, "region": "rwa"}]
        steps_json = os.path.join(tmp, "steps.json")
        with open(steps_json, "w") as f:
            json.dump(steps, f)
        pop_out = os.path.join(tmp, "pop_ts")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = ts_cli.main(["population", "--steps", steps_json, "--out-dir", pop_out,
                               *eval_flags, "-r", *members])
        torch.cuda.synchronize()
        pop_wall = time.perf_counter() - t0
        pop_launches = read_launches()
        want_pop = {k: MAIN_LAUNCHES.get(k, 0) * n_patches * len(steps) for k in counters}
        from popcorn_tpu_torch.cli.args import eval_parser, model_config_from_args

        pop_cfg = model_config_from_args(eval_parser().parse_args([*eval_flags, "-r", *members]))
        loaded = [load_member(m) for m in members]
        pop_equal = {}
        for s in steps:
            ds = PopulationDataset(DataPaths(s["data_root"]), "rwa", mode="test", patchsize=2048,
                                   overlap=128, fourseasons=False)
            ref = run_sliding_inference([m[0] for m in loaded], loaded[0][1], pop_cfg, ds, device=dev)
            ds.close()
            for key, tag in (("map", ""), ("map_std", "_STD")):
                with GeoTIFF(os.path.join(pop_out, f"rwa_predictions_{s['label']}{tag}.tif")) as gt:
                    pop_equal[f"{s['label']}{tag}"] = bool(np.array_equal(gt.read(1, squeeze=True), ref[key]))
        with open(os.path.join(pop_out, "totals.csv")) as f:
            totals_rows = f.read().splitlines()
        pop_rec = {"steps": len(steps), "patch": 2048, "overlap": 128, "members": 5,
                   "compute_dtype": "bfloat16", "wall_s": pop_wall, "launches": pop_launches,
                   "maps_equal_direct": pop_equal, "totals": records, "totals_csv": totals_rows}
        emit({"phase": "timeseries", "builtup": bu_rec, "population": pop_rec,
              "seconds": time.perf_counter() - t_phase})
        emit(bu_prof)
        if pop_launches != want_pop or not all(pop_equal.values()) or len(totals_rows) != 1 + len(steps) \
                or not all(math.isfinite(r["total_population"]) and r["total_population"] > 0
                           for r in records):
            raise AssertionError(f"population time series: launches {pop_launches} (expected "
                                 f"{want_pop}), maps equal {pop_equal}, totals {totals_rows}")
        del loaded, ref

        # ---------------------------------------------------------------- 11. dda
        # DDA extractor training through its CLI on a synthetic manifest of
        # 256^2 tiles, 8 labeled + 8 unlabeled a batch, 3 epochs; one step on
        # the card against the CPU from the same weights; the exported
        # extractor through create_building_score on the card
        from popcorn_tpu_torch.cli import dda_train
        from popcorn_tpu_torch.dda.datasets import labeled_unlabeled_batches, make_synthetic_dda_manifest
        from popcorn_tpu_torch.dda.train import DDAConfig, DDATrainer, normalize_dda_input
        from popcorn_tpu_torch.nn.popcorn import create_building_score

        t_phase = time.perf_counter()
        manifest = make_synthetic_dda_manifest(os.path.join(tmp, "dda"), n_labeled=32, n_unlabeled=8,
                                               size=256, seed=0)
        # held-out test sites for the CLI's per-site report: its morphology
        # metrics take about 6 s a 256^2 sample on the host (the Hausdorff
        # distance), so 4 tiles of 64^2
        test_manifest = make_synthetic_dda_manifest(os.path.join(tmp, "dda_test"), n_labeled=4,
                                                    n_unlabeled=0, size=64, seed=1)
        dda_out = os.path.join(tmp, "dda_extractor.pt")
        t0 = time.perf_counter()
        dtr = dda_train.main(["--manifest", manifest, "--epochs", "3", "--lr", str(DDA_LR),
                              "--out", dda_out, "--test", "--test-manifest", test_manifest])
        torch.cuda.synchronize()
        dda_wall = time.perf_counter() - t0
        dda_losses = list(dtr.epoch_losses)
        dda_eval = dtr.evaluate()
        del dtr
        # one step, card and CPU, from the same seeded weights and batch
        cfg1 = DDAConfig(labeled_per_batch=8, unlabeled_per_batch=8, lr=DDA_LR)
        ref_tr = DDATrainer(manifest, cfg1, device="cpu")
        init = (ref_tr.params, ref_tr.bn_params, ref_tr.bn_state)
        card_tr = DDATrainer(manifest, cfg1, device=dev, init=init)
        lab, unl = next(iter(labeled_unlabeled_batches(ref_tr.ds, np.random.default_rng(0),
                                                       labeled_per_batch=8, unlabeled_per_batch=8)))
        xl, yl, xu = normalize_dda_input(lab["x"]), lab["y"], normalize_dda_input(unl["x"])
        before = {k: v.detach().clone() for k, v in train_state.tree_flatten(ref_tr.params)}
        losses_1 = {}
        for name, trn in (("cpu", ref_tr), ("cuda", card_tr)):
            losses_1[name] = float(trn.step(trn._upload(xl), trn._upload(yl), trn._upload(xu)))
        step_rec = {"loss_cpu": losses_1["cpu"], "loss_cuda": losses_1["cuda"],
                    "loss_rel": abs(losses_1["cuda"] - losses_1["cpu"]) / abs(losses_1["cpu"]),
                    **adam_step_agreement(ref_tr.params, card_tr.params, before), "lr": DDA_LR}
        del ref_tr, card_tr
        # the exported extractor (the CLI's checkpoint) on the card
        bparams, bbn = load_dda(dda_out, dev)
        reset_launches()
        x_ex = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 512, 512, 6)).astype(np.float32)).to(dev)
        ex_score = create_building_score({"params": bparams, "bn": bbn}, x_ex, s1=True, s2=True, nir=True)
        torch.cuda.synchronize()
        ex_launches = {k: v for k, v in read_launches().items() if v}
        emit({"phase": "dda", "tiles": [32, 8], "tile": 256, "batch": [8, 8], "epochs": 3,
              "cli_wall_s": dda_wall, "epoch_losses": dda_losses, "eval": dda_eval, "step": step_rec,
              "step_bounds": {"loss_rtol": STEP_RTOL, "grad_norm_rtol": DDA_GRAD_RTOL,
                              "update_norm_rtol": STEP_UPDATE_RTOL, "grad_floor": DDA_GRAD_FLOOR,
                              "held_share": DDA_HELD_SHARE},
              "export": {"launches": ex_launches, "score_range": [float(ex_score.min()),
                                                                   float(ex_score.max())]},
              "seconds": time.perf_counter() - t_phase})
        if not (len(dda_losses) == 3 and all(math.isfinite(v) for v in dda_losses)
                and dda_losses[-1] < dda_losses[0]):
            raise AssertionError(f"DDA training: epoch losses {dda_losses}")
        if not (step_rec["loss_rel"] <= STEP_RTOL and step_rec["grad_max_norm_rel"] <= DDA_GRAD_RTOL
                and step_rec["update_max_norm_rel"] <= STEP_UPDATE_RTOL
                and step_rec["held_max_move"] <= DDA_LR * 1.01
                and step_rec["held_elements"] <= DDA_HELD_SHARE * step_rec["elements"]):
            raise AssertionError(f"DDA step on the card against the CPU: {step_rec}")
        if ex_launches != {"double_conv": 6, "up_block": 4} or not bool(
                torch.isfinite(ex_score).all() and (ex_score >= 0).all() and (ex_score <= 1).all()):
            raise AssertionError(f"exported DDA extractor: launches {ex_launches}")
        del bparams, bbn, x_ex, ex_score
        torch.cuda.empty_cache()

        # ---------------------------------------------------------------- 12. dist
        # (a) the whole-frame eval (--spatial) through the CLI at bf16 and
        # float32 on one rank; (b) the builder chunks and member strips on
        # the verify frame; (c) the builtup time series --spatial; (d) the
        # two-process rehearsal on cuda:0 over gloo against one rank; (e)
        # the data- and ensemble-parallel evals of two ranks on cuda:0 over
        # gloo against the one-rank eval
        import torch.distributed as tdist

        from popcorn_tpu_torch.dist.launch import spawn_ranks
        from popcorn_tpu_torch.dist.mesh import make_mesh
        from popcorn_tpu_torch.dist.multihost import (
            flat_tree,
            launch_workers,
            run_demo_eval,
            run_demo_step,
        )
        from popcorn_tpu_torch.infer import spatial as sp
        from popcorn_tpu_torch.infer.device_feed import season_arrays

        t_phase = time.perf_counter()
        if tdist.is_initialized():
            raise AssertionError("a process group is up before phase dist")
        dist_rec = {}
        # (a) the whole frame: one season, so the counts of one patch
        spatial_ok = True
        for tag, extra, ref_glob in (("bfloat16", (), main_glob),
                                     ("float32", ("--compute_dtype", "float32"), glob32)):
            want = MAIN_LAUNCHES if tag == "bfloat16" else want32
            split_sp = {}
            st_sp, wall_sp, l_sp, glob_sp = run_eval(f"spatial_{tag}", ("--spatial", *extra), want,
                                                     timings=split_sp, units=1)
            sp_map, st_map = read_map(glob_sp), read_map(ref_glob)
            inner = (slice(RING, -RING), slice(RING, -RING))
            rep_ = close_report(sp_map[inner], st_map[inner], **SPATIAL_INTERIOR)
            ring = np.ones(sp_map.shape, bool)
            ring[inner] = False
            rec = {"wall_s": wall_sp, "timings": split_sp["rwa"],
                   "launches": {k: v for k, v in l_sp.items() if v},
                   "interior": rep_, "ring_max": float(sp_map[ring].max()),
                   "stitched_ring_max": float(np.abs(st_map[ring]).max()),
                   "adj_coarse_r2": st_sp["Population_AdjCensus_rwa_coarse/r2"]}
            dist_rec[f"spatial_{tag}"] = rec
            spatial_ok &= rep_["ok"] and rec["ring_max"] > 0 and rec["stitched_ring_max"] == 0
        # (b) float32: the builder in 512-row chunks, the member fold in
        # 1024-row strips, against the whole frame
        cfg32 = model_config_from_args(eval_parser().parse_args(
            [*eval_flags, "--compute_dtype", "float32", "-r", *members]))
        loaded = [load_member(m) for m in members]
        dsv = PopulationDataset(DataPaths(data), "rwa", mode="test", patchsize=2048, overlap=128,
                                fourseasons=False)
        mos, _ = season_arrays(dsv, 0)
        dsv.close()
        sample = {k: np.transpose(a, (1, 2, 0))[None] for k, a in mos.items()}
        mconsts = to_torch(loaded[0][1], dev)
        x_sp = sp._inputs(sample, cfg32, NormStats(device=dev), slice(0, 2304), dev)
        reset_launches()
        whole_b = create_building_score(mconsts["builder"], x_sp, s1=True, s2=True, nir=True)
        chunk_b = sp.chunked_building_score(mconsts, x_sp, cfg32, None, rows_per_chunk=512)
        torch.cuda.synchronize()
        chunk_launches = {k: v for k, v in read_launches().items() if v}
        b_rep = close_report(chunk_b.cpu().numpy(), whole_b.cpu().numpy(), **STRIP_TOL)
        fold_whole = sp.make_spatial_ensemble(cfg32, mconsts, None, 5, device=dev)
        acc_w = fold_whole([m[0] for m in loaded], sample, sp.new_accumulators(2304, 2560, device=dev))
        min_h = sp._MEMBER_CHUNK_MIN_H
        sp._MEMBER_CHUNK_MIN_H = 2304
        try:
            fold_strips = sp.make_spatial_ensemble(cfg32, mconsts, None, 5, device=dev, strip_rows=1024)
            reset_launches()
            acc_s = fold_strips([m[0] for m in loaded], sample,
                                sp.new_accumulators(2304, 2560, device=dev))
            torch.cuda.synchronize()
            strip_launches = {k: v for k, v in read_launches().items() if v}
        finally:
            sp._MEMBER_CHUNK_MIN_H = min_h
        s_rep = {k: close_report(acc_s[k].cpu().numpy(), acc_w[k].cpu().numpy(), **STRIP_TOL)
                 for k in acc_w}
        dist_rec["strips"] = {"builder_512": b_rep, "builder_launches": chunk_launches,
                              "fold_1024": s_rep, "fold_launches": strip_launches}
        strips_ok = b_rep["ok"] and all(r["ok"] for r in s_rep.values())
        del acc_w, acc_s, x_sp, whole_b, chunk_b, fold_whole, fold_strips
        torch.cuda.empty_cache()
        # (c) the builtup time series' whole frames against the patch path
        # of a patch that holds the whole frame
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written_sp = ts_cli.main(["builtup", "--frames", frames_json, "--out-dir",
                                  os.path.join(tmp, "builtup_spatial"), "--spatial"])
        torch.cuda.synchronize()
        bu_sp_wall = time.perf_counter() - t0
        bu_sp_launches = {k: v for k, v in read_launches().items() if v}
        with GeoTIFF(written_sp[0]) as gt:
            bu_sp = gt.read(1, squeeze=True)
        whole_patch = sum(ts.builtup_map(bconsts, mcfg, s2f, v, patchsize=4096, device=dev)
                          for v in orbit.values()) / 2.0
        c_rep = close_report(bu_sp, whole_patch, **BUILTUP_PATCH_TOL)
        dist_rec["builtup_spatial"] = {"wall_s": bu_sp_wall, "launches": bu_sp_launches,
                                       "frames": len(written_sp), "vs_patch_path": c_rep}
        builtup_ok = c_rep["ok"] and bu_sp_launches == {"double_conv": 6 * 2 * len(dates),
                                                        "up_block": 4 * 2 * len(dates)}
        # (d) the two-process rehearsal on the card against one rank
        out_params = os.path.join(tmp, "rehearsal_params.pt")
        worker_launches = []
        t0 = time.perf_counter()
        (l0, p0, e0), (l1, p1, e1) = launch_workers(2, device="cuda:0", out=out_params,
                                                    timeout=600, launches=worker_launches)
        rehearsal_wall = time.perf_counter() - t0
        one_loss, one_pop, one_params = run_demo_step(None, device=dev)
        one_ens = run_demo_eval(None, device=dev)
        got_p = torch.load(out_params)
        p_reps = {k: close_report(got_p[k].numpy(), v.cpu().numpy(), **REHEARSAL_PARAMS)
                  for k, v in flat_tree(one_params).items()}
        worst = max(p_reps, key=lambda k: p_reps[k]["max_abs"])
        d_rec = {"wall_s": rehearsal_wall, "loss": [l0, l1, one_loss], "popsum": [p0, p1, one_pop],
                 "enssum": [e0, e1, one_ens], "loss_rel": abs(l0 - one_loss) / abs(one_loss),
                 "enssum_rel": abs(e0 - one_ens) / abs(one_ens), "params_ok": all(
                     r["ok"] for r in p_reps.values()), "params_worst": {worst: p_reps[worst]},
                 "worker_launches": worker_launches}
        dist_rec["rehearsal"] = d_rec
        step_launches = {"double_conv": 6, "up_block": 4, "head": 1, "head_bwd": 1}
        rehearsal_ok = (d_rec["loss_rel"] <= REHEARSAL_LOSS_RTOL and l0 == l1 and e0 == e1
                        and d_rec["enssum_rel"] <= REHEARSAL_LOSS_RTOL and d_rec["params_ok"]
                        and worker_launches == [step_launches, step_launches])
        del one_params, got_p
        # (e) data- and ensemble-parallel evals of two ranks on the card
        ranked = {}
        ranked_ok = True
        one_map = read_map(main_glob)
        per_patch = {"double_conv_bf16": 6, "up_block_bf16": 4}  # the builder
        for nd, ne in ((2, 1), (1, 2)):
            out = os.path.join(tmp, f"ranked_{nd}x{ne}")
            os.makedirs(out)
            links = []
            for m in members:
                links.append(os.path.join(out, os.path.basename(m)))
                os.symlink(m, links[-1])
            t0 = time.perf_counter()
            spawn_ranks(ranked_eval, 2, (data, links, eval_flags, out, nd, ne),
                        devices=["cuda:0", "cuda:0"])
            wall_r = time.perf_counter() - t0
            ranks = [json.load(open(f"{out}.rank{r}.json")) for r in range(2)]
            # rank 0 alone writes, into the one folder both ranks name
            folders = glob.glob(os.path.join(out, "eval_outputs_ensemble_*"))
            writes_ok = (folders == [ranks[0]["folder"]] == [ranks[1]["folder"]]
                         and [r["writes"] for r in ranks] == [True, False]
                         and ranks[0]["n_metrics"] == len(stats) and ranks[1]["n_metrics"] == 0)
            got = {"map": read_map(folders[0]) if folders else np.zeros(1)}
            want_r = []
            for r in range(2):
                n_mem = 5 if ne == 1 else (3, 2)[r]
                n_pat = n_patches // nd
                want_r.append({"double_conv_bf16": n_pat * (per_patch["double_conv_bf16"] + 6 * n_mem),
                               "up_block_bf16": n_pat * (per_patch["up_block_bf16"] + 4 * n_mem),
                               "head_bf16": n_pat * n_mem, "double_conv": 0, "up_block": 0,
                               "head": 0})
            m_rep = close_report(got["map"], one_map, **RANKED_MAP_TOL)
            ranked[f"{nd}x{ne}"] = {"spawn_wall_s": wall_r, "ranks": ranks, "map": m_rep,
                                    "expected_launches": want_r, "rank0_writes_only": writes_ok}
            ranked_ok &= m_rep["ok"] and writes_ok and [r["launches"] for r in ranks] == want_r \
                and all(r["backend"] == "gloo" for r in ranks)
        dist_rec["ranked_evals"] = ranked
        if tdist.is_initialized():
            raise AssertionError("phase dist left a process group up")
        emit({"phase": "dist", **dist_rec, "bounds": {
            "spatial_interior": SPATIAL_INTERIOR, "strips": STRIP_TOL,
            "builtup_patch": BUILTUP_PATCH_TOL, "rehearsal_loss_rtol": REHEARSAL_LOSS_RTOL,
            "rehearsal_params": REHEARSAL_PARAMS, "ranked_map": RANKED_MAP_TOL},
            "seconds": time.perf_counter() - t_phase})
        checks = {"spatial": spatial_ok, "strips": strips_ok, "builtup": builtup_ok,
                  "rehearsal": rehearsal_ok, "ranked": ranked_ok}
        if not all(checks.values()):
            raise AssertionError(f"phase dist: {checks}")
        del loaded
        torch.cuda.empty_cache()

        # ----------------------------------------------------------- 13. spatial_train
        # (1) the spatial step of one 1x4096x2048 crop on one rank and with
        # its rows over two ranks on cuda:0 over gloo, float32 and bf16;
        # (2) the train CLI's --spatial_train on the same two ranks against
        # the one-rank CLI, then the eval CLI on its checkpoint
        from popcorn_tpu_torch.cli.args import train_parser

        t_phase = time.perf_counter()
        sp_rec = {}
        one = spatial_train_steps(None, dev)
        torch.cuda.empty_cache()
        out_sp = os.path.join(tmp, "spatial_steps")
        t0 = time.perf_counter()
        spawn_ranks(spatial_train_rank, 2, (out_sp,), devices=["cuda:0", "cuda:0"])
        spawn_wall = time.perf_counter() - t0
        ranks_sp = [torch.load(f"{out_sp}.rank{r}.pt", weights_only=False) for r in range(2)]
        steps_ok = all(r["backend"] == "gloo" for r in ranks_sp)
        step_rec = {"crop": list(SPATIAL_CROP), "spawn_wall_s": spawn_wall,
                    "row_blocks": [list(r["row_block"]) for r in ranks_sp]}
        for cdt in ("float32", "bfloat16"):
            ref, got = one[cdt], ranks_sp[0][cdt]
            loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
            pop_rel = float(np.max(np.abs(got["popcount"] - ref["popcount"]) / np.abs(ref["popcount"])))
            vr = torch.cat([g.ravel() for g in ref["grads"].values()]).double()
            vg = torch.cat([got["grads"][k].ravel() for k in ref["grads"]]).double()
            grad_rel = float((vg - vr).norm() / vr.norm())
            grad_corr = float(np.corrcoef(vr.numpy(), vg.numpy())[0, 1])
            rec = {"loss": [got["loss"], ref["loss"]], "loss_rel": loss_rel, "popcount_rel": pop_rel,
                   "grad_rel_l2": grad_rel, "grad_corr": grad_corr,
                   "one_rank": {"step_ms": ref["step_ms"], "peak_mem_bytes": ref["peak_mem_bytes"],
                                "launches": ref["launches"]},
                   "ranks": [{"step_ms": r[cdt]["step_ms"], "peak_mem_bytes": r[cdt]["peak_mem_bytes"],
                              "peak_mem_share": r[cdt]["peak_mem_bytes"] / ref["peak_mem_bytes"],
                              "launches": r[cdt]["launches"]} for r in ranks_sp]}
            ok = ([r[cdt]["launches"] for r in ranks_sp] == [SPATIAL_LAUNCHES[cdt]] * 2
                  and ref["launches"] == SPATIAL_LAUNCHES[cdt]
                  and ranks_sp[1][cdt]["loss"] == got["loss"])
            if cdt == "float32":
                # every stepped parameter at the rehearsal's bound, and each
                # leaf's gradient and update norm-relative, as phase
                # train_step holds the card to the CPU (module constants)
                start = dict(train_state.tree_flatten(to_torch(load_popcorn_from_dda(
                    mcfg, head_seed=SPATIAL_HEAD_SEED)[0], "cpu")))
                g_rel = u_rel = 0.0
                n_out = n_all = 0
                for k, g in ref["grads"].items():
                    if float(g.norm()) > 0:
                        g_rel = max(g_rel, float((got["grads"][k] - g).norm() / g.norm()))
                    du = ref["params"][k] - start[k]
                    if float(du.norm()) > 0:
                        u_rel = max(u_rel, float((got["params"][k] - start[k] - du).norm() / du.norm()))
                    d = (got["params"][k] - ref["params"][k]).abs()
                    n_out += int((d > REHEARSAL_PARAMS["atol"]
                                  + REHEARSAL_PARAMS["rtol"] * ref["params"][k].abs()).sum())
                    n_all += d.numel()
                rec.update(grad_norm_rel_err_max=g_rel, update_norm_rel_err_max=u_rel,
                           params_outside_rehearsal_bound=[n_out, n_all])
                ok = (ok and loss_rel <= REHEARSAL_LOSS_RTOL and pop_rel <= REHEARSAL_LOSS_RTOL
                      and n_out == 0 and g_rel <= STEP_RTOL and u_rel <= STEP_UPDATE_RTOL)
            else:
                ok = (ok and loss_rel <= STEP_BF16_RTOL and pop_rel <= STEP_BF16_RTOL
                      and grad_rel <= STEP_BF16_RTOL and grad_corr >= STEP_BF16_CORR)
            rec["ok"] = ok
            step_rec[cdt] = rec
            steps_ok &= ok
        sp_rec["step"] = step_rec
        del one, ranks_sp
        torch.cuda.empty_cache()
        # (2) the CLI: the verify skill's flags with --spatial_train, on one
        # rank (the plain step) and on the two ranks
        sp_argv = ["--data_root", data, "-S2", "-NIR", "-S1", "-treg", "rwa", "-tregtrain", "rwa",
                   "-occmodel", "-senbuilds", "-pret", "-binit", "0.9407", "-tlevel", "coarse",
                   "-e", "1", "-mws", "6", "-lt", "1", "-w", "4", "--spatial_train"]
        t0 = time.perf_counter()
        one_tr = train_cli.main([*sp_argv, "--save_dir", os.path.join(tmp, "sp_one")])
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
        one_losses = train_losses_of(one_tr.experiment_folder)
        one_feed = one_tr.feed_choice
        del one_tr
        torch.cuda.empty_cache()
        sp_out = os.path.join(tmp, "sp_two")
        t0 = time.perf_counter()
        spawn_ranks(spatial_train_cli, 2, ([*sp_argv, "--save_dir", sp_out], sp_out),
                    devices=["cuda:0", "cuda:0"])
        two_wall = time.perf_counter() - t0
        cli_ranks = [json.load(open(f"{sp_out}.rank{r}.json")) for r in range(2)]
        folders = glob.glob(os.path.join(sp_out, "experiment_*"))
        writes_ok = (folders == [cli_ranks[0]["folder"]] == [cli_ranks[1]["folder"]]
                     and [r["writes"] for r in cli_ranks] == [True, False]
                     and os.path.exists(os.path.join(folders[0], "last_model.pth")))
        two_losses = train_losses_of(folders[0]) if folders else []
        first_rel = (abs(two_losses[0] - one_losses[0]) / abs(one_losses[0])
                     if two_losses and one_losses else math.inf)
        cli_ok = (writes_ok and len(two_losses) == len(one_losses) > 0
                  and all(math.isfinite(v) for v in two_losses) and first_rel <= STEP_BF16_RTOL
                  and one_feed == "host" and all(r["feed"] == "host" for r in cli_ranks))
        sp_stats = {}
        if writes_ok:
            ck = os.path.join(folders[0], "last_model.pth")
            sp_stats = eval_cli.main(["--data_root", data, *eval_flags, "-r", ck, ck])
            sp_rec["ckpt_eval_adj_coarse_r2"] = check_eval(
                sp_stats, os.path.join(folders[0], "eval_outputs_ensemble_*"))
        sp_rec["cli"] = {"one_rank_wall_s": one_wall, "two_ranks_spawn_wall_s": two_wall,
                         "losses": two_losses, "one_rank_losses": one_losses,
                         "first_loss_rel": first_rel, "ranks": cli_ranks,
                         "rank0_writes_only": writes_ok, "ok": cli_ok}
        emit({"phase": "spatial_train", **sp_rec, "bounds": {
            "float32_loss_rtol": REHEARSAL_LOSS_RTOL, "float32_params": REHEARSAL_PARAMS,
            "float32_grad_rtol": STEP_RTOL,
            "float32_update_rtol": STEP_UPDATE_RTOL, "bf16_rtol": STEP_BF16_RTOL,
            "bf16_corr_min": STEP_BF16_CORR},
            "seconds": time.perf_counter() - t_phase})
        if not (steps_ok and cli_ok):
            raise AssertionError(f"phase spatial_train: steps {steps_ok}, cli {cli_ok}")
        if tdist.is_initialized():
            raise AssertionError("phase spatial_train left a process group up")

        # ---------------------------------------------------------------- 14. prep
        # steps 1-4: a region built by the port's tools (prep_region); 5:
        # the bf16 Bag eval on it, its device feed reading the sidecars,
        # against the same eval on the region as written (no sidecar); 6:
        # the parity harness's selftest on the card; 7: the multichip dry
        # run on two ranks of cuda:0 over gloo
        from popcorn_tpu_torch.dryrun import dryrun_multichip
        from popcorn_tpu_torch.io import raster_cache

        t_phase = time.perf_counter()
        prep_data, prep_rec, prep_checks = prep_region(data, tmp)
        open_cache = raster_cache.open_cache
        sidecar_reads = [0]

        def counted_open_cache(path):
            mm = open_cache(path)
            sidecar_reads[0] += mm is not None
            return mm

        prep_evals = {}
        raster_cache.open_cache = counted_open_cache
        try:
            for tag, root in (("tools", prep_data), ("as_written", data)):
                sidecar_reads[0] = 0
                split_p = {}
                st_p, wall_p, l_p, glob_p = run_eval(f"prep_{tag}", want=MAIN_LAUNCHES,
                                                     timings=split_p, root=root)
                prep_evals[tag] = {"stats": st_p, "glob": glob_p, "wall_s": wall_p,
                                   "launches": {k: v for k, v in l_p.items() if v},
                                   "sidecar_reads": sidecar_reads[0], "timings": split_p["rwa"]}
        finally:
            raster_cache.open_cache = open_cache
        ev_t, ev_w = prep_evals["tools"], prep_evals["as_written"]
        for tag in ("", "STD", "SCALE_rwa", "SCALE_STD", "ADJ_rwa"):
            maps = []
            for ev in (ev_t, ev_w):
                with GeoTIFF(os.path.join(glob.glob(ev["glob"])[0], f"rwa_predictions{tag}.tif")) as gt:
                    maps.append(gt.read(1, squeeze=True))
            prep_checks[f"geotiff_{tag or 'map'}"] = same_bits(*maps)
        prep_checks["census_metrics"] = ev_t["stats"] == ev_w["stats"]
        prep_checks["sidecars_read"] = ev_t["sidecar_reads"] > 0 and ev_w["sidecar_reads"] == 0
        prep_checks["device_feed"] = ev_t["timings"].get("n_device_patches") == n_patches
        # 6. the selftest as a user runs it: its last line is its record
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "popcorn_tpu_torch.tools.parity_released",
                            "--selftest", "--device", "cuda"], cwd=HERE, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        selftest_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"parity_released --selftest exited {r.returncode}:\n{r.stdout[-4000:]}")
        selftest = json.loads(r.stdout.strip().splitlines()[-1])["selftest"]
        surf_launches = {k: v["launches"] for k, v in selftest.items() if isinstance(v, dict)}
        float_abc = {"double_conv.launches", "up_block.launches", "head.launches"}
        prep_checks["selftest_cli_equals_harness"] = selftest["cli_equals_harness"] is True
        prep_checks["selftest_float32_abc"] = all(
            set(surf_launches[k]) == float_abc for k in ("stitched", "spatial", "transport_bf16"))
        prep_checks["selftest_int8s_ef"] = {"double_conv.launches_qs", "up_block.launches_qs"} <= set(
            surf_launches["int8s"])
        # 7. the dry run: its checks raise in the rank that fails them
        t0 = time.perf_counter()
        dry = dryrun_multichip(2, device="cuda:0")
        dry_s = time.perf_counter() - t0
        prep_checks["dryrun"] = dry["backend"] == "gloo" and dry["feed_leaves_bit_equal"] == dry["feed_leaves"]
        if tdist.is_initialized():
            raise AssertionError("phase prep left a process group up")
        prep_rec["seconds"].update(eval_tools=ev_t["wall_s"], eval_as_written=ev_w["wall_s"],
                                   selftest=selftest_s, dryrun_multichip=dry_s)
        emit({"phase": "prep", **prep_rec,
              "evals": {tag: {k: v for k, v in ev.items() if k not in ("stats", "glob")}
                        for tag, ev in prep_evals.items()},
              "adj_coarse_r2": ev_t["stats"]["Population_AdjCensus_rwa_coarse/r2"],
              "selftest": {"launches": surf_launches,
                           "r2": {k: v["r2"] for k, v in selftest.items() if isinstance(v, dict)}},
              "dryrun_multichip": dry, "checks": prep_checks,
              "seconds_total": time.perf_counter() - t_phase})
        if not all(prep_checks.values()):
            raise AssertionError(f"phase prep: {[k for k, v in prep_checks.items() if not v]}")

    # ---------------------------------------------------------------- summary
    # each kernel's launches from the run of its own path: A-C in bf16 the
    # main eval at the default dtype, in float32 its float32 run, D
    # training, E and F's bf16 mode the int8s eval, F (int8 out and float32
    # features) the int8s eval at float32, G's and H's bf16 modes the int8
    # eval, their float32 modes the int8 eval at float32
    launches = {**{k: launches[k] for k in MAIN_LAUNCHES},
                **{k: launches32[k] for k in ("double_conv", "up_block", "head")},
                "head_bwd": train_launches["head_bwd"],
                **{k: quant_launches["int8s"][k] for k in ("double_conv_qs", "up_block_qs_bf16")},
                "up_block_qs": quant_launches["int8s_float32"]["up_block_qs"],
                **{k: quant_launches["int8"][k] for k in ("double_conv_q_bf16", "up_block_q_bf16")},
                **{k: quant_launches["int8_float32"][k] for k in ("double_conv_q", "up_block_q")}}
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
        "up_block_qs_bf16": ("popcorn_tpu_torch/csrc/up_block_qs.cu",
                             "popcorn_tpu/nn/pallas_conv.py:282"),
        "double_conv_q": ("popcorn_tpu_torch/csrc/double_conv_q.cu", "popcorn_tpu/nn/pallas_conv.py:163"),
        "double_conv_q_bf16": ("popcorn_tpu_torch/csrc/double_conv_q.cu",
                               "popcorn_tpu/nn/pallas_conv.py:163"),
        "up_block_q": ("popcorn_tpu_torch/csrc/up_block_q.cu", "popcorn_tpu/nn/pallas_conv.py:533"),
        "up_block_q_bf16": ("popcorn_tpu_torch/csrc/up_block_q.cu",
                            "popcorn_tpu/nn/pallas_conv.py:533"),
    }
    kernels = []
    for kname, (src, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == kname]
        on_path = [c for c in mine if c["per_member_calls"] > 0]
        tot = lambda key: sum(c[key] * c["per_member_calls"] for c in on_path)  # noqa: E731
        b_ops = sum(c["ops_ms"] * c["per_member_calls"] for c in on_path)
        b_bytes = sum(c["mbytes"] * 1e6 * c["per_member_calls"] for c in on_path) / PEAK_HBM_BYTES * 1e3
        no_dev = any(c["device_ms"] is None for c in on_path)
        entry = {
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": tot("kernel_ms"), "device_ms": None if no_dev else tot("device_ms"),
            "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": tot("library_ms"),
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

"""Analytic FLOP accounting and MFU reporting for the POPCORN pipeline.

Counterpart of popcorn_tpu/utils/flops.py. Every headline rate can be
given with

  * ``useful`` TFLOP/s: the model-math FLOPs per patch or step, counted
    analytically from the architecture (this module), the FLOPs any
    implementation of the reference's math must perform;
  * ``executed`` FLOPs: what PyTorch's operators count for a call
    (``torch.utils.flop_counter.FlopCounterMode``), elementwise work
    excluded. The counter sees torch operators only, not a kernel launched
    through ctypes, so ``eval_executed_probe`` counts the plain path on the
    CPU, whose convolutions and products are torch operators;
  * ``mfu``: a rate as a fraction of the card's published dense peak
    (``device_peak_flops``).

Architecture being counted (reference: model/DDA_model/utils/networks.py
topology [8, 16]; model/popcorn.py head + occupancy):

  per UNet stream (cin -> t0=8, t1=16), resolutions relative to (H, W):
    inc   @ 1    : conv3x3 cin->t0, conv3x3 t0->t0
    down1 @ 1/2  : conv3x3 t0->t1, conv3x3 t1->t1
    down2 @ 1/4  : conv3x3 t1->t1, conv3x3 t1->t1
    up2   @ 1/2  : tconv2x2 t1->t1, conv3x3 2*t1->t0, conv3x3 t0->t0
    up1   @ 1    : tconv2x2 t0->t0, conv3x3 2*t0->t0, conv3x3 t0->t0
  dual-stream features = sar(cin=2) + opt(cin=4) streams (16ch concat);
  builder = dual-stream + fusion 1x1 16->1 (run ONCE per eval patch —
  infer/sliding.py prep);
  head = 1x1 chain 16->64->64->64->2 per member (popcorn.py:78-88).

Conventions: 1 MAC = 2 FLOPs; elementwise/BN/pool work is excluded from
the *analytic* counts (it is <1% of the conv MACs). A training step is
counted as 3x forward for the gradient path (standard fwd +
grad-wrt-input + grad-wrt-weight convention) plus 1x forward for the
frozen builder.
"""

from __future__ import annotations

from typing import Optional

import torch

SAR_IN = 2
OPT_IN = 4


def _stream_flops_per_px(cin: int, t0: int = 8, t1: int = 16) -> float:
    """Conv FLOPs per full-res pixel for one UNet stream (see module doc)."""
    c33 = lambda ci, co: 18.0 * ci * co  # 2 * 3*3 MACs per output px
    inc = c33(cin, t0) + c33(t0, t0)
    down1 = (c33(t0, t1) + c33(t1, t1)) / 4.0
    down2 = (c33(t1, t1) + c33(t1, t1)) / 16.0
    # tconv 2x2 stride 2: each output px receives exactly one 2x2 tap
    up2 = (2.0 * t1 * t1 + c33(2 * t1, t0) + c33(t0, t0)) / 4.0
    up1 = 2.0 * t0 * t0 + c33(2 * t0, t0) + c33(t0, t0)
    return inc + down1 + down2 + up2 + up1


def features_flops_per_px(s1: bool = True, s2: bool = True) -> float:
    """Dual-stream 16ch feature FLOPs per pixel (networks.py:192-211)."""
    total = 0.0
    if s1:
        total += _stream_flops_per_px(SAR_IN)
    if s2:
        total += _stream_flops_per_px(OPT_IN)
    return total


def builder_flops_per_px(s1: bool = True, s2: bool = True) -> float:
    """Building-score extractor: features + fusion 1x1 (n_streams*8 -> 1)."""
    cin = 8 * (int(s1) + int(s2))
    return features_flops_per_px(s1, s2) + 2.0 * cin


def head_flops_per_px(cin: int = 16, hidden: int = 64) -> float:
    """1x1 conv chain cin->hidden->hidden->hidden->2 (popcorn.py:78-88)."""
    return 2.0 * (cin * hidden + hidden * hidden * 2 + hidden * 2)


def member_flops_per_px(s1: bool = True, s2: bool = True) -> float:
    """One ensemble member's forward: features + head (occupancy mults excl.)."""
    return features_flops_per_px(s1, s2) + head_flops_per_px()


def eval_patch_flops(
    h: int,
    w: int,
    n_members: int,
    *,
    s1: bool = True,
    s2: bool = True,
    sentinel_buildings: bool = True,
) -> float:
    """Useful FLOPs for one eval patch through the ensemble fold.

    Mirrors infer/sliding.py::make_patch_forward: the builder runs once
    per patch (the reference recomputes it per member, run_eval.py:108-115
    — we count OUR math, which is the cheaper equivalent), then n_members
    feature+head passes.
    """
    px = float(h) * float(w)
    total = n_members * member_flops_per_px(s1, s2) * px
    if sentinel_buildings:
        total += builder_flops_per_px(s1, s2) * px
    return total


def train_step_flops(
    h: int,
    w: int,
    batch: int,
    *,
    s1: bool = True,
    s2: bool = True,
    sentinel_buildings: bool = True,
) -> float:
    """Useful FLOPs for one fwd+bwd training step (3x fwd convention).

    The builder (building score) is frozen and under stop_gradient, so it
    contributes 1x forward; the trainable extractor+head path contributes
    3x (fwd, dL/dx, dL/dw).
    """
    px = float(h) * float(w) * batch
    total = 3.0 * member_flops_per_px(s1, s2) * px
    if sentinel_buildings:
        total += builder_flops_per_px(s1, s2) * px
    return total


# Published dense peaks of NVIDIA cards (TFLOP/s; int8 in TOP/s), from
# NVIDIA's H100 data sheet: fp32 on the CUDA cores, tf32, bf16 and int8 on
# the tensor cores, without sparsity, at the part's full power limit.
# Keyed by substrings of torch.cuda.get_device_name, the more specific
# first.
_PEAKS_TFLOPS = {
    "H100 PCIe": {"bf16": 756.0, "tf32": 378.0, "fp32": 51.0, "int8": 1513.0},
    "H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0, "int8": 1979.0},  # SXM
}


def device_peak_flops(device, dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s (int8: OP/s) of a torch device for ``dtype`` ('bf16',
    'tf32', 'fp32' or 'int8'; another key reads the bf16 peak), or None
    for the CPU or a card the table does not name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peaks in _PEAKS_TFLOPS.items():
        if key in name:
            return peaks.get(dtype, peaks["bf16"]) * 1e12
    return None


def executed_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs that PyTorch's operators count for one call ``fn(*args,
    **kwargs)`` (``FlopCounterMode``: convolutions and matrix products),
    or None when it counts none. A kernel launched through ctypes is not a
    torch operator and is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def mfu_line(rate_per_sec: float, flops_per_unit: float, peak: Optional[float]) -> dict:
    """A JSON-ready {tflops, mfu} pair; mfu omitted when peak is unknown."""
    tflops = rate_per_sec * flops_per_unit / 1e12
    out = {"tflops": round(tflops, 3)}
    if peak:
        out["mfu"] = round(tflops * 1e12 / peak, 4)
    return out


def eval_executed_probe(mcfg, consts, stats, params_member, batch) -> Optional[dict]:
    """Executed FLOPs of the eval patch pipeline, per stage: prep
    (normalize + builder score) and one member pass, ``{"prep": F,
    "member": F, "engine": "plain"}``; total per patch = prep + n_members *
    member.

    Counted on the CPU, whatever the device of the inputs: there every
    block and the head run their plain versions, torch operators that
    ``FlopCounterMode`` sees, where on the card they launch kernels it
    cannot. Every ``layout`` runs the port's one engine, so the engine is
    'plain' for each (nn/popcorn.py). ``stats`` is the NormStats of the
    inputs; its tensors are copied to the CPU. Returns None when either
    stage counts no FLOPs."""
    import copy
    import dataclasses

    from ..compat.weights import to_torch
    from ..data.normalize import normalize_and_assemble
    from ..nn.popcorn import compute_dtype, create_building_score, popcorn_predict

    cpu = torch.device("cpu")
    consts, params_member = to_torch(consts, cpu), to_torch(params_member, cpu)
    stats = copy.copy(stats)
    for k, v in vars(stats).items():
        if isinstance(v, torch.Tensor):
            setattr(stats, k, v.to(cpu))
    stats.device = cpu
    sub = {k: torch.as_tensor(batch[k]).to(cpu)
           for k in ("S2", "S1", "VIIRS", "building_counts") if k in batch}
    dtype = compute_dtype(mcfg)

    def prep(b):
        sample = {}
        if mcfg.s2 and "S2" in b:
            sample["S2"] = b["S2"].float()
        if mcfg.s1 and "S1" in b:
            sample["S1"] = b["S1"]
        if mcfg.viirs and "VIIRS" in b:
            sample["VIIRS"] = b["VIIRS"]
        x = normalize_and_assemble(sample, stats)
        if mcfg.sentinel_buildings or not mcfg.occupancy_model:
            score = create_building_score(consts["builder"], x, s1=mcfg.s1, s2=mcfg.s2,
                                          nir=mcfg.nir, dtype=dtype)
        else:
            score = b["building_counts"]
        return x, score

    # member passes never recompute the building score (sliding.py)
    mcfg_member = dataclasses.replace(mcfg, sentinel_buildings=False)

    def member(params, x, score):
        score3 = score if score.dim() == 3 else score[..., 0]
        out = popcorn_predict(params, consts, {"input": x, "building_counts": score3},
                              mcfg_member, padding=False)
        return out["popdensemap"], out["scale"]

    f_prep = executed_flops(prep, sub)
    x0, score0 = prep(sub)
    f_member = executed_flops(member, params_member, x0, score0)
    if f_prep is None or f_member is None:
        return None
    return {"prep": f_prep, "member": f_member, "engine": "plain"}

"""Analytic FLOP counts of the POPCORN pipeline and the card's published peaks.

A copy of the program's analytic accounting (its utils/flops.py), kept
here so that a change to the program cannot move the yardstick. The
counts come from the architecture (topology [8, 16] per stream, the
building extractor once per eval patch, the head 16 -> 64 -> 64 -> 64 ->
2 per member), 1 MAC = 2 FLOPs, elementwise, BatchNorm and pooling work
left out; a training step counts the trainable path three times (forward,
input gradient, weight gradient) and the frozen extractor once.
"""

from __future__ import annotations

from typing import Optional

SAR_IN = 2
OPT_IN = 4


def _c33(ci: int, co: int) -> float:
    return 18.0 * ci * co  # 2 x 3 x 3 MACs per output pixel


def stream_flops_per_px(cin: int, t0: int = 8, t1: int = 16) -> float:
    """Convolution FLOPs per full-resolution pixel of one UNet stream."""
    inc = _c33(cin, t0) + _c33(t0, t0)
    down1 = (_c33(t0, t1) + _c33(t1, t1)) / 4.0
    down2 = (_c33(t1, t1) + _c33(t1, t1)) / 16.0
    up2 = (2.0 * t1 * t1 + _c33(2 * t1, t0) + _c33(t0, t0)) / 4.0
    up1 = 2.0 * t0 * t0 + _c33(2 * t0, t0) + _c33(t0, t0)
    return inc + down1 + down2 + up2 + up1


def features_flops_per_px(s1: bool = True, s2: bool = True) -> float:
    return (stream_flops_per_px(SAR_IN) if s1 else 0.0) + (stream_flops_per_px(OPT_IN) if s2 else 0.0)


def builder_flops_per_px(s1: bool = True, s2: bool = True) -> float:
    return features_flops_per_px(s1, s2) + 2.0 * 8 * (int(s1) + int(s2))


def head_flops_per_px(cin: int = 16, hidden: int = 64) -> float:
    return 2.0 * (cin * hidden + hidden * hidden * 2 + hidden * 2)


def member_flops_per_px(s1: bool = True, s2: bool = True) -> float:
    return features_flops_per_px(s1, s2) + head_flops_per_px()


def eval_patch_flops(h: int, w: int, n_members: int, *, s1: bool = True, s2: bool = True,
                     sentinel_buildings: bool = True) -> float:
    """Useful FLOPs of one eval patch: the builder once, then every member."""
    px = float(h) * float(w)
    total = n_members * member_flops_per_px(s1, s2) * px
    if sentinel_buildings:
        total += builder_flops_per_px(s1, s2) * px
    return total


def train_step_flops(h: int, w: int, batch: int, *, s1: bool = True, s2: bool = True,
                     sentinel_buildings: bool = True) -> float:
    """Useful FLOPs of one training step over batch x h x w pixels."""
    px = float(h) * float(w) * batch
    total = 3.0 * member_flops_per_px(s1, s2) * px
    if sentinel_buildings:
        total += builder_flops_per_px(s1, s2) * px
    return total


# Published dense peaks (TFLOP/s; int8 TOP/s) from NVIDIA's H100 data
# sheet, without sparsity, at the part's full power limit; keyed by
# substrings of torch.cuda.get_device_name, the more specific first.
PEAKS_TFLOPS = {
    "H100 PCIe": {"bf16": 756.0, "tf32": 378.0, "fp32": 51.0, "int8": 1513.0},
    "H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0, "int8": 1979.0},  # SXM
}
# HBM bandwidth of the SXM part (bytes/s), the data sheet's 3.35 TB/s
PEAK_HBM_BYTES = {"H100 PCIe": 2.0e12, "H100 80GB HBM3": 3.35e12}


def _entry(table, device_name: str):
    for key, v in table.items():
        if key in device_name:
            return v
    return None


def peak_flops(device_name: str, dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s of the card named ``device_name``, or None for a card
    the table does not name."""
    peaks = _entry(PEAKS_TFLOPS, device_name)
    return None if peaks is None else peaks[dtype] * 1e12


def peak_bytes(device_name: str) -> Optional[float]:
    return _entry(PEAK_HBM_BYTES, device_name)

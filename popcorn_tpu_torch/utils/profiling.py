"""Device-memory observability.

Counterpart of popcorn_tpu/utils/profiling.py::device_memory_stats (the
reference's nvidia-smi memory probe, run_train.py:39-40, 156-158), read
from PyTorch's CUDA caching allocator."""

from __future__ import annotations

from typing import Dict

import torch


def device_memory_stats(device=None) -> Dict[str, float]:
    """Bytes allocated now, the card's total and the peak allocated since
    the last ``torch.cuda.reset_peak_memory_stats``, in GB. Returns {} for
    a CPU device."""
    dev = torch.device(device) if device is not None else None
    if dev is None:
        if not torch.cuda.is_available():
            return {}
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        return {}
    return {
        "mem_used_gb": torch.cuda.memory_allocated(dev) / 1e9,
        "mem_limit_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
        "mem_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }

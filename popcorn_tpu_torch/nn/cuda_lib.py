"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in the package's build directory
(``popcorn_tpu_torch/build/``, git-ignored), and loaded with ``ctypes``.
A library is rebuilt when its source or the shared header is newer than it.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.

Wrappers pass tensor pointers from ``data_ptr()`` and the current stream
as ``c_void_p``; each C entry returns ``cudaGetLastError()`` (or -1 for a
shape it has no instantiation for) and :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNEL_SOURCES = ("double_conv", "up_block", "head", "head_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use"
        )
    return found


def _paths(name: str):
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    ]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def _start_build(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.popcorn_tmp = tmp  # type: ignore[attr-defined]
    proc.popcorn_lib = lib  # type: ignore[attr-defined]
    return proc


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(proc.popcorn_tmp, proc.popcorn_lib)


def build(names: Iterable[str] = KERNEL_SOURCES, force: bool = False) -> float:
    """Compile the given kernel sources, all nvcc processes at once.

    Returns the wall seconds taken. Sources whose library is fresh are
    skipped unless ``force``.
    """
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if force or _stale(n)]
        procs = {n: _start_build(n) for n in todo}
        for n, p in procs.items():
            _finish_build(n, p)
            _libs.pop(n, None)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_paths(name)[1])
        return _libs[name]


def function(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared; every entry returns an int status."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise for a C entry's non-zero status. -1 means the source has no
    instantiation for these channel counts (it launches nothing then)."""
    if rc == -1:
        raise ValueError(f"{what}: no kernel instantiation for these channel counts")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on the
    first one's device. Also raise for a tensor that requires a gradient
    while grad mode is on: a kernel launched through ctypes returns a
    tensor with no ``grad_fn``, so it would cut the gradient to zero
    silently. Blocks that train run their plain composition instead, and
    frozen ones run under ``torch.no_grad()`` (nn/unet.py)."""
    dev = tensors[0].device
    grad_mode = torch.is_grad_enabled()
    for i, t in enumerate(tensors):
        if grad_mode and t.requires_grad:
            raise RuntimeError(
                f"{name}: argument {i} requires a gradient; the kernel has no "
                "backward here (run a frozen block under torch.no_grad())"
            )
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: argument {i} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")

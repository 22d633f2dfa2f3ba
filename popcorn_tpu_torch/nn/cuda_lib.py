"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in the package's build directory
(``popcorn_tpu_torch/build/``, git-ignored), and loaded with ``ctypes``.
A library is rebuilt when its source or the shared header is newer than it.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.

Every wrapper launches through :func:`launch`: it passes tensors as their
``data_ptr()`` and the current stream last; each C entry returns
``cudaGetLastError()`` (or -1 for a shape it has no instantiation for),
:func:`check` raises on non-zero, and a launch that returned 0 is counted
as ``launches/<entry>`` in utils/profiling.py's ``COUNTERS``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

import torch

from ..utils.profiling import count

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNEL_SOURCES = (
    "double_conv", "up_block", "head", "head_bwd",
    "double_conv_qs", "up_block_qs", "double_conv_q", "up_block_q", "adam",
)
# The edge of the square tiles over which the dynamic int8 kernels G and H
# take one activation scale each (csrc/double_conv_q.cu and up_block_q.cu
# read it as POPCORN_TILE and are built for 16); their plain versions
# (nn/quant.py) cut the image into the same tiles.
TILE = 16
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", f"-DPOPCORN_TILE={TILE}", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# what nvcc printed for each source built in this process (ptxas -v:
# registers, spills and shared memory of every kernel instantiation)
build_logs: Dict[str, str] = {}
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
    build_logs[name] = out


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


def ptxas_usage(log: str) -> List[Dict[str, object]]:
    """Per kernel function of a build log: registers, spill bytes (stores
    and loads) and static shared memory, as ``ptxas -v`` reports them."""
    out: List[Dict[str, object]] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append({"function": m.group(1)})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1]["spill_store_bytes"], out[-1]["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def sass_count(name: str, opcode: str) -> Dict[str, int]:
    """How many instructions of ``opcode`` (e.g. "HMMA" or "IMMA", the
    tensor-core MMAs on float and int8 operands, or "IDP.4A", __dp4a)
    each kernel function of ``csrc/<name>.cu``'s built library holds, from
    ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _paths(name)[1]], capture_output=True, text=True,
                          check=True).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{re.escape(opcode)}\b", line):
            counts[fn] += 1
    return counts


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


def check(rc: int, what: str) -> None:
    """Raise for a C entry's non-zero status. -1 means the source has no
    instantiation for these channel counts (it launches nothing then)."""
    if rc == -1:
        raise ValueError(f"{what}: no kernel instantiation for these channel counts")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(source: str, entry: str, argtypes, *args) -> None:
    """Launch the C entry ``entry`` of ``csrc/<source>.cu`` (the library
    :func:`load` gives) on the current stream of the device of
    ``args[0]``, a tensor. ``argtypes`` are the types of ``args``, declared
    on the library's function object at the entry's first launch; a tensor
    passes as its data pointer, None as a null pointer, and the stream goes
    last. Raises for a non-zero status (:func:`check`); after a zero one,
    adds one to the counter ``launches/<entry without "popcorn_">``."""
    fn = getattr(load(source), entry)  # ctypes keeps it on the library
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    name = entry.removeprefix("popcorn_")
    check(rc, name)
    count("launches/" + name)


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on the
    first one's device. Also raise for a tensor that requires a gradient
    while grad mode is on: a kernel launched through ctypes returns a
    tensor with no ``grad_fn``, so it would cut the gradient to zero
    silently. Blocks that train run their plain composition instead, and
    frozen ones run under ``torch.no_grad()`` (nn/unet.py)."""
    require_cuda(name, [(t, torch.float32) for t in tensors])


def require_cuda(name: str, typed) -> None:
    """``require_cuda_f32`` for kernels that also take int8 activations or
    weights: ``typed`` is a sequence of (tensor, dtype) pairs."""
    dev = typed[0][0].device
    grad_mode = torch.is_grad_enabled()
    for i, (t, dtype) in enumerate(typed):
        if grad_mode and t.requires_grad:
            raise RuntimeError(
                f"{name}: argument {i} requires a gradient; the kernel has no "
                "backward here (run a frozen block under torch.no_grad())"
            )
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {i} is {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")

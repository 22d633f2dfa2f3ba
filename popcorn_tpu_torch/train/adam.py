"""The optimizer update on the card: one call of csrc/adam.cu (its norm
kernel, then its step kernel, over a grid of chunks of the leaves).

``AdamKernel.update`` is train/state.py::Optimizer's chain (global-norm
clip, weight decay, Adam, -lr) over every leaf at once; its plain version
is ``Optimizer.update_plain``, which the CPU path runs. The JAX package
has no kernel for it: optax's chain runs in XLA. Out of place, as the
chain: the new parameters, ``mu`` and ``nu`` are leaves of three fresh
flat buffers (views at offsets aligned to ``ALIGN`` elements, as separate
allocations would be), and the inputs are left as they were.

The kernel reads a table with one row a leaf, in tree_flatten's order:
the leaf's pointers, where it lies in the concatenation of all leaves and
in the output buffers, whether weight decay applies, and the gradient's
shape and strides (a gradient may be a strided view; parameters and
moments must be contiguous). The table reaches the card in one
non-blocking copy from pinned memory.

The launch is the span ``adam.update`` (utils/profiling.py). For a
small member the host work around the launch, not the card, sets the
update's time, so it is kept to a few Python calls a leaf: a ``Layout``
holds what changes only with the parameters' structure, and parameters
and moments that are the last update's own outputs are neither checked
again nor asked for their pointers.
"""

from __future__ import annotations

import ctypes
import math
import operator
from array import array
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..nn import cuda_lib
from ..utils.profiling import span

# a block's chunk of elements (csrc/adam.cu): a multiple of its threads
# (GT) times the elements each has in flight (AU), at most GRID_CHUNK,
# sized so that a small member still spreads over about GRID_BLOCKS blocks
# (two an SM of the H100): the DDA member's 39,333 elements take 20 blocks
# of 2,048, a Prithvi member's 308 M take 4,702 of 65,536
CHUNK_STEP = 512 * 4
GRID_CHUNK = 1 << 16
GRID_BLOCKS = 264

# each leaf of the output buffers starts on a multiple of 64 elements (256
# bytes), so the kernels and cuDNN read a parameter at the alignment of
# its own allocation
ALIGN = 64
# a table row: p, g, mu, nu pointers; start, n, out, flags; the shape
# right-aligned to 4 dimensions; g's strides over it, left 0 where g is
# contiguous and read flat (csrc/adam.cu::AdamLeaf)
TABLE_COLS = 16
DECAY, STRIDED = 1, 2
MAX_DIM = 4

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 10)


def chunk_for(total: int) -> int:
    """The elements of one block's chunk for ``total`` elements."""
    per = -(-total // GRID_BLOCKS)
    return min(GRID_CHUNK, max(CHUNK_STEP, -(-per // CHUNK_STEP) * CHUNK_STEP))


def out_offsets(sizes: Sequence[int]) -> Tuple[List[int], int]:
    """Each leaf's first element in the output buffers, and their length:
    leaves in order, each start rounded up to a multiple of ALIGN."""
    offs, o = [], 0
    for n in sizes:
        offs.append(o)
        o += -(-n // ALIGN) * ALIGN
    return offs, o


def _strides(shape) -> Tuple[int, ...]:
    """A contiguous tensor's strides for ``shape``."""
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


class Layout:
    """What the update of one parameter structure keeps from step to
    step: the leaves' paths, shapes and output offsets, the table's
    columns that do not change (pointers left 0) and the arguments of the
    leaves' views."""

    def __init__(self, paths: Sequence[Tuple[str, ...]], shapes: Sequence[torch.Size],
                 decay: Sequence[bool]):
        for q, s in zip(paths, shapes):
            if len(s) > MAX_DIM:
                raise ValueError(f"adam: {q} has {len(s)} dimensions; the kernel takes {MAX_DIM}")
        self.paths, self.shapes = list(paths), list(shapes)
        sizes = [math.prod(s) for s in shapes]
        self.offs, self.padded = out_offsets(sizes)
        if self.padded >= 2 ** 31:
            raise ValueError(f"adam: {self.padded} elements; the kernel indexes its buffers in "
                             "32 bits")
        self.total = sum(sizes)
        self.chunk = chunk_for(self.total)
        # one sum of squares a chunk (csrc/adam.cu's first stage), made on
        # the first update
        self.partial: Optional[torch.Tensor] = None
        self.views = [(s, _strides(s), o) for s, o in zip(shapes, self.offs)]
        self.rows, start = array("q"), 0
        for s, n, o, d in zip(shapes, sizes, self.offs, decay):
            lead = MAX_DIM - len(s)
            self.rows.extend((0, 0, 0, 0, start, n, o, DECAY if d else 0, *(1,) * lead, *s,
                              *(0,) * MAX_DIM))
            start += n


class Outputs(NamedTuple):
    """One update's three flat buffers and their leaves."""
    bufs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    p: List[torch.Tensor]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamKernel:
    """The update's launches for one optimizer. It keeps the Layout of
    the last parameter structure and the last update's Outputs, which the
    next update's parameters and moments usually are (three buffers of
    the model's size stay referenced until the next update)."""

    def __init__(self):
        self.layout: Optional[Layout] = None
        self.last: Optional[Outputs] = None

    def own(self, p, mu, nu) -> bool:
        """Whether p, mu and nu are the last update's outputs, leaf for leaf."""
        last = self.last
        return (last is not None and len(p) == len(last.p) and all(map(operator.is_, p, last.p))
                and all(map(operator.is_, mu, last.mu)) and all(map(operator.is_, nu, last.nu)))

    def table(self, paths: Sequence[Tuple[str, ...]], p, g, mu, nu,
              decay: Callable[[Tuple[str, ...]], bool]) -> Tuple[array, Layout]:
        """The kernel's table for these leaves (lists in tree_flatten's
        order, ``paths`` theirs) and their Layout, made anew when the
        structure changed. Raises for what the kernel does not take: lists
        of different lengths, leaves of different shapes, a p, mu or nu that
        is not contiguous, a tensor that is not float32, is on another
        device than the first parameter, or requires a gradient with grad
        mode on (the kernel has no backward)."""
        if not (len(paths) == len(p) == len(g) == len(mu) == len(nu)):
            raise ValueError(f"adam: {len(paths)} paths, {len(p)} parameters, {len(g)} "
                             f"gradients, {len(mu)} mu, {len(nu)} nu")
        own = self.own(p, mu, nu)
        _check_tensors(p[0].device, g if own else (*p, *g, *mu, *nu))
        lay = self.layout
        shapes = lay.shapes if own else [t.shape for t in p]
        if not own:
            for i, (t, m, v) in enumerate(zip(p, mu, nu)):
                if m.shape != t.shape or v.shape != t.shape:
                    raise ValueError(f"adam: leaf {i} is {tuple(t.shape)} with mu "
                                     f"{tuple(m.shape)}, nu {tuple(v.shape)}")
                if not (t.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
                    raise ValueError(f"adam: leaf {i}'s parameter or moments are not contiguous")
        if lay is None or lay.paths != paths or lay.shapes != shapes:
            lay = self.layout = Layout(paths, shapes, [decay(q) for q in paths])
        for i, (t, s) in enumerate(zip(g, shapes)):
            if t.shape != s:
                raise ValueError(f"adam: leaf {i} is {tuple(s)} with gradient {tuple(t.shape)}")
        C = TABLE_COLS
        rows = array("q", lay.rows)
        if own:
            for col, b in ((0, self.last.bufs[0]), (2, self.last.bufs[1]), (3, self.last.bufs[2])):
                base = b.data_ptr()
                rows[col::C] = array("q", [base + 4 * o for o in lay.offs])
        else:
            for col, ts in ((0, p), (2, mu), (3, nu)):
                rows[col::C] = array("q", [t.data_ptr() for t in ts])
        rows[1::C] = array("q", [t.data_ptr() for t in g])
        for i, t in enumerate(g):
            if not t.is_contiguous():
                rows[i * C + 7] |= STRIDED
                rows[i * C + 12:i * C + 16] = array("q", (0,) * (MAX_DIM - t.dim()) + t.stride())
        return rows, lay

    def update(self, paths, p, g, mu, nu, decay, *, lr: float, bc1: float, bc2: float,
               clip: float, weight_decay: float, b1: float, b2: float,
               eps: float) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        """Launch the update on float32 CUDA leaves (``table``'s
        arguments). Returns the new parameters, mu and nu as lists of
        leaves in that order."""
        if not p:
            return [], [], []
        dev = p[0].device
        if dev.type != "cuda":
            raise ValueError(f"adam: the parameters are on {dev}; the kernel runs on a card")
        rows, lay = self.table(paths, p, g, mu, nu, decay)
        table = torch.frombuffer(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
        bufs = tuple(torch.empty(lay.padded, device=dev, dtype=torch.float32) for _ in range(3))
        if lay.partial is None:
            lay.partial = torch.empty(-(-lay.total // lay.chunk), device=dev, dtype=torch.float32)
        with span("adam.update"):
            cuda_lib.launch("adam", "popcorn_adam", _ARGTYPES, table, len(p), lay.total,
                            lay.chunk, lay.partial, *bufs, clip, weight_decay, b1, b2, 1 - b1,
                            1 - b2, eps, bc1, bc2, -lr)
        self.last = Outputs(bufs, *([b.as_strided(*v) for v in lay.views] for b in bufs))
        return self.last.p, self.last.mu, self.last.nu


def _check_tensors(dev: torch.device, tensors) -> None:
    index = -1 if dev.index is None else dev.index
    f32, grad_mode = torch.float32, torch.is_grad_enabled()
    for i, t in enumerate(tensors):
        if t.get_device() != index or t.dtype is not f32 or (grad_mode and t.requires_grad):
            if t.device != dev:
                raise ValueError(f"adam: argument {i} is on {t.device}, expected {dev}")
            if t.dtype is not f32:
                raise TypeError(f"adam: argument {i} is {t.dtype}; the kernel takes torch.float32")
            raise RuntimeError(f"adam: argument {i} requires a gradient; "
                               "the kernel has no backward")

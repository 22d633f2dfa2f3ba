"""Row blocks of a frame over the data ranks.

The geometry that whole-frame inference (infer/spatial.py) and spatial
training (dist/mesh.py::shard_batch_spatial, train/state.py) share. A
frame (an eval season's whole region, or one training crop) splits into
blocks of kept rows, one a data rank; a rank reads ``2 * HALO`` rows of
context on each side of its block (one halo for the building extractor's
receptive field, one for the member UNet's) and keeps only its own rows.
This is the explicit form of the halo exchange XLA inserts for the JAX
package's row-sharded programs: every kept output is computed from true
context, so it equals the whole frame's, and its gradient depends on the
parameters only through the rank's own graph.

Block starts are multiples of 4 of the frame, and a member's window of the
reference-padded frame starts on a multiple of 4 there, so the UNet's two
max-pools see the frame's grid. The reference's padding
(``add_padding(force=False)``) is applied only where a block's rows meet
the frame's true edges.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..nn.ops import to_nchw, to_nhwc

HALO = 64  # rows of true context a block or strip: > the builder's ~45 px
# receptive field with its reflect-14 pad, the bound the patch stitch's
# 128-px overlap also rests on


@dataclasses.dataclass
class Rows:
    """A block of kept rows [k0, k1) of a frame of ``hp`` rows and the rows
    [u0, u1) it reads: two halos of context each side, clipped to the
    frame (one for the builder's receptive field, one for the members')."""

    hp: int
    k0: int
    k1: int

    @property
    def u0(self) -> int:
        return max(0, self.k0 - 2 * HALO)

    @property
    def u1(self) -> int:
        return min(self.hp, self.k1 + 2 * HALO)


def rank_rows(hp: int, mesh=None) -> Rows:
    """The kept rows of this data rank (``mesh``: dist/mesh.py::Mesh, None
    for one rank): blocks of ceil(hp / (4 n_data)) * 4 rows in rank order.
    A frame whose height is not a multiple of 4 x n_data gives the last
    ranks fewer rows, or none."""
    nd = 1 if mesh is None else mesh.n_data
    d = 0 if mesh is None else mesh.data_index
    per = -(-hp // (4 * nd)) * 4
    return Rows(hp, min(hp, d * per), min(hp, (d + 1) * per))


def ref_pad(n: int) -> Tuple[int, int]:
    """The reference's pad of one side length (``add_padding(force=False)``):
    reflect up to a multiple of 64 unless it is a multiple of 32."""
    if n % 32 == 0:
        return 0, 0
    t = 64 - n % 64
    return t // 2, t - t // 2


def member_window(x_u: torch.Tensor, s_u: torch.Tensor, rows: Rows,
                  base: int) -> Tuple[torch.Tensor, torch.Tensor, slice, slice]:
    """A member UNet's input for the kept rows of ``rows``, from ``x_u``
    (B, h, W, C) and its building score ``s_u`` (B, h, W): the frame's rows
    from ``base`` that hold [rows.u0, rows.u1). The frame's reference
    padding is applied where these rows meet the frame's edges, then the
    window of the padded frame that starts on a multiple of 4 and holds a
    halo of context each side of the kept rows is cut out. Returns (x, s,
    keep, cols): the window's input and score, to run unpadded, and the
    kept rows and the frame's columns in the window's coordinates."""
    px1, px2 = ref_pad(rows.hp)
    py1, py2 = ref_pad(x_u.shape[2])
    x = x_u[:, rows.u0 - base:rows.u1 - base]
    s = s_u[:, rows.u0 - base:rows.u1 - base]
    top = px1 if rows.u0 == 0 else 0
    bot = px2 if rows.u1 == rows.hp else 0
    if top or bot or py1 or py2:
        x = to_nhwc(F.pad(to_nchw(x), (py1, py2, top, bot), mode="reflect"))
        s = F.pad(s, (py1, py2, top, bot))
    p0 = 0 if rows.u0 == 0 else rows.u0 + px1  # padded-frame row of x's first
    k0p, k1p = rows.k0 + px1, rows.k1 + px1
    a0 = max(p0, (k0p - HALO) // 4 * 4)
    a1 = min(p0 + x.shape[1], a0 + -(-(k1p + HALO - a0) // 4) * 4)
    return (x[:, a0 - p0:a1 - p0].contiguous(), s[:, a0 - p0:a1 - p0],
            slice(k0p - a0, k1p - a0), slice(py1, py1 + x_u.shape[2]))

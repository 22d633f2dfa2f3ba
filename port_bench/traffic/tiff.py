"""A minimal tiled Deflate GeoTIFF writer and the reader of what it writes.

The benchmark writes its regions itself, in the format a user's merged
Sentinel mosaics and admin rasters come in (classic little-endian TIFF,
256x256 tiles, Deflate, pixel-interleaved bands, a north-up model
transform and a GDAL nodata tag), so the program under test reads files
it did not write. The plain reference reads the same files back with
``read_tiff``, which decodes only this layout.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

TILE = 256
_SAMPLE_FORMAT = {np.dtype(np.uint16): 1, np.dtype(np.float32): 3}
# TIFF field types: SHORT, LONG, DOUBLE, ASCII
_SHORT, _LONG, _DOUBLE, _ASCII = 3, 4, 12, 2
_TYPE_FMT = {_SHORT: "H", _LONG: "I", _DOUBLE: "d", _ASCII: "s"}
_TYPE_SIZE = {_SHORT: 2, _LONG: 4, _DOUBLE: 8, _ASCII: 1}


def _tiles(h: int, w: int):
    for r in range(0, h, TILE):
        for c in range(0, w, TILE):
            yield r, c


def write_tiff(
    path: str,
    data: np.ndarray,
    *,
    transform: Tuple[float, float, float, float] = (30.0, 1e-4, -1.5, 1e-4),
    nodata: Optional[float] = None,
    level: int = 1,
    threads: int = 8,
) -> None:
    """Write a (bands, h, w) or (h, w) uint16 or float32 array.
    ``transform`` is (origin_x, px_w, origin_y, px_h)."""
    if data.ndim == 2:
        data = data[None]
    dt = np.dtype(data.dtype)
    if dt not in _SAMPLE_FORMAT:
        raise ValueError(f"write_tiff: dtype {dt} is not uint16 or float32")
    spp, h, w = data.shape
    hwc = np.ascontiguousarray(np.moveaxis(data, 0, -1))

    def encode(rc):
        r, c = rc
        tile = np.zeros((TILE, TILE, spp), dt)
        part = hwc[r:r + TILE, c:c + TILE]
        tile[: part.shape[0], : part.shape[1]] = part
        return zlib.compress(tile.tobytes(), level)

    with ThreadPoolExecutor(max_workers=threads) as ex:
        blobs = list(ex.map(encode, list(_tiles(h, w))))

    ox, pw, oy, ph = transform
    entries = [
        (256, _LONG, [w]),
        (257, _LONG, [h]),
        (258, _SHORT, [dt.itemsize * 8] * spp),
        (259, _SHORT, [8]),
        (262, _SHORT, [1]),
        (277, _SHORT, [spp]),
        (284, _SHORT, [1]),
        (322, _LONG, [TILE]),
        (323, _LONG, [TILE]),
        (324, _LONG, [0] * len(blobs)),  # offsets, patched below
        (325, _LONG, [len(b) for b in blobs]),
        (339, _SHORT, [_SAMPLE_FORMAT[dt]] * spp),
        (33550, _DOUBLE, [pw, ph, 0.0]),
        (33922, _DOUBLE, [0.0, 0.0, 0.0, ox, oy, 0.0]),
        (34735, _SHORT, [1, 1, 0, 1, 1024, 0, 1, 2]),
    ]
    if spp > 1:
        entries.append((338, _SHORT, [0] * (spp - 1)))
    if nodata is not None:
        entries.append((42113, _ASCII, [repr(float(nodata)).encode() + b"\0"]))
    entries.sort(key=lambda e: e[0])

    def payload(typ, vals):
        if typ == _ASCII:
            return vals[0]
        return struct.pack("<" + _TYPE_FMT[typ] * len(vals), *vals)

    # layout: header, tile data, out-of-line tag values, IFD
    header = 8
    pos = header
    tile_offsets = []
    for b in blobs:
        tile_offsets.append(pos)
        pos += len(b)
    entries = [(t, ty, tile_offsets if t == 324 else v) for t, ty, v in entries]
    extra = bytearray()
    ifd_entries = []
    extra_base = pos
    for tag, typ, vals in entries:
        raw = payload(typ, vals)
        count = len(raw) if typ == _ASCII else len(vals)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            if (extra_base + len(extra)) % 2:
                extra += b"\0"
            field = struct.pack("<I", extra_base + len(extra))
            extra += raw
        ifd_entries.append(struct.pack("<HHI", tag, typ, count) + field)
    ifd_off = extra_base + len(extra)
    if ifd_off % 2:
        extra += b"\0"
        ifd_off += 1
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_off))
        for b in blobs:
            f.write(b)
        f.write(bytes(extra))
        f.write(struct.pack("<H", len(ifd_entries)))
        for e in ifd_entries:
            f.write(e)
        f.write(struct.pack("<I", 0))


def read_tiff(path: str, threads: int = 8) -> np.ndarray:
    """A file written by ``write_tiff`` as its (bands, h, w) array."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"II*\0":
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    (ifd,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from("<HHI", buf, ifd + 2 + 12 * i)
        size = _TYPE_SIZE[typ] * count
        off = ifd + 2 + 12 * i + 8
        if size > 4:
            (off,) = struct.unpack_from("<I", buf, off)
        if typ == _ASCII:
            tags[tag] = buf[off:off + count]
        else:
            tags[tag] = struct.unpack_from("<" + _TYPE_FMT[typ] * count, buf, off)
    w, h, spp = tags[256][0], tags[257][0], tags[277][0]
    if tags[259][0] != 8 or tags[322][0] != TILE or tags.get(284, (1,))[0] != 1:
        raise ValueError(f"{path}: not the layout write_tiff writes")
    dt = np.dtype(np.float32) if tags[339][0] == 3 else np.dtype(np.uint16)
    out = np.empty((h, w, spp), dt)
    offsets, counts = tags[324], tags[325]

    def decode(i_rc):
        i, (r, c) = i_rc
        tile = np.frombuffer(zlib.decompress(buf[offsets[i]:offsets[i] + counts[i]]), dt)
        tile = tile.reshape(TILE, TILE, spp)
        part = out[r:r + TILE, c:c + TILE]
        part[...] = tile[: part.shape[0], : part.shape[1]]

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(decode, enumerate(_tiles(h, w))))
    return np.ascontiguousarray(np.moveaxis(out, -1, 0))

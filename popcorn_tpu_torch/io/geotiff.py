"""Windowed GeoTIFF I/O over the native C++ library.

The port's host data plane: windowed reads of country-scale
seasonal mosaics and GeoTIFF prediction writes, replacing the reference's
GDAL/rasterio dependency (data/PopulationDataset.py:554-621, 855-880) with
the first-party native library io/native/geotiff.cpp (the port keeps its
own copy of the source).

The native library is compiled with g++ on first use into the package's
build directory (popcorn_tpu_torch/build/).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "geotiff.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_LIB = os.path.join(_BUILD_DIR, "libpopgeotiff.so")

_lib = None
_lib_lock = threading.Lock()

# dtype enum shared with the C++ side
DTYPE_TO_NP = {
    1: np.uint8,
    2: np.int8,
    3: np.uint16,
    4: np.int16,
    5: np.uint32,
    6: np.int32,
    7: np.float32,
    8: np.float64,
}
NP_TO_DTYPE = {
    np.dtype(np.uint8): 1,
    np.dtype(np.uint16): 3,
    np.dtype(np.int16): 4,
    np.dtype(np.int32): 6,
    np.dtype(np.float32): 7,
    np.dtype(np.float64): 8,
}


def _build_lib() -> str:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a per-process name and rename into place: concurrent
    # processes (test workers) may build at once
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
           "-lz", "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_lib())
        lib.gt_open.restype = ctypes.c_void_p
        lib.gt_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.gt_close.argtypes = [ctypes.c_void_p]
        lib.gt_width.restype = ctypes.c_longlong
        lib.gt_width.argtypes = [ctypes.c_void_p]
        lib.gt_height.restype = ctypes.c_longlong
        lib.gt_height.argtypes = [ctypes.c_void_p]
        lib.gt_bands.restype = ctypes.c_int
        lib.gt_bands.argtypes = [ctypes.c_void_p]
        lib.gt_dtype.restype = ctypes.c_int
        lib.gt_dtype.argtypes = [ctypes.c_void_p]
        lib.gt_nodata.restype = ctypes.c_int
        lib.gt_nodata.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.gt_transform.restype = ctypes.c_int
        lib.gt_transform.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.gt_read_window.restype = ctypes.c_int
        lib.gt_read_window.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.gt_read_window_raw.restype = ctypes.c_int
        lib.gt_read_window_raw.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.gtw_create.restype = ctypes.c_void_p
        lib.gtw_create.argtypes = [
            ctypes.c_char_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.gtw_copy_geo.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.gtw_set_transform.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
        ]
        lib.gtw_set_nodata.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.gtw_set_zlevel.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gtw_write.restype = ctypes.c_int
        lib.gtw_write.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.gtw_finish.restype = ctypes.c_int
        lib.gtw_finish.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.gtw_abort.argtypes = [ctypes.c_void_p]
        lib.gt_nan_tile_any.restype = ctypes.c_int
        lib.gt_nan_tile_any.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.gt_has_nan_f32.restype = ctypes.c_int
        lib.gt_has_nan_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        _lib = lib
        return lib


def nan_tile_any(arr: np.ndarray, tile: int = 32) -> np.ndarray:
    """Tile-level NaN presence for a (bands, h, w) or (h, w) array.

    Returns bool (ceil(h/tile), ceil(w/tile)): True where any sample of
    any band inside the tile is NaN — exactly
    ``isnan(arr).any(axis=0)`` block-pooled by ``tile``, but computed in
    one native streaming pass with no full-size temporaries (~5x the
    numpy detour, measured at country-season size, and no (C,H,W) bool
    allocation to pressure a loaded host). Non-f32 or non-contiguous
    input falls back to the numpy formulation.
    """
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"expected (bands, h, w) or (h, w), got {arr.shape}")
    b, h, w = arr.shape
    th, tw = -(-h // tile), -(-w // tile)
    if arr.dtype != np.float32 or not arr.flags.c_contiguous:
        if not _is_float_dtype(arr.dtype):
            return np.zeros((th, tw), bool)  # integer data cannot hold NaN
        mask = np.isnan(arr).any(axis=0)
        pad = np.zeros((th * tile, tw * tile), bool)
        pad[:h, :w] = mask
        return pad.reshape(th, tile, tw, tile).any(axis=(1, 3))
    out = np.empty((th, tw), np.uint8)
    rc = _get_lib().gt_nan_tile_any(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, h, w, tile, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise ValueError(f"gt_nan_tile_any failed for shape {arr.shape}")
    return out.astype(bool)


def _is_float_dtype(dt: np.dtype) -> bool:
    """kind 'f' floats plus ml_dtypes extension floats (bfloat16 etc.
    report kind 'V'; treating them as NaN-free would be a silent trap,
    so they count as floats)."""
    if dt.kind == "f":
        return True
    return "float" in getattr(dt, "name", "")


def _covers_base(arr: np.ndarray, base: np.ndarray) -> bool:
    """True when ``arr`` is a permutation/reshape view touching every
    element of its C-contiguous ``base`` exactly once — size equality
    alone does not prove it (stride-tricks can overlap, so they count as floats).
    Checked by folding (stride, dim) pairs largest-stride-first: a
    bijective view's strides must tile the buffer like a transpose of a
    contiguous layout."""
    if arr.size != base.size:
        return False
    pairs = sorted(
        (s, d) for s, d in zip(arr.strides, arr.shape) if d != 1
    )
    expect = base.itemsize
    for stride, dim in pairs:
        if stride != expect:
            return False
        expect *= dim
    return expect == base.size * base.itemsize


def has_nan(arr: np.ndarray) -> bool:
    """Native streaming ``np.isnan(arr).any()`` for float32 arrays (no
    full-size bool temporary, early exit on the first NaN block); numpy
    fallback otherwise. NaN presence is order-independent, so a
    transpose/reshape view is scanned through its contiguous base when
    the view provably covers every base element exactly once (the
    CHW->HWC views the dataset hands around)."""
    if arr.dtype == np.float32 and not arr.flags.c_contiguous:
        base = arr.base
        if (
            isinstance(base, np.ndarray)
            and base.dtype == np.float32
            and base.flags.c_contiguous
            and _covers_base(arr, base)
        ):
            arr = base
    if arr.dtype == np.float32 and arr.flags.c_contiguous:
        return bool(
            _get_lib().gt_has_nan_f32(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size
            )
        )
    if not _is_float_dtype(arr.dtype):
        return False
    # ml_dtypes extension floats (bfloat16 etc., kind 'V') register
    # np.isnan support, so the numpy path covers them too
    return bool(np.isnan(arr).any())


Window = Tuple[Tuple[int, int], Tuple[int, int]]  # ((row0, row1), (col0, col1))


class GeoTIFF:
    """Read-only handle to a (Big)TIFF/GeoTIFF raster.

    API mirrors the subset of rasterio the reference uses: ``shape``,
    ``count``, ``read(bands, window=((r0,r1),(c0,c1)))`` returning
    float32 (bands, h, w), band indices 1-based.
    """

    def __init__(self, path: str):
        self._lib = _get_lib()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.gt_open(path.encode(), err, 256)
        if not self._h:
            raise IOError(f"GeoTIFF open failed for {path}: {err.value.decode()}")
        self.path = path
        self.height = int(self._lib.gt_height(self._h))
        self.width = int(self._lib.gt_width(self._h))
        self.count = int(self._lib.gt_bands(self._h))
        self.dtype = DTYPE_TO_NP[self._lib.gt_dtype(self._h)]
        nd = ctypes.c_double()
        self.nodata: Optional[float] = (
            nd.value if self._lib.gt_nodata(self._h, ctypes.byref(nd)) else None
        )
        tr = (ctypes.c_double * 6)()
        self.transform: Optional[Tuple[float, ...]] = (
            tuple(tr) if self._lib.gt_transform(self._h, tr) else None
        )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def read(
        self,
        bands: Optional[Sequence[int]] = None,
        window: Optional[Window] = None,
        squeeze: bool = False,
        raw: bool = False,
    ) -> np.ndarray:
        """raw=True returns the file's NATIVE dtype with no conversion —
        half the memory traffic for uint16 mosaics."""
        if self._h is None:
            raise IOError("closed")
        if bands is None:
            bands = list(range(1, self.count + 1))
        elif isinstance(bands, int):
            bands = [bands]
        if window is None:
            window = ((0, self.height), (0, self.width))
        (r0, r1), (c0, c1) = window
        h, w = int(r1 - r0), int(c1 - c0)
        if h <= 0 or w <= 0:
            raise ValueError(f"empty window {window}")
        out = np.empty((len(bands), h, w), self.dtype if raw else np.float32)
        barr = (ctypes.c_int * len(bands))(*bands)
        err = ctypes.create_string_buffer(256)
        if raw:
            rc = self._lib.gt_read_window_raw(
                self._h, barr, len(bands), int(c0), int(r0), w, h,
                out.ctypes.data_as(ctypes.c_void_p), err, 256,
            )
        else:
            rc = self._lib.gt_read_window(
                self._h, barr, len(bands), int(c0), int(r0), w, h,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256,
            )
        if rc != 0:
            raise IOError(
                f"read_window failed on {self.path} {window}: {err.value.decode()}"
            )
        return out[0] if (squeeze and len(bands) == 1) else out

    def close(self):
        if self._h is not None:
            self._lib.gt_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_geotiff(
    path: str,
    data: np.ndarray,
    *,
    template: Optional[str] = None,
    transform: Optional[Tuple[float, float, float, float]] = None,
    nodata: Optional[float] = None,
    dtype: Optional[np.dtype] = None,
    tile: int = 256,
    zlevel: int = 1,
) -> None:
    """Write a (bands,h,w) or (h,w) array as a tiled deflate GeoTIFF.

    Geo-referencing either copied from a ``template`` raster (the way the
    reference writes predictions with the boundary raster's metadata,
    PopulationDataset.py:144-147, 855-880) or given as a north-up
    ``transform`` (origin_x, px_w, origin_y, px_h).
    """
    lib = _get_lib()
    if data.ndim == 2:
        data = data[None]
    bands, h, w = data.shape
    dt = NP_TO_DTYPE[np.dtype(dtype or np.float32)]
    err = ctypes.create_string_buffer(256)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    hw = lib.gtw_create(path.encode(), w, h, bands, dt, tile, err, 256)
    if not hw:
        raise IOError(f"create failed for {path}: {err.value.decode()}")
    try:
        if template is not None:
            with GeoTIFF(template) as src:
                lib.gtw_copy_geo(hw, src._h)
        elif transform is not None:
            ox, pw, oy, ph = transform
            lib.gtw_set_transform(hw, ox, pw, oy, ph)
        if nodata is not None:
            lib.gtw_set_nodata(hw, nodata)
        lib.gtw_set_zlevel(hw, zlevel)
        buf = np.ascontiguousarray(data, np.float32)
        if lib.gtw_write(hw, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256):
            raise IOError(f"write failed: {err.value.decode()}")
        if lib.gtw_finish(hw, err, 256):
            raise IOError(f"finish failed: {err.value.decode()}")
        hw = None
    finally:
        if hw:
            lib.gtw_abort(hw)

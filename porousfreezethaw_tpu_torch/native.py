"""ctypes bindings for the native C++ IO library (native/dataio.cc).

The counterpart of ``porousfreezethaw_tpu/native.py``, which this package
does not import.  Loads the repository's ``native/libpftdataio.so``,
building it on first use if a C++ compiler is available (into a temporary
file renamed into place, so that concurrent first uses never load a
half-written library); every consumer has a pure-Python fallback with the
same bytes, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpftdataio.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        src = os.path.join(_NATIVE_DIR, "dataio.cc")
        if not os.path.exists(src):
            return None
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.pft_append_f64_be.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.pft_append_f64_be.restype = ctypes.c_int
    lib.pft_write_dem_csv_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.c_int64]
    lib.pft_write_dem_csv_rows.restype = ctypes.c_int
    lib.pft_write_ascii_values.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32]
    lib.pft_write_ascii_values.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def write_dem_csv_rows(path: str, header: str, rows: np.ndarray) -> bool:
    """Write a (nrows, ncols) float table as the DEM CSV format.
    Returns False if the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rows, dtype=np.float64)
    code = lib.pft_write_dem_csv_rows(
        path.encode(), header.encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[1], arr.shape[0])
    if code != 0:
        raise OSError(f"native CSV write failed ({code}): {path}")
    return True


def append_f64_be(path: str, data: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.float64).reshape(-1)
    code = lib.pft_append_f64_be(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.size)
    if code != 0:
        raise OSError(f"native f64 append failed ({code}): {path}")
    return True

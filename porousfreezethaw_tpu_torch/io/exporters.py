"""Grid import/export utilities — the dataIO library equivalent.

Re-implements the reference's ``libsource/dataIO`` formats
(``include/dataIO.h:40-395``): VTK STRUCTURED_POINTS (legacy ASCII),
plain ASCII tables, gnuplot splot matrices, and PGM/PPM images, each with
an import counterpart; plus the ASCII floating-point precision switch
(``set_export_fp_precision``, dataIO.h:38-47).

A numpy-only copy of ``porousfreezethaw_tpu/io/exporters.py``, writing the
same bytes (the default VTK comment names the JAX package, as its files
do).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

_FP_PRECISION = 6  # significant digits (dataIO.h default)


def set_export_fp_precision(precision: int) -> None:
    global _FP_PRECISION
    _FP_PRECISION = int(precision)


def _fmt(value) -> str:
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return f"{value:.{_FP_PRECISION}g}"


# ---------------------------------------------------------------------------
# VTK STRUCTURED_POINTS (VTK_export / VTK_import, dataIO.h:50-99)
# ---------------------------------------------------------------------------

def vtk_export(path: str, data: np.ndarray, comment: str = "",
               values_per_line: int = 6,
               origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)) -> None:
    """Write a 3-D scalar field (z, y, x) as legacy VTK STRUCTURED_POINTS."""
    arr = np.asarray(data)
    if arr.ndim != 3:
        raise ValueError("vtk_export expects a 3-D (z, y, x) array")
    zd, yd, xd = arr.shape
    is_int = np.issubdtype(arr.dtype, np.integer)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write((comment or "exported by porousfreezethaw_tpu") + "\n")
        f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {xd} {yd} {zd}\n")
        f.write(f"ORIGIN {origin[0]:g} {origin[1]:g} {origin[2]:g}\n")
        f.write(f"SPACING {spacing[0]:g} {spacing[1]:g} {spacing[2]:g}\n")
        f.write(f"POINT_DATA {xd * yd * zd}\n")
        f.write(f"SCALARS data {'int' if is_int else 'double'} 1\n")
        f.write("LOOKUP_TABLE default\n")
        flat = arr.reshape(-1)
        for start in range(0, flat.size, values_per_line):
            f.write(" ".join(_fmt(v) for v in flat[start:start + values_per_line]))
            f.write("\n")


def vtk_get_grid_dim(path: str) -> Tuple[int, int, int]:
    """(x_dim, y_dim, z_dim) of a VTK structured-points file
    (VTK_GetGridDim, dataIO.h:77)."""
    with open(path) as f:
        for line in f:
            m = re.match(r"DIMENSIONS\s+(\d+)\s+(\d+)\s+(\d+)", line)
            if m:
                return int(m.group(1)), int(m.group(2)), int(m.group(3))
    raise ValueError(f"{path}: no DIMENSIONS record")


def vtk_import(path: str) -> np.ndarray:
    """Read back a legacy VTK STRUCTURED_POINTS scalar field -> (z, y, x)."""
    xd, yd, zd = vtk_get_grid_dim(path)
    values = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                values.extend(float(v) for v in line.split())
            elif line.startswith("LOOKUP_TABLE"):
                in_data = True
    arr = np.asarray(values[:xd * yd * zd])
    return arr.reshape(zd, yd, xd)


# ---------------------------------------------------------------------------
# plain ASCII (plain_export / plain_import, dataIO.h:117-204)
# ---------------------------------------------------------------------------

def plain_export(path: str, data: np.ndarray, comment: str = "") -> None:
    """Rows of whitespace-separated values; '#' comment first."""
    arr = np.atleast_2d(np.asarray(data))
    with open(path, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        for row in arr:
            f.write(" ".join(_fmt(v) for v in row) + "\n")


def plain_import(path: str) -> np.ndarray:
    return np.loadtxt(path, comments="#", ndmin=2)


# ---------------------------------------------------------------------------
# gnuplot (gnuplot_export, dataIO.h:152-189): one "x y value" triple per
# line, blank line between x-rows — directly splottable
# ---------------------------------------------------------------------------

def gnuplot_export(path: str, data: np.ndarray, comment: str = "") -> None:
    arr = np.asarray(data)
    if arr.ndim != 2:
        raise ValueError("gnuplot_export expects a 2-D (y, x) array")
    with open(path, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        for j in range(arr.shape[0]):
            for i in range(arr.shape[1]):
                f.write(f"{i} {j} {_fmt(arr[j, i])}\n")
            f.write("\n")


# ---------------------------------------------------------------------------
# PGM / PPM (PGM_export / PPM_export, dataIO.h:234-395)
# ---------------------------------------------------------------------------

def _to_gray(data: np.ndarray, maxcolor: int) -> np.ndarray:
    arr = np.asarray(data)
    if np.issubdtype(arr.dtype, np.integer):
        return np.clip(arr, 0, maxcolor).astype(np.int64)
    # float data expected in [0, 1], scaled to the grayscale range
    return np.clip(np.round(arr * maxcolor), 0, maxcolor).astype(np.int64)


def pgm_export(path: str, data: np.ndarray, maxcolor: int = 255,
               comment: str = "", binary: bool = True) -> None:
    """Grayscale image; float input in [0,1], int input in [0,maxcolor]."""
    gray = _to_gray(data, maxcolor)
    h, w = gray.shape
    header = f"P5\n# {comment}\n{w} {h}\n{maxcolor}\n" if binary else \
        f"P2\n# {comment}\n{w} {h}\n{maxcolor}\n"
    if binary:
        dt = ">u2" if maxcolor > 255 else "u1"
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(gray.astype(dt).tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for row in gray:
                f.write(" ".join(str(int(v)) for v in row) + "\n")


def ppm_export(path: str, r: np.ndarray, g: np.ndarray, b: np.ndarray,
               maxcolor: int = 255, comment: str = "",
               binary: bool = True) -> None:
    rgb = np.stack([_to_gray(r, maxcolor), _to_gray(g, maxcolor),
                    _to_gray(b, maxcolor)], axis=-1)
    h, w, _ = rgb.shape
    magic = "P6" if binary else "P3"
    header = f"{magic}\n# {comment}\n{w} {h}\n{maxcolor}\n"
    if binary:
        dt = ">u2" if maxcolor > 255 else "u1"
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(rgb.astype(dt).tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for row in rgb.reshape(h, -1):
                f.write(" ".join(str(int(v)) for v in row) + "\n")


def pnm_get_dim(path: str) -> Tuple[int, int, str]:
    """(width, height, type) of a PGM/PPM file (PNM_GetDim, dataIO.h:223)."""
    with open(path, "rb") as f:
        magic = f.read(2).decode()
        tokens = []
        while len(tokens) < 2:
            line = f.readline().decode()
            if line.startswith("#"):
                continue
            tokens.extend(line.split())
    return int(tokens[0]), int(tokens[1]), magic


def pnm_import(path: str) -> np.ndarray:
    """Read a P2/P5 PGM or P3/P6 PPM into an int array (h, w[, 3])."""
    with open(path, "rb") as f:
        magic = f.read(2).decode()
        tokens: list[bytes] = []
        while len(tokens) < 3:
            line = f.readline()
            if line.startswith(b"#"):
                continue
            tokens.extend(line.split())
        w, h, maxc = int(tokens[0]), int(tokens[1]), int(tokens[2])
        channels = 3 if magic in ("P3", "P6") else 1
        count = w * h * channels
        if magic in ("P5", "P6"):
            dt = ">u2" if maxc > 255 else "u1"
            data = np.frombuffer(f.read(), dtype=dt)[:count].astype(np.int64)
        else:
            data = np.asarray(f.read().split()[:count], dtype=np.int64)
    shape = (h, w, 3) if channels == 3 else (h, w)
    return data.reshape(shape)

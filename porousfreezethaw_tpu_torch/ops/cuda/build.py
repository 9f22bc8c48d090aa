"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` into one shared library with a
plain C interface, ``build/kernels/libpft_kernels.so`` beside the package,
and loaded with ctypes.  The build runs at first use and again whenever
the hash of the sources, the headers or the flags changes.  No PyTorch
header is included, so a build takes seconds.

Nothing here falls back: without ``nvcc`` or a CUDA device the build or
the load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
SOURCES = ("fused_stage.cu", "delta_g.cu")
HEADERS = ("freezing.cuh",)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libpft_kernels.so"

# sm_90a (Hopper with its architecture-specific features); IEEE division
# and square root and no --use_fast_math: the kernels call expf/sqrtf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


@dataclass
class BuildResult:
    path: Path
    rebuilt: bool
    seconds: float
    log: str          # nvcc's output (ptxas register and spill report)


def build(force: bool = False) -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for the current sources
    exists already."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return BuildResult(lib, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    stamp.write_text(digest + "\n")
    (BUILD_DIR / (LIB_NAME + ".log")).write_text(log)
    return BuildResult(lib, True, seconds, log)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pft_num_consts.argtypes = []
    lib.pft_num_consts.restype = ci
    lib.pft_eps_blocks.argtypes = [ci, ci, ci]
    lib.pft_eps_blocks.restype = ctypes.c_longlong
    lib.pft_error_string.argtypes = [ci]
    lib.pft_error_string.restype = ctypes.c_char_p
    # consts, mode, nk, stage5, t, h, coefs, w, k0, k1, k2, out, eps,
    # Z, Y, X, stream
    lib.pft_fused_stage.argtypes = [vp, ci, ci, ci, cf, cf, vp, vp, vp, vp,
                                    vp, vp, vp, ci, ci, ci, vp]
    lib.pft_fused_stage.restype = ci
    # consts, mode, nk, stage5, h, D1, dDi, coefs, w, k0, k1, k2, out, eps,
    # Z, Y, X, stream
    lib.pft_delta_g.argtypes = [vp, ci, ci, ci, cf, cf, cf, vp, vp, vp, vp,
                                vp, vp, vp, ci, ci, ci, vp]
    lib.pft_delta_g.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library once per process."""
    return _declare(ctypes.CDLL(str(build().path)))

"""Build and load the CUDA kernels of ``csrc/``.

Each source is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface, ``build/kernels/libpft_kernels.so`` beside the package, which
is loaded with ctypes.  The build runs at first use and again whenever the
hash of the sources, the headers or the flags changes.  No PyTorch header
is included, so a build takes seconds.

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
SOURCES = ("fused_stage.cu", "fused_attempt.cu", "delta_g.cu")
HEADERS = ("freezing.cuh", "stage.cuh")
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libpft_kernels.so"

# sm_90a (Hopper with its architecture-specific features); IEEE division
# and square root and no --use_fast_math: the kernels call expf/sqrtf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in compiles]
    steps = []                      # (command, exit code, output)
    for cmd, proc in procs:
        out, _ = proc.communicate()
        steps.append((cmd, proc.returncode, out))
    if all(rc == 0 for _, rc, _ in steps):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.returncode, proc.stdout + proc.stderr))
    seconds = time.perf_counter() - t0
    log = "".join(out for _, _, out in steps)
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(cmd, rc, out) for cmd, rc, out in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, out = failed[0]
        raise KernelBuildError(
            f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
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
    # consts, mode, nk, tail, t, h, coefs, y2, cur, k0, k1, k2, out, eps,
    # Z, Y, X, stream
    lib.pft_fused_attempt.argtypes = [vp, ci, ci, ci, cf, cf, vp, vp, vp, vp,
                                      vp, vp, vp, vp, ci, ci, ci, vp]
    lib.pft_fused_attempt.restype = ci
    # consts, mode, nk, tail, h, D1, dDi, coefs, w, k0, k1, k2, out, eps,
    # Z, Y, X, stream
    lib.pft_delta_g.argtypes = [vp, ci, ci, ci, cf, cf, cf, vp, vp, vp, vp,
                                vp, vp, vp, ci, ci, ci, vp]
    lib.pft_delta_g.restype = ci
    # the shard entries: the arguments of their single-device entry, then
    # glo, ghi, part (stage) or is_top (delta), r0, Yl, y0, Yg
    shard = [vp, vp, ci, ci, ci, ci, ci]
    lib.pft_fused_stage_shard.argtypes = lib.pft_fused_stage.argtypes + shard
    lib.pft_fused_stage_shard.restype = ci
    lib.pft_delta_g_shard.argtypes = lib.pft_delta_g.argtypes + shard
    lib.pft_delta_g_shard.restype = ci
    lib.pft_shard_eps_blocks.argtypes = [ci, ci, ci, ci]
    lib.pft_shard_eps_blocks.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library once per process."""
    return _declare(ctypes.CDLL(str(build().path)))

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
from dataclasses import dataclass
from pathlib import Path

from ...core import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
SOURCES = ("fused_stage.cu", "fused_attempt.cu", "delta_g.cu", "control.cu")
HEADERS = ("freezing.cuh", "tile.cuh", "stage.cuh", "control.cuh")
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libpft_kernels.so"

# sm_90a (Hopper with its architecture-specific features); IEEE division
# and square root and no --use_fast_math: the kernels call expf/sqrtf (and
# exp/sqrt in the stage kernel's float64 instantiation).
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
    seconds: float    # nvcc's compiles and link: the pft.kernels.build span
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
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
    steps = []                      # (command, exit code, output)
    with tracing.span("pft.kernels.build") as sp:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in compiles]
        for cmd, proc in procs:
            out, _ = proc.communicate()
            steps.append((cmd, proc.returncode, out))
        if all(rc == 0 for _, rc, _ in steps):
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.returncode, proc.stdout + proc.stderr))
    seconds = sp.seconds
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
    cll = ctypes.c_longlong
    lib.pft_num_consts.argtypes = []
    lib.pft_num_consts.restype = ci
    lib.pft_error_string.argtypes = [ci]
    lib.pft_error_string.restype = ctypes.c_char_p
    # consts, mode, nk, stage5, t, h, coefs, w, k0, k1, k2, out, eps,
    # Z, Y, X, stream, eps_n (the slots of eps)
    lib.pft_fused_stage.argtypes = [vp, ci, ci, ci, cf, cf, vp, vp, vp, vp,
                                    vp, vp, vp, ci, ci, ci, vp, cll]
    lib.pft_fused_stage.restype = ci
    # consts, mode, nk, tail, t, h, coefs, y2, cur, k0, k1, k2, out, eps,
    # Z, Y, X, stream, eps_n
    lib.pft_fused_attempt.argtypes = [vp, ci, ci, ci, cf, cf, vp, vp, vp, vp,
                                      vp, vp, vp, vp, ci, ci, ci, vp, cll]
    lib.pft_fused_attempt.restype = ci
    # consts, mode, nk, tail, h, D1, dDi, coefs, w, k0, k1, k2, out, eps,
    # Z, Y, X, stream, eps_n
    lib.pft_delta_g.argtypes = [vp, ci, ci, ci, cf, cf, cf, vp, vp, vp, vp,
                                vp, vp, vp, ci, ci, ci, vp, cll]
    lib.pft_delta_g.restype = ci
    # the _dev entries: the arguments of their single-device entry with
    # (ctl, stage) in place of the scalars
    lib.pft_fused_stage_dev.argtypes = [vp, ci, ci, ci, vp, ci, vp, vp, vp,
                                        vp, vp, vp, vp, ci, ci, ci, vp, cll]
    lib.pft_fused_stage_dev.restype = ci
    lib.pft_fused_attempt_dev.argtypes = [vp, ci, ci, ci, vp, ci, vp, vp, vp,
                                          vp, vp, vp, vp, vp, ci, ci, ci, vp,
                                          cll]
    lib.pft_fused_attempt_dev.restype = ci
    lib.pft_delta_g_dev.argtypes = lib.pft_fused_stage_dev.argtypes
    lib.pft_delta_g_dev.restype = ci
    # the float64 _dev entry of the stage kernel: the same arguments, its
    # arrays float64
    lib.pft_fused_stage_dev64.argtypes = lib.pft_fused_stage_dev.argtypes
    lib.pft_fused_stage_dev64.restype = ci
    # the controller (control.cu): ctl, stream; ctl, mode, hi, lo, src,
    # cur, n, elem_bytes, stream; q, out, n, stream
    lib.pft_control_size.argtypes = []
    lib.pft_control_size.restype = ci
    lib.pft_merson_control.argtypes = [vp, vp]
    lib.pft_merson_control.restype = ci
    lib.pft_commit.argtypes = [vp, ci, vp, vp, vp, vp, cll, ci, vp]
    lib.pft_commit.restype = ci
    lib.pft_pow_02.argtypes = [vp, vp, cll, vp]
    lib.pft_pow_02.restype = ci
    # the shard entries: the arguments of their single-device entry, then
    # glo, ghi, part (stage) or is_top (delta), r0, Yl, y0, Yg
    shard = [vp, vp, ci, ci, ci, ci, ci]
    lib.pft_fused_stage_shard.argtypes = lib.pft_fused_stage.argtypes + shard
    lib.pft_fused_stage_shard.restype = ci
    lib.pft_delta_g_shard.argtypes = lib.pft_delta_g.argtypes + shard
    lib.pft_delta_g_shard.restype = ci
    # the shard entries' _dev entries: the _dev arguments, then the shard
    # arguments (the stage's with both part and is_top)
    lib.pft_fused_stage_shard_dev.argtypes = (
        lib.pft_fused_stage_dev.argtypes + [vp, vp, ci, ci, ci, ci, ci, ci])
    lib.pft_fused_stage_shard_dev.restype = ci
    lib.pft_delta_g_shard_dev.argtypes = lib.pft_delta_g_dev.argtypes + shard
    lib.pft_delta_g_shard_dev.restype = ci
    # the eps slots of a tail launch: (mode, part, Z, Yl, X),
    # (mode, Z, Y, X) and (mode, tail, Z, Yl, X)
    lib.pft_stage_eps_blocks.argtypes = [ci, ci, ci, ci, ci]
    lib.pft_stage_eps_blocks.restype = cll
    # ... of the float64 stage tail: (mode, Z, Y, X)
    lib.pft_stage_eps_blocks64.argtypes = [ci, ci, ci, ci]
    lib.pft_stage_eps_blocks64.restype = cll
    lib.pft_attempt_eps_blocks.argtypes = [ci, ci, ci, ci]
    lib.pft_attempt_eps_blocks.restype = cll
    lib.pft_delta_eps_blocks.argtypes = [ci, ci, ci, ci, ci]
    lib.pft_delta_eps_blocks.restype = cll
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library once per process
    (the ``pft.kernels.load`` span: the sources' hash, the build where it
    runs, the load)."""
    with tracing.span("pft.kernels.load") as sp:
        res = build()
        sp.attrs["rebuilt"] = res.rebuilt
        return _declare(ctypes.CDLL(str(res.path)))

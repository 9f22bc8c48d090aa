"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and it never falls back to the CPU when CUDA is asked for."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import porousfreezethaw_tpu_torch
from porousfreezethaw_tpu_torch.core.device import (
    DeviceError, field_dtype, resolve_device)
from porousfreezethaw_tpu_torch.ops.cuda import build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Importing every module of the port (the app first) in a fresh
    interpreter loads neither jax nor porousfreezethaw_tpu."""
    names = [m.name for m in pkgutil.walk_packages(
        porousfreezethaw_tpu_torch.__path__, "porousfreezethaw_tpu_torch.")]
    assert {"porousfreezethaw_tpu_torch." + m for m in (
        "apps.intertrack", "apps.spheres", "bench", "analysis", "native",
        "parallel.fused", "parallel.halo", "parallel.sharding",
        "models.dem.config",
        "models.dem.icond", "models.dem.coupling", "models.dem.forces",
        "solvers.merson", "solvers.rk4", "solvers.dopri", "io.csv_snaps",
        "io.exporters", "convert", "ops.cuda.control",
        "models.dem.attempt", "models.freezing.attempt")} <= set(names)
    code = (
        "import importlib, sys\n"
        "import porousfreezethaw_tpu_torch.apps.intertrack\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'porousfreezethaw_tpu'"
        " or m.startswith('porousfreezethaw_tpu.'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_resolve_device_cuda_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        resolve_device("cuda")
    with pytest.raises(DeviceError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_gives_cuda_its_index(monkeypatch):
    """A bare 'cuda' resolves to the indexed device that a tensor made
    there reports, so device checks such as the freezing RHS's accept it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 1)


def test_field_dtype():
    assert field_dtype("f32") is torch.float32
    assert field_dtype("f64") is torch.float64
    with pytest.raises(ValueError):
        field_dtype("bf16")


def test_app_device_cuda_raises_without_gpu(monkeypatch, tmp_path):
    """``--device cuda`` (the default) on a machine without a GPU raises
    instead of running on the CPU."""
    from porousfreezethaw_tpu_torch.apps.intertrack import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pfile = tmp_path / "Params"
    pfile.write_text("saved_files 1\n")
    with pytest.raises(DeviceError):
        main([str(pfile), "--precision", "f32"])


def test_build_without_nvcc_raises(monkeypatch):
    """No nvcc: the kernel build raises; nothing falls back."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(build.KernelBuildError):
        build.find_nvcc()

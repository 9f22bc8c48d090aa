"""Device and dtype policy.

The counterpart of ``porousfreezethaw_tpu/core/precision.py``.  There is
no process-wide default here: every function that makes a tensor takes an
explicit ``device`` and ``dtype``, and nothing reads
``torch.get_default_dtype()``.

* Field dtype: float64 for validation runs (the reference's
  ``FLOAT=double``), float32 for production runs on the GPU.
* Controller scalars (t, h, eps) are Python floats, i.e. f64, whatever the
  field dtype (see ``solvers/merson.py``).
* ``resolve_device("cuda")`` raises when no CUDA device is present; it
  never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

FIELD_DTYPES = {"f32": torch.float32, "f64": torch.float64}


class DeviceError(RuntimeError):
    pass


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name`` ('cuda', 'cuda:1', 'cpu'); raises
    :class:`DeviceError` when a CUDA device is asked for and none exists.
    A bare 'cuda' gets the current device's index, as every tensor's
    device has one, so that the result compares equal to ``x.device``."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise DeviceError(
                f"device {str(name)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise DeviceError(f"unsupported device type {dev.type!r}")
    return dev


def field_dtype(precision: str) -> torch.dtype:
    """Field dtype for a ``--precision`` value ('f32' or 'f64')."""
    try:
        return FIELD_DTYPES[precision]
    except KeyError:
        raise ValueError(f"precision must be one of {sorted(FIELD_DTYPES)}, "
                         f"got {precision!r}") from None


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch field dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str], device: torch.device):
    """torch.profiler over the block (CPU activities, and CUDA's on a
    CUDA ``device``), its Chrome trace written to
    ``profile_dir/trace.json``; nothing without a directory.  Yields the
    trace's path or None."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(profile_dir, "trace.json")
    with profile(activities=acts) as prof:
        yield path
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(path)

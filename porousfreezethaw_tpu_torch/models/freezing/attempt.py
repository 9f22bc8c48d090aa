"""The plain-RHS freezing attempt on the device protocol of the
device-resident loop (``solvers/merson.py merson_solve_device``).

The counterpart of the JAX app's jitted, chunked ``merson_solve(rhs, ...)``
over ``make_rhs`` (``porousfreezethaw_tpu/apps/intertrack.py:352-409``,
the loop body ``porousfreezethaw_tpu/solvers/merson.py:258-266``): the
path of every f64 run and of every f32 run with a noise field.  The JAX
``make_rhs`` is XLA and reaches no Pallas kernel; here the stages are the
plain PyTorch right-hand side of ``equation.make_rhs``, which reads its
stage time from the control block (``ControlBlock.ts64``, a 0-d float64
view) and decides the Dirichlet top on the device; the step control and
the commit are the control and commit kernels of ``csrc/control.cu``, on
one eps partial and a copy in the field's width (float64, or float32 on
the noise path).  The attempt is ``ops/cuda/control.py`` ``RHSAttempt``,
the body the DEM's attempt shares, so it gives the host loop's state, t,
h, counts and trace bit for bit (tests/test_torch_freezing_device.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...ops.cuda.control import RHSAttempt


class PlainAttempt(RHSAttempt):
    """One Merson attempt of the single-device freezing right-hand side
    ``rhs`` (``make_rhs``) on one static state of shape (3, n3, n2, n1)
    (``shape`` is (n3, n2, n1)) and ``dtype``: the stage-5 update into
    ``spec`` of the same shape, and one eps slot, the NaN-propagating max
    of the error over the whole state."""

    def __init__(self, rhs, shape: Tuple[int, int, int],
                 dtype: torch.dtype):
        self.rhs = rhs
        self.shape = (3,) + tuple(int(n) for n in shape)
        self.dtype = dtype

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        y = torch.empty(self.shape, dtype=self.dtype, device=device)
        spec = torch.empty_like(y)
        eps = torch.empty(1, dtype=self.dtype, device=device)
        return {"y": y, "leaves": y, "spec": spec, "spec_leaves": spec,
                "eps": eps, "eps_leaves": eps[0]}

    def _dev_load(self, b: dict, y: torch.Tensor) -> None:
        dst = b["y"]
        if not (torch.is_tensor(y) and y.shape == dst.shape
                and y.dtype == dst.dtype and y.device == dst.device):
            what = (f"{y.dtype} {tuple(y.shape)} on {y.device}"
                    if torch.is_tensor(y) else type(y).__name__)
            raise ValueError(
                f"PlainAttempt expects a {dst.dtype} state of shape "
                f"{tuple(dst.shape)} on {dst.device}, got {what}")
        dst.copy_(y)

    def _dev_unpack(self, b: dict) -> torch.Tensor:
        return b["y"].clone()

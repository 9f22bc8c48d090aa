"""The DEM's Merson attempt on the device protocol of the device-resident
loop (``solvers/merson.py merson_solve_device``).

The counterpart of the JAX DEM solve's ``lax.while_loop`` over the dict
state (``porousfreezethaw_tpu/solvers/merson.py:135-385``, jitted by the
JAX spheres app).  The JAX DEM reaches no Pallas kernel: its pair term is
XLA.  Here the stages are the plain PyTorch right-hand side of
``forces.make_dem_rhs`` (the dense term or a cell strategy, on one
device); the step control and the commit are the control and commit
kernels of ``csrc/control.cu`` (``ops/cuda/control.py``), on eps partials
and leaves of the state's width (float64 or float32).  An attempt
allocates nothing that outlives it, reads h from the control block and
copies nothing from the host, so a block of attempts is one CUDA graph
and the host reads the control block back once per block.

``dem_solver`` is the one place that decides which loop a DEM solve runs:
the device loop on the card without a mesh, else the host loop; the
spheres app and the bench take what it returns, and
``forces.solve_guarded`` dispatches on it.

Bits: an attempt is ``merson_solve``'s plain-RHS attempt on the dict
state, operation for operation: the five stages, ``leaf_eps`` of each
leaf and the accepted update ``y + (0.5 (K1 + K5) + 2 K4) * h/3``.  Its
scalars h/3, h/6, h/8 and h are 0-d float64 views of the control block
(``ControlBlock.hs``), formed there as the host loop's Python floats are,
and a 0-d float64 tensor in ``x * a`` rounds ``a`` to the field dtype as
a Python float does; so the device loop gives the host loop's state, t,
h and counts bit for bit (tests/test_torch_dem_device.py).

What an idle attempt costs: the stage kernels of the freezing paths
return at once on a halted loop; these stages are PyTorch operations,
which cannot, so each idle attempt of a block that ends past the loop's
end runs its five right-hand sides (the control kernel sets accept to 0
and the commit copies nothing): 2.4% of the settle's wall on the card
(PERF.md), within the graph's ``BLOCK``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...ops.cuda.control import (
    COMMIT_COPY, ControlBlock, DeviceAttempt, commit, merson_control)
from ...solvers.merson import _axpy, _leaves


class DEMAttempt(DeviceAttempt):
    """One Merson attempt of the single-device DEM right-hand side ``rhs``
    (``make_dem_rhs``: dense, ``cell_list`` or ``cell_lanes``; a ``mesh=``
    right-hand side is refused) on the dict state {pos, vel[, angvel]} of
    ``rhs``'s config and dtype.

    The device buffers: one static state of shape (L, n, 3), L the number
    of leaves, with a view per leaf; the stage-5 output ``spec`` of the
    same shape; L eps slots in the field dtype, one leaf maximum each,
    which the control kernel reduces.  ``neighbor_struct`` is the right-hand side's cell structure (None for
    the dense term), which ``forces.solve_guarded`` checks between
    chunks."""

    def __init__(self, rhs):
        if getattr(rhs, "mesh", None) is not None:
            raise ValueError(
                "DEMAttempt takes a single-device DEM right-hand side; a "
                "mesh= right-hand side runs the host loop (merson_solve)")
        cfg = rhs.cfg
        self.rhs = rhs
        self.n = cfg.n
        self.dtype = rhs.dtype
        self.keys = (("pos", "vel", "angvel") if cfg.angular
                     else ("pos", "vel"))
        self.neighbor_struct = rhs.neighbor_struct

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        shape = (len(self.keys), self.n, 3)
        y = torch.empty(shape, dtype=self.dtype, device=device)
        return {"y": y, "leaves": dict(zip(self.keys, y.unbind(0))),
                "spec": torch.empty_like(y),
                "eps": torch.empty(len(self.keys), dtype=self.dtype,
                                   device=device)}

    def _dev_load(self, b: dict, y: Dict[str, torch.Tensor]) -> None:
        if not isinstance(y, dict) or set(y) != set(self.keys):
            raise ValueError(f"DEMAttempt expects a dict state with leaves "
                             f"{self.keys}, got {type(y).__name__}")
        for k in self.keys:
            v, dst = y[k], b["leaves"][k]
            if (v.shape != dst.shape or v.dtype != dst.dtype
                    or v.device != dst.device):
                raise ValueError(
                    f"DEMAttempt: leaf {k} is {v.dtype} {tuple(v.shape)} "
                    f"on {v.device}, want {dst.dtype} {tuple(dst.shape)} "
                    f"on {dst.device}")
            dst.copy_(v)

    def _dev_attempt(self, ctl: ControlBlock, b: dict) -> None:
        # merson_solve's plain-RHS attempt; the DEM's right-hand side does
        # not read t
        h3, h6, h8, h = ctl.hs
        f, y = self.rhs, b["leaves"]
        K1 = f(None, y)
        K2 = f(None, _axpy(h3, K1, y))
        K3 = f(None, _axpy(h6, _leaves(torch.add, K1, K2), y))
        K4 = f(None, _axpy(h8, _leaves(lambda a, c: a + 3.0 * c, K1, K3),
                           y))
        K5 = f(None, _axpy(h, _leaves(
            lambda a, c, d: 0.5 * a - 1.5 * c + 2.0 * d, K1, K3, K4), y))
        eps, spec = b["eps"], b["spec"]
        for i, k in enumerate(self.keys):
            torch.amax(torch.abs(0.2 * K1[k] - 0.9 * K3[k] + 0.8 * K4[k]
                                 - 0.1 * K5[k]), out=eps[i])
            torch.add(y[k], (0.5 * (K1[k] + K5[k]) + 2.0 * K4[k]) * h3,
                      out=spec[i])
        merson_control(ctl)
        commit(ctl, COMMIT_COPY, b["y"], src=spec)

    def _dev_unpack(self, b: dict) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in b["leaves"].items()}


def uses_device_loop(device: torch.device, mesh) -> bool:
    """Whether a DEM solve on ``device`` runs the device-resident loop: on
    the card, without a mesh."""
    return device.type == "cuda" and mesh is None


def dem_solver(rhs, device: torch.device):
    """What ``forces.solve_guarded`` takes for the DEM right-hand side
    ``rhs`` on ``device``: a :class:`DEMAttempt` where the device loop
    serves it (``uses_device_loop``), else ``rhs`` itself (the host
    loop)."""
    return DEMAttempt(rhs) if uses_device_loop(device, rhs.mesh) else rhs

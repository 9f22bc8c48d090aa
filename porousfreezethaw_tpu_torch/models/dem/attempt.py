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
state, operation for operation: the body of ``ops/cuda/control.py``
``RHSAttempt``, which the freezing f64 and noise paths share.  Its
scalars h/3, h/6, h/8 and h are 0-d float64 views of the control block
(``ControlBlock.hs``), formed there as the host loop's Python floats are;
so the device loop gives the host loop's state, t, h and counts bit for
bit (tests/test_torch_dem_device.py).

What an idle attempt costs: the stage kernels of the freezing kernel
paths return at once on a halted loop; these stages run their five
right-hand sides: 2.4% of the settle's wall on the card (PERF.md),
within the graph's ``BLOCK``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...ops.cuda.control import RHSAttempt


class DEMAttempt(RHSAttempt):
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

    # the DEM's right-hand side reads no time
    timed = False

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
        spec = torch.empty_like(y)
        eps = torch.empty(len(self.keys), dtype=self.dtype, device=device)

        def by_key(x):
            return dict(zip(self.keys, x.unbind(0)))

        return {"y": y, "leaves": by_key(y), "spec": spec,
                "spec_leaves": by_key(spec), "eps": eps,
                "eps_leaves": by_key(eps)}

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

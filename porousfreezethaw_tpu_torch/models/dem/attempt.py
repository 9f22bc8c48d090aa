"""The DEM's Merson attempt on the device protocol of the device-resident
loop (``solvers/merson.py merson_solve_device``).

The counterpart of the JAX DEM solve's ``lax.while_loop`` over the dict
state (``porousfreezethaw_tpu/solvers/merson.py:135-385``, jitted by the
JAX spheres app).  The JAX DEM reaches no Pallas kernel: its pair term is
XLA.  Here the stages are the plain PyTorch right-hand side of
``forces.make_dem_rhs`` (the dense term or a cell strategy on one
device, or the dense term sharded by particle rows over a mesh whose
shards share one device, each shard's rows against the whole state
gathered once per stage); the step control and the commit are the control
and commit kernels of ``csrc/control.cu`` (``ops/cuda/control.py``), on
eps partials and leaves of the state's width (float64 or float32).  An
attempt allocates nothing that outlives it, reads h from the control
block and copies nothing from the host, so a block of attempts is one
CUDA graph and the host reads the control block back once per block.

``dem_solver`` is the one place that decides which loop a DEM solve runs:
``solvers.merson.uses_device_loop``, the rule the freezing app and the
bench share (the device loop on the card, a mesh of virtual shards of one
card included; the host loop on the CPU and over several cards); the
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

from typing import Dict, List, Union

import torch

from ...core import tracing
from ...ops.cuda.control import RHSAttempt
from ...parallel.sharding import dem_sharding
from ...solvers.merson import uses_device_loop

State = Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]


class DEMAttempt(RHSAttempt):
    """One Merson attempt of the DEM right-hand side ``rhs``
    (``make_dem_rhs``: dense, ``cell_list`` or ``cell_lanes`` on one
    device, or the dense term over ``rhs.mesh``) on the dict state {pos,
    vel[, angvel]} of ``rhs``'s config and dtype, or with a mesh the list
    of its shards' dicts (``shard_dem_state``).

    The device buffers: one static state of shape (L, n, 3), L the number
    of leaves, with a view per leaf (on a mesh, each shard's dict of row
    views); the stage-5 output ``spec`` of the same shape; L eps slots in
    the field dtype a shard, one leaf maximum each, which the control
    kernel reduces (the host loop's max of the leaves' maxima).
    ``neighbor_struct`` is the right-hand side's cell structure (None for
    the dense term), which ``forces.solve_guarded`` checks between
    chunks."""

    # the DEM's right-hand side reads no time
    timed = False

    @tracing.span("pft.setup.attempt", cls="DEMAttempt")
    def __init__(self, rhs):
        cfg = rhs.cfg
        self.rhs = rhs
        self.n = cfg.n
        self.dtype = rhs.dtype
        self.keys = (("pos", "vel", "angvel") if cfg.angular
                     else ("pos", "vel"))
        self.neighbor_struct = rhs.neighbor_struct
        self.mesh = getattr(rhs, "mesh", None)
        self.rows = (None if self.mesh is None else
                     dem_sharding(self.mesh, self.n,
                                  self.mesh.axis_names[0]))

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        if self.mesh is not None and any(d != device for d in
                                         self.mesh.device_list()):
            raise ValueError(f"DEMAttempt: the device loop serves a mesh "
                             f"whose shards share one device, not "
                             f"{self.mesh.device_list()}")
        L = len(self.keys)
        shards = 1 if self.rows is None else len(self.rows)
        y = torch.empty((L, self.n, 3), dtype=self.dtype, device=device)
        spec = torch.empty_like(y)
        eps = torch.empty(L * shards, dtype=self.dtype, device=device)

        def by_key(x, sl=slice(None)):
            return {k: v[sl] for k, v in zip(self.keys, x.unbind(0))}

        def tree(x):
            if self.rows is None:
                return by_key(x)
            return [by_key(x, sl) for sl in self.rows]

        # shard i's leaf l in slot i * L + l
        slots = [dict(zip(self.keys, e.unbind(0)))
                 for e in eps.view(shards, L).unbind(0)]
        return {"y": y, "leaves": tree(y), "spec": spec,
                "spec_leaves": tree(spec), "eps": eps,
                "eps_leaves": slots[0] if self.rows is None else slots}

    def _dev_load(self, b: dict, y: State) -> None:
        want = b["leaves"]
        if self.rows is None:
            y, want = [y], [want]
        elif not isinstance(y, list) or len(y) != len(want):
            raise ValueError(f"DEMAttempt expects the list of "
                             f"{len(want)} shards' dict states, got "
                             f"{type(y).__name__}")
        for shard, dsts in zip(y, want):
            if not isinstance(shard, dict) or set(shard) != set(self.keys):
                raise ValueError(f"DEMAttempt expects a dict state with "
                                 f"leaves {self.keys}, got "
                                 f"{type(shard).__name__}")
            for k in self.keys:
                v, dst = shard[k], dsts[k]
                if (v.shape != dst.shape or v.dtype != dst.dtype
                        or v.device != dst.device):
                    raise ValueError(
                        f"DEMAttempt: leaf {k} is {v.dtype} "
                        f"{tuple(v.shape)} on {v.device}, want {dst.dtype} "
                        f"{tuple(dst.shape)} on {dst.device}")
                dst.copy_(v)

    def _dev_unpack(self, b: dict) -> State:
        def copy(d):
            return {k: v.clone() for k, v in d.items()}
        leaves = b["leaves"]
        return (copy(leaves) if self.rows is None
                else [copy(d) for d in leaves])


def dem_solver(rhs, device: torch.device):
    """What ``forces.solve_guarded`` takes for the DEM right-hand side
    ``rhs`` on ``device``: a :class:`DEMAttempt` where the device loop
    serves it (``uses_device_loop``, with ``rhs.mesh``), else ``rhs``
    itself (the host loop)."""
    return DEMAttempt(rhs) if uses_device_loop(device, rhs.mesh) else rhs

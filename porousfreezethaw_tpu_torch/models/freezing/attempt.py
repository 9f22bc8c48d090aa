"""The plain-RHS freezing attempt on the device protocol of the
device-resident loop (``solvers/merson.py merson_solve_device``).

On the card, the f64 path's attempt runs the float64 stage kernel: where
the right-hand side is the single-device float64 ``make_rhs`` with no
noise field and its grid's own spacing, and the loop runs kernels
(``stage_route``), ``PlainAttempt`` hands its loop to a float64
``StageAttempt`` (``ops/cuda/stencil.py``), whose five ``fused_stage``
launches compute ``merson_stages``' stages over that right-hand side,
each operation correctly rounded (csrc/stage.cuh); the control and
commit kernels follow
in float64, 7 launches an attempt.  ``route`` says which: "stage_kernel"
or "plain_rhs".  Every other ``PlainAttempt`` (the f32 noise path, a
mesh, a loop on the CPU) runs the plain right-hand side as below.

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

On a mesh whose shards share one device the right-hand side is
``parallel/halo.py``'s ``make_halo_rhs`` (the JAX app's GSPMD branch: the
plain ``make_rhs`` on each shard's block with its ghost planes and rows)
and the state the list of shards, views of one static buffer, so that one
copy commits them all; each shard has its eps slot, and the control
kernel's max over them is the host loop's max of the leaves' maxima.
The halo copies and each shard's block are PyTorch operations whose
memory the graph's pool holds (tests/test_torch_mesh_device.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...core import tracing
from ...ops.cuda.control import RHSAttempt
from ...ops.cuda.stencil import StageAttempt
from ...parallel.sharding import shard_block

STAGE_KERNEL, PLAIN_RHS = "stage_kernel", "plain_rhs"


def stage_route(rhs, shape, dtype: torch.dtype, mesh, kernel: bool) -> bool:
    """Whether ``PlainAttempt(rhs, shape, dtype, mesh)`` runs the float64
    stage kernel on a loop that runs kernels (``kernel``): a float64 state
    without a mesh, and ``rhs`` the single-device ``make_rhs`` of the grid
    of ``shape`` (its ``built`` record) with no noise field and the grid's
    own spacing."""
    built = getattr(rhs, "built", None)
    return (kernel and dtype == torch.float64 and mesh is None
            and built is not None and built.noise is None
            and built.own_spacing
            and tuple(int(n) for n in shape) == built.geom.shape)


class PlainAttempt(RHSAttempt):
    """One Merson attempt of the freezing right-hand side ``rhs`` on one
    static state of ``dtype`` (``shape`` is the grid's (n3, n2, n1)): the
    stage-5 update into ``spec`` of the same shape and one eps slot a
    shard, the NaN-propagating max of the error over it.  Without
    ``mesh`` ``rhs`` is the single-device ``make_rhs`` and the state one
    (3, n3, n2, n1) tensor; with it, ``make_halo_rhs`` over ``mesh`` and
    the state the list of the shards of ``shard_freezing_state``.  On the
    stage-kernel route (``route``; the module docstring) its device loop
    is that of a float64 ``StageAttempt`` of ``rhs``'s grid, parameters
    and calc mode."""

    @tracing.span("pft.setup.attempt", cls="PlainAttempt")
    def __init__(self, rhs, shape: Tuple[int, int, int],
                 dtype: torch.dtype, mesh=None):
        self.rhs = rhs
        grid = tuple(int(n) for n in shape)
        self.mesh = mesh
        self.shapes = [(3,) + grid] if mesh is None else [
            (3, zs.stop - zs.start, ys.stop - ys.start, grid[2])
            for zs, ys in (shard_block(mesh, i, grid)
                           for i in range(mesh.size))]
        self.dtype = dtype
        # the loop of this object runs kernels on the device of its
        # right-hand side (control.py DeviceLoop)
        built = getattr(rhs, "built", None)
        kernel = (built is not None and built.device.type == "cuda"
                  and not self.plain)
        self._stage = None
        if stage_route(rhs, grid, dtype, mesh, kernel):
            self._stage = StageAttempt(built.geom, built.params,
                                       built.calc_mode, dtype=dtype)
        self.route = PLAIN_RHS if self._stage is None else STAGE_KERNEL
        tracing.annotate(route=self.route)

    def device_loop(self, device: torch.device):
        """The loop of this object on ``device``: on the stage-kernel
        route, its ``StageAttempt``'s."""
        if self._stage is not None:
            return self._stage.device_loop(device)
        return super().device_loop(device)

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        if self.mesh is not None and any(d != device for d in
                                         self.mesh.device_list()):
            raise ValueError(f"PlainAttempt: the device loop serves a mesh "
                             f"whose shards share one device, not "
                             f"{self.mesh.device_list()}")
        sizes = [math.prod(x) for x in self.shapes]
        y = torch.empty(sum(sizes), dtype=self.dtype, device=device)
        spec = torch.empty_like(y)
        eps = torch.empty(len(sizes), dtype=self.dtype, device=device)

        def views(flat):
            return [v.view(x) for v, x in
                    zip(torch.split(flat, sizes), self.shapes)]

        ys, specs = views(y), views(spec)
        one = self.mesh is None
        return {"y": y, "leaves": ys[0] if one else ys, "spec": spec,
                "spec_leaves": specs[0] if one else specs, "eps": eps,
                "eps_leaves": eps[0] if one else list(eps.unbind(0))}

    def _dev_load(self, b: dict, y) -> None:
        dst = b["leaves"]
        one = self.mesh is None
        got = [y] if one else y
        want = [dst] if one else dst
        if not (isinstance(got, list) and len(got) == len(want) and all(
                torch.is_tensor(g) and g.shape == w.shape
                and g.dtype == w.dtype and g.device == w.device
                for g, w in zip(got, want))):
            raise ValueError(
                f"PlainAttempt expects {'a state' if one else 'shards'} of "
                f"{want[0].dtype}, shape "
                f"{' '.join(str(tuple(w.shape)) for w in want)} on "
                f"{want[0].device}, got {_describe(y)}")
        for g, w in zip(got, want):
            w.copy_(g)

    def _dev_unpack(self, b: dict):
        leaves = b["leaves"]
        if self.mesh is None:
            return leaves.clone()
        return [v.clone() for v in leaves]


def _describe(y) -> str:
    if torch.is_tensor(y):
        return f"{y.dtype} {tuple(y.shape)} on {y.device}"
    if isinstance(y, list):
        return "[" + ", ".join(_describe(v) for v in y) + "]"
    return type(y).__name__

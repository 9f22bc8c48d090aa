"""Fused Merson-stage kernels of the freezing model: wrappers, plain
versions and the increment-form attempt.

The counterpart of ``porousfreezethaw_tpu/ops/pallas/stencil.py`` on the
unpadded ``(3, n3, n2, n1)`` layout.  Three CUDA kernels (``csrc/``) carry
the f32 attempts:

* ``fused_stage`` (csrc/fused_stage.cu): one classic Merson stage
  ``K = f(t_s, w + h*sum(c_i K_i))`` over (u, p) with the 7-point FVM
  stencil, mirror boundaries and the Dirichlet top; with ``stage5`` the
  Merson tail ``(y_spec, eps_blocks)`` instead of K5.  Stage 1 of every
  increment-form attempt; all five stages under ``increment_form 0``.
* ``fused_attempt`` (csrc/fused_attempt.cu): the same stage on slot
  ``cur`` of a double-buffered ``(2, 3, n3, n2, n1)`` state, whose tail
  writes y_spec into slot ``1 - cur`` (``FusedAttempt``).
* ``delta_g`` (csrc/delta_g.cu): the exact increment
  ``G = f(w + d) - f(w)``, ``d = h*(c_0 K1 + sum c_j G_j)``, of
  models/freezing/delta.py; with ``stage5`` the increment-form tail, which
  emits y_spec (``emit="y"``) or the bare increment dy (``emit="dy"``, the
  compensated commit's input, ``DeltaAttemptComp``).

Each wrapper checks device, dtype (float32), shapes and contiguity.  For a
tensor on the CPU it computes with the kernel's plain PyTorch version
(``*_plain``, the same arithmetic in the same association); for a CUDA
tensor it launches the kernel or raises — it never falls back.  Each
wrapper counts its kernel launches in a plain int attribute
(``fused_stage.launches``, ``fused_attempt.launches``,
``delta_g.launches`` and, for the ``emit="dy"`` tail, a kernel of its
own, ``delta_g.launches_dy``).

Scalars follow the JAX package exactly: t_stage and h reach the stage
kernel as float32 (the Dirichlet phase switch of the stage kernel is
decided in float32), while the delta kernel's ghost values D1 and dDi come
from the float64 t and are rounded once.  Material and grid constants are
formed in float64 on the host and rounded once to float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ...core.grid import GridGeometry
from ...models.freezing import physics
from ...models.freezing.delta import g_rhs, two_sum
from ...models.freezing.equation import CalcMode, make_rhs
from ...models.freezing.parameters import FreezingParams

N_VARS = 3   # u, p, gl
K_VARS = 2   # the dynamic variables: K and G arrays omit the static gl

# float32 constants handed to the kernels, in the order of struct Consts
# (csrc/freezing.cuh)
CONST_NAMES = (
    "h1_2", "h2_2", "h3_2", "h1d2", "h2d2", "h3d2",
    "u_star", "L", "alpha", "zeta",
    "glass_rho", "ice_rho", "water_rho",
    "glass_cp", "ice_cp", "water_cp",
    "glass_lambda", "ice_lambda", "water_lambda",
    "lam_p_slope", "rho_p_slope", "cp_p_slope",
    "A", "B", "C",
    "p_eps0", "p_eps1", "eps2_3", "eps3_2",
    "gamma", "neg_half_gamma", "eps_reg",
    "top_temp1", "top_temp2", "phase_switch_time",
)


class KernelLaunchError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class StencilSpec:
    """Grid, parameters and model of one kernel configuration, with the
    kernels' constants formed in float64 and rounded once to float32."""

    geom: GridGeometry
    params: FreezingParams
    mode: CalcMode
    coeffs: physics.Coeffs
    packed: np.ndarray

    @staticmethod
    def of(geom: GridGeometry, params: FreezingParams,
           calc_mode: int) -> "StencilSpec":
        p, c = params, physics.Coeffs.of(params)
        inv_h1, inv_h2, inv_h3 = geom.inv_h
        vals = dict(
            h1_2=inv_h1**2, h2_2=inv_h2**2, h3_2=inv_h3**2,
            h1d2=0.5 * inv_h1, h2d2=0.5 * inv_h2, h3d2=0.5 * inv_h3,
            u_star=p.u_star, L=p.L, alpha=p.alpha, zeta=p.zeta,
            glass_rho=p.glass_rho, ice_rho=p.ice_rho, water_rho=p.water_rho,
            glass_cp=p.glass_cp, ice_cp=p.ice_cp, water_cp=p.water_cp,
            glass_lambda=p.glass_lambda, ice_lambda=p.ice_lambda,
            water_lambda=p.water_lambda,
            lam_p_slope=p.ice_lambda - p.water_lambda,
            rho_p_slope=p.ice_rho - p.water_rho,
            cp_p_slope=p.ice_cp - p.water_cp,
            A=c.xi_2_inv_a, B=p.b * p.alpha * p.mu,
            C=c.xi_inv_b_sqrt_a2 * p.alpha * p.mu,
            p_eps0=p.p_eps0, p_eps1=p.p_eps1, eps2_3=c.eps2_3,
            eps3_2=c.eps3_2, gamma=p.gamma, neg_half_gamma=-0.5 * p.gamma,
            eps_reg=physics.EPS_REGULARIZATION,
            top_temp1=p.top_temp1, top_temp2=p.top_temp2,
            phase_switch_time=p.phase_switch_time,
        )
        packed = np.ascontiguousarray(
            [vals[n] for n in CONST_NAMES], dtype=np.float32)
        return StencilSpec(geom, params, CalcMode(calc_mode), c, packed)

    @property
    def state_shape(self) -> Tuple[int, int, int, int]:
        return (N_VARS,) + self.geom.shape

    @property
    def k_shape(self) -> Tuple[int, int, int, int]:
        return (K_VARS,) + self.geom.shape


Ks = Sequence[Tuple[float, torch.Tensor]]


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------

def _hc(h32: np.float32, c: float) -> float:
    """h*c formed in float32, as the kernels form it."""
    return float(h32 * np.float32(c))


def fused_stage_plain(spec: StencilSpec, t: float, h: float,
                      w: torch.Tensor, ks: Ks, stage5: bool = False):
    """Plain version of the ``fused_stage`` kernel (any device): the stage
    combination, then ``make_rhs`` (whose association the kernel keeps),
    with the Dirichlet top decided on ``t`` rounded to float32."""
    h32 = np.float32(h)
    aux_u, aux_p = w[0], w[1]
    for c, K in ks:
        hc = _hc(h32, c)
        aux_u = aux_u + hc * K[0]
        aux_p = aux_p + hc * K[1]
    rhs = make_rhs(spec.geom, spec.params, spec.mode, w.device)
    k_out = rhs(t, torch.stack([aux_u, aux_p, w[2]]))[:K_VARS]
    if not stage5:
        return k_out
    # ks are K1, K3, K4 of the stage-5 combination
    k1c, k3c, k4c = (K for _, K in ks)
    err = 0.2 * k1c - 0.9 * k3c + 0.8 * k4c - 0.1 * k_out
    h3 = float(h32 / np.float32(3.0))
    y_out = w[:K_VARS] + h3 * (0.5 * (k1c + k_out) + 2.0 * k4c)
    return y_out, torch.amax(torch.abs(err)).reshape(1)


def delta_g_plain(spec: StencilSpec, h: float, D1: float, dDi: float,
                  w: torch.Tensor, ks: Ks, stage5: bool = False,
                  emit: str = "y"):
    """Plain version of the ``delta_g`` kernel (any device)."""
    h32 = np.float32(h)
    (c0, K0), rest = ks[0], ks[1:]
    hc0 = _hc(h32, c0)
    a, b = hc0 * K0[0], hc0 * K0[1]
    for c, K in rest:
        hc = _hc(h32, c)
        a = a + hc * K[0]
        b = b + hc * K[1]
    # the ghosts are rounded to float32 where they fill the f32 plane
    g_out = g_rhs(spec.mode, spec.params, spec.coeffs, spec.geom, w, (a, b),
                  D1, dDi)
    if not stage5:
        return g_out
    # ks are K1, G3, G4 of the stage-5 combination
    k1c, g3c, g4c = (K for _, K in ks)
    err = -0.9 * g3c + 0.8 * g4c - 0.1 * g_out
    eps = torch.amax(torch.abs(err)).reshape(1)
    h3 = float(h32 / np.float32(3.0))
    if emit == "dy":
        # the kernel's rounding: two products, then one uncontracted add
        u_term = float(h32) * k1c
        x_term = h3 * (2.0 * g4c + 0.5 * g_out)
        return u_term + x_term, eps
    y_out = (w[:K_VARS] + float(h32) * k1c
             + h3 * (2.0 * g4c + 0.5 * g_out))
    return y_out, eps


def fused_attempt_plain(spec: StencilSpec, t: float, h: float,
                        y2: torch.Tensor, cur: torch.Tensor, ks: Ks,
                        tail: bool = False):
    """Plain version of the ``fused_attempt`` kernel (any device): the
    plain stage on slot ``cur`` of ``y2``; the tail writes (u, p) of y_spec
    into slot ``1 - cur`` and returns the eps partials."""
    c = int(cur)
    if not tail:
        return fused_stage_plain(spec, t, h, y2[c], ks)
    y_spec, eps = fused_stage_plain(spec, t, h, y2[c], ks, stage5=True)
    y2[1 - c, :K_VARS] = y_spec
    return eps


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(spec: StencilSpec, name: str, w: torch.Tensor, ks: Ks,
           stage5: bool, nk_min: int, w_shape=None) -> None:
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {w.device}")
    nk = len(ks)
    if not nk_min <= nk <= 3:
        raise ValueError(f"{name}: takes {nk_min}..3 K inputs, got {nk}")
    if stage5 and nk != 3:
        raise ValueError(f"{name}: stage5 takes the 3-term combination")
    for t_, want in [(w, w_shape or spec.state_shape)] + [
            (K, spec.k_shape) for _, K in ks]:
        if tuple(t_.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(t_.shape)}")
        if t_.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t_.dtype}")
        if t_.device != w.device:
            raise ValueError(f"{name}: inputs on {t_.device} and {w.device}")
        if not t_.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, built and loaded once, with its constant table
    checked against CONST_NAMES."""
    from .build import load_library
    lib = load_library()
    if lib.pft_num_consts() != len(CONST_NAMES):
        raise KernelLaunchError(
            f"kernel library has {lib.pft_num_consts()} constants, "
            f"stencil.py packs {len(CONST_NAMES)}")
    return lib


def _kernel_call(fn_name: str, spec: StencilSpec, scalars, state_ptrs,
                 device: torch.device, ks: Ks, tail: int, out):
    """Launch ``fn_name`` of the kernel library on ``device``'s current
    stream, writing K/G/y_spec/dy into ``out`` (None where the kernel
    writes its state instead); returns the eps partials of a tail
    (``tail`` > 0), else None."""
    lib = _library()
    Z, Y, X = spec.geom.shape
    eps = (torch.empty((lib.pft_eps_blocks(Z, Y, X),), dtype=torch.float32,
                       device=device) if tail else None)
    nk = len(ks)
    coefs = np.zeros(3, dtype=np.float32)
    coefs[:nk] = [c for c, _ in ks]
    kptrs = [K.data_ptr() for _, K in ks] + [None] * (3 - nk)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            spec.packed.ctypes.data, int(spec.mode), nk, tail,
            *scalars, coefs.ctypes.data, *state_ptrs, *kptrs,
            None if out is None else out.data_ptr(),
            None if eps is None else eps.data_ptr(), Z, Y, X, stream)
    if rc != 0:
        msg = (lib.pft_error_string(rc).decode() if rc < 1000
               else "invalid arguments")
        raise KernelLaunchError(f"{fn_name} failed: {rc} ({msg})")
    return eps


def _k_out(spec: StencilSpec, device: torch.device) -> torch.Tensor:
    return torch.empty(spec.k_shape, dtype=torch.float32, device=device)


def fused_stage(spec: StencilSpec, t: float, h: float, w: torch.Tensor,
                ks: Ks, stage5: bool = False):
    """One classic Merson stage; see the module docstring.  Returns K of
    shape (2, n3, n2, n1), or ``(y_spec, eps_blocks)`` with ``stage5``."""
    _check(spec, "fused_stage", w, ks, stage5, nk_min=0)
    if w.device.type == "cpu":
        return fused_stage_plain(spec, t, h, w, ks, stage5)
    scalars = (float(np.float32(t)), float(np.float32(h)))
    out = _k_out(spec, w.device)
    eps = _kernel_call("pft_fused_stage", spec, scalars, (w.data_ptr(),),
                       w.device, ks, int(stage5), out)
    fused_stage.launches += 1
    return (out, eps) if stage5 else out


fused_stage.launches = 0


def fused_attempt(spec: StencilSpec, t: float, h: float, y2: torch.Tensor,
                  cur: torch.Tensor, ks: Ks, tail: bool = False):
    """One stage of the double-buffered attempt; see the module docstring.
    ``y2`` is the float32 ``(2, 3, n3, n2, n1)`` state and ``cur`` a
    one-element int32 tensor on the same device holding the slot (0 or 1)
    the stage reads.  Returns K of shape (2, n3, n2, n1) or, with ``tail``,
    the eps partials (y_spec goes into slot ``1 - cur`` of ``y2``)."""
    _check(spec, "fused_attempt", y2, ks, tail, nk_min=0,
           w_shape=(2,) + spec.state_shape)
    if (cur.dtype != torch.int32 or tuple(cur.shape) != (1,)
            or cur.device != y2.device):
        raise ValueError("fused_attempt: cur must be a one-element int32 "
                         f"tensor on {y2.device}, got {cur.dtype} "
                         f"{tuple(cur.shape)} on {cur.device}")
    if y2.device.type == "cpu":
        return fused_attempt_plain(spec, t, h, y2, cur, ks, tail)
    scalars = (float(np.float32(t)), float(np.float32(h)))
    out = None if tail else _k_out(spec, y2.device)
    eps = _kernel_call("pft_fused_attempt", spec, scalars,
                       (y2.data_ptr(), cur.data_ptr()), y2.device, ks,
                       int(tail), out)
    fused_attempt.launches += 1
    return eps if tail else out


fused_attempt.launches = 0

EMITS = ("y", "dy")


def delta_g(spec: StencilSpec, h: float, D1: float, dDi: float,
            w: torch.Tensor, ks: Ks, stage5: bool = False, emit: str = "y"):
    """One increment-form stage; see the module docstring.  Returns G of
    shape (2, n3, n2, n1), or with ``stage5`` ``(y_spec, eps_blocks)``
    (``emit="y"``) or ``(dy, eps_blocks)`` (``emit="dy"``)."""
    _check(spec, "delta_g", w, ks, stage5, nk_min=1)
    if emit not in EMITS or (emit == "dy" and not stage5):
        raise ValueError(f"delta_g: emit must be one of {EMITS}, and 'dy' "
                         f"needs stage5; got {emit!r}")
    if w.device.type == "cpu":
        return delta_g_plain(spec, h, D1, dDi, w, ks, stage5, emit)
    scalars = tuple(float(np.float32(v)) for v in (h, D1, dDi))
    out = _k_out(spec, w.device)
    tail = 2 if emit == "dy" else int(stage5)
    eps = _kernel_call("pft_delta_g", spec, scalars, (w.data_ptr(),),
                       w.device, ks, tail, out)
    if emit == "dy":
        delta_g.launches_dy += 1
    else:
        delta_g.launches += 1
    return (out, eps) if stage5 else out


delta_g.launches = 0
delta_g.launches_dy = 0


# ---------------------------------------------------------------------------
# merson_solve adapters
# ---------------------------------------------------------------------------

def commit(y: torch.Tensor, y_spec: torch.Tensor, accept: bool):
    """Accepted-state select for the (u, p)-only ``y_spec``: writes it into
    ``y`` in place (gl is static), saving a copy of the state per step."""
    if accept:
        y[:K_VARS].copy_(y_spec)
    return y


def make_fused_stage(geom: GridGeometry, params: FreezingParams,
                     calc_mode: int, *, plain: bool = False):
    """``stage(t_stage, h, w, ks) -> K`` for ``merson_solve``'s
    ``stage_fn``, with ``.stage5`` and ``.commit``.  ``plain=True`` uses
    the plain PyTorch version on any device (the reference the kernel is
    held to)."""
    spec = StencilSpec.of(geom, params, calc_mode)
    fn = fused_stage_plain if plain else fused_stage

    def stage(t_stage, h, w, ks):
        return fn(spec, t_stage, h, w, ks)

    def stage5(t_stage, h, w, ks):
        return fn(spec, t_stage, h, w, ks, stage5=True)

    stage.stage5 = stage5
    stage.commit = commit
    stage.k_partial = True
    return stage


def make_delta_g(geom: GridGeometry, params: FreezingParams, calc_mode: int,
                 *, plain: bool = False):
    """``g(h, D1, dDi, w, ks, stage5=False, emit="y")`` computing
    ``G = f(w + d) - f(w)``; ``plain=True`` as in make_fused_stage."""
    spec = StencilSpec.of(geom, params, calc_mode)
    fn = delta_g_plain if plain else delta_g

    def g(h, D1, dDi, w, ks, stage5=False, emit="y"):
        return fn(spec, h, D1, dDi, w, ks, stage5=stage5, emit=emit)

    return g


class DeltaAttempt:
    """Merson attempt in increment form (models/freezing/delta.py).

    Stage 1 is the classic stage kernel (``K1 = f(w)``); stages 2-5 are the
    delta kernel computing ``G_i = f(w + d_i) - f(w)``.  The stage-5 tail
    gives the estimator ``-0.9 G3 + 0.8 G4 - 0.1 G5`` (K1 cancels, so there
    is no f32 stage-state rounding floor) and the speculative update.
    Implements ``merson_solve``'s ``attempt_fn`` protocol on the
    ``(3, n3, n2, n1)`` float32 state: ``pack`` copies the state once per
    solve call, and ``commit`` writes (u, p) into that copy in place.
    ``plain=True`` computes with the plain PyTorch versions on any device.
    """

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, *, plain: bool = False):
        self.geom = geom
        self._prm = params
        self._stage1 = make_fused_stage(geom, params, calc_mode, plain=plain)
        self._g = make_delta_g(geom, params, calc_mode, plain=plain)

    def pack(self, y: torch.Tensor) -> torch.Tensor:
        want = (N_VARS,) + self.geom.shape
        if tuple(y.shape) != want or y.dtype != torch.float32:
            raise ValueError(f"DeltaAttempt expects a float32 {want} state, "
                             f"got {y.dtype} {tuple(y.shape)}")
        return y.clone(memory_format=torch.contiguous_format)

    def _stages(self, t: float, h: float, y: torch.Tensor, emit: str):
        """The five stages on ``y``: the stage-5 tail's output (y_spec or
        dy, per ``emit``) and the eps partials."""
        prm = self._prm
        D1 = physics.dirichlet_top(t, prm)

        def dD(ts):
            # exact: both values are parameter constants
            return float(np.float32(physics.dirichlet_top(ts, prm) - D1))

        K1 = self._stage1(t, h, y, [])
        G2 = self._g(h, D1, dD(t + h / 3), y, [(1.0 / 3.0, K1)])
        G3 = self._g(h, D1, dD(t + h / 3), y,
                     [(1.0 / 3.0, K1), (1.0 / 6.0, G2)])
        G4 = self._g(h, D1, dD(t + h / 2), y, [(0.5, K1), (0.375, G3)])
        return self._g(h, D1, dD(t + h), y,
                       [(1.0, K1), (-1.5, G3), (2.0, G4)], stage5=True,
                       emit=emit)

    def attempt(self, t: float, h: float, y: torch.Tensor):
        y_spec, eps_blocks = self._stages(t, h, y, "y")
        return (y, y_spec), eps_blocks

    def commit(self, carry_spec, accept: bool) -> torch.Tensor:
        y, y_spec = carry_spec
        return commit(y, y_spec, accept)

    def unpack(self, y: torch.Tensor) -> torch.Tensor:
        return y


class DeltaAttemptComp(DeltaAttempt):
    """DeltaAttempt with a compensated (double-f32) commit: the
    counterpart of the JAX ``DeltaAttemptComp`` (stencil.py:1270-1335).

    The stage-5 tail emits the bare increment dy (``emit="dy"``), and the
    commit adds it into an (hi, lo) float32 pair per dynamic variable by
    TwoSum, so that hi + lo tracks the exact sum of the increments to about
    ulp^2.  The stages read the plain hi planes.  The state is
    ``(5, n3, n2, n1)`` = [u, p, gl, u_lo, p_lo]; ``pack`` adds zero lo
    planes to a 3-plane state and copies a 5-plane one (the commit writes
    in place), and ``unpack`` keeps the lo planes, so that successive solve
    calls carry them: strip them with ``y[:3]`` for output.  The commit is
    plain PyTorch, as the JAX package left it to XLA.
    """

    def pack(self, y: torch.Tensor) -> torch.Tensor:
        if (tuple(y.shape) == (N_VARS + K_VARS,) + self.geom.shape
                and y.dtype == torch.float32):
            return y.clone(memory_format=torch.contiguous_format)
        y = super().pack(y)
        return torch.cat([y, torch.zeros_like(y[:K_VARS])])

    def attempt(self, t: float, h: float, y5: torch.Tensor):
        dy, eps_blocks = self._stages(t, h, y5[:N_VARS], "dy")
        return (y5, dy), eps_blocks

    def commit(self, carry_spec, accept: bool) -> torch.Tensor:
        y5, dy = carry_spec
        if accept:
            hi, lo = y5[:K_VARS], y5[N_VARS:]
            s, err = two_sum(hi, lo, dy)
            hi.copy_(s)
            lo.copy_(err)
        return y5


class FusedAttempt:
    """Classic Merson attempt over a double-buffered state: the counterpart
    of the JAX ``FusedAttempt`` (stencil.py:1353-1610), through the
    ``fused_attempt`` kernel.

    ``pack`` makes one contiguous ``(2, 3, n3, n2, n1)`` buffer holding the
    state in both slots (gl included, which the tail never writes) and a
    one-element int32 slot index ``cur`` on the same device, which the
    kernel reads itself.  Stages 1-4 read slot ``cur``; the tail writes
    y_spec into slot ``1 - cur``.  ``commit`` flips ``cur`` on the device
    (no copy, no host sync) and ``unpack`` returns slot ``cur``.  The
    stage coefficients are those of ``merson_solve``'s stage path, so an
    attempt equals the ``fused_stage`` chain.  ``plain=True`` computes with
    the plain PyTorch version on any device.
    """

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, *, plain: bool = False):
        self.geom = geom
        self._spec = StencilSpec.of(geom, params, calc_mode)
        self._fn = fused_attempt_plain if plain else fused_attempt

    def pack(self, y: torch.Tensor):
        want = (N_VARS,) + self.geom.shape
        if tuple(y.shape) != want or y.dtype != torch.float32:
            raise ValueError(f"FusedAttempt expects a float32 {want} state, "
                             f"got {y.dtype} {tuple(y.shape)}")
        return (torch.stack([y, y]),
                torch.zeros(1, dtype=torch.int32, device=y.device))

    def attempt(self, t: float, h: float, carry):
        y2, cur = carry

        def step(t_stage, ks, tail=False):
            return self._fn(self._spec, t_stage, h, y2, cur, ks, tail)

        K1 = step(t, [])
        K2 = step(t + h / 3, [(1.0 / 3.0, K1)])
        K3 = step(t + h / 3, [(1.0 / 6.0, K1), (1.0 / 6.0, K2)])
        K4 = step(t + h / 2, [(1.0 / 8.0, K1), (3.0 / 8.0, K3)])
        eps_blocks = step(t + h, [(0.5, K1), (-1.5, K3), (2.0, K4)],
                          tail=True)
        return carry, eps_blocks

    def commit(self, carry_spec, accept: bool):
        if accept:
            carry_spec[1].bitwise_xor_(1)
        return carry_spec

    def unpack(self, carry) -> torch.Tensor:
        y2, cur = carry
        return y2[int(cur)]


def make_fused_attempt(geom: GridGeometry, params: FreezingParams,
                       calc_mode: int, *, plain: bool = False) -> FusedAttempt:
    return FusedAttempt(geom, params, calc_mode, plain=plain)

"""Fused Merson-stage kernels of the freezing model: wrappers, plain
versions and the increment-form attempt.

The counterpart of ``porousfreezethaw_tpu/ops/pallas/stencil.py`` on the
unpadded ``(3, n3, n2, n1)`` layout.  Three CUDA kernels (``csrc/``) carry
the f32 attempts, two of them with shard entries:

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
* ``fused_stage_shard`` and ``delta_g_shard``: the stage and delta
  kernels on one shard of a device mesh (parallel/fused.py), with ghost
  planes from the z-neighbours and a y window; the stage's ``part``
  option splits a shard into the interior pass and the edge pass.

Each wrapper checks device, dtype (float32), shapes and contiguity.  For a
tensor on the CPU it computes with the kernel's plain PyTorch version
(``*_plain``, the same arithmetic in the same association); for a CUDA
tensor it launches the kernel or raises — it never falls back.  Each
wrapper counts its kernel launches in a plain int attribute
(``fused_stage.launches``, ``fused_attempt.launches``,
``delta_g.launches`` and, for the ``emit="dy"`` tail, a kernel of its
own, ``delta_g.launches_dy``; ``fused_stage_shard.launches`` for whole
shards, ``fused_stage_shard.launches_split`` for the interior and edge
passes, ``delta_g_shard.launches`` and ``delta_g_shard.launches_dy``).

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
    return _stage5_tail(h, w, [K for _, K in ks], k_out)


def _stage5_tail(h: float, w: torch.Tensor, ks, k_out: torch.Tensor):
    """The classic Merson tail on K1, K3, K4 (``ks``) and K5 (``k_out``):
    ``(y_spec, eps)``."""
    h32 = np.float32(h)
    k1c, k3c, k4c = ks
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
    return _delta_tail(h, w, [K for _, K in ks], g_out, emit)


def _delta_tail(h: float, w: torch.Tensor, ks, g_out: torch.Tensor,
                emit: str):
    """The increment-form tail on K1, G3, G4 (``ks``) and G5 (``g_out``):
    ``(y_spec or dy, eps)``."""
    h32 = np.float32(h)
    k1c, g3c, g4c = ks
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
           stage5: bool, nk_min: int, w_shape=None, k_shape=None) -> None:
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {w.device}")
    nk = len(ks)
    if not nk_min <= nk <= 3:
        raise ValueError(f"{name}: takes {nk_min}..3 K inputs, got {nk}")
    if stage5 and nk != 3:
        raise ValueError(f"{name}: stage5 takes the 3-term combination")
    for t_, want in [(w, w_shape or spec.state_shape)] + [
            (K, k_shape or spec.k_shape) for _, K in ks]:
        _check_tensor(name, t_, want, w.device)


def _check_tensor(name: str, t_: torch.Tensor, shape, device) -> None:
    if tuple(t_.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t_.shape)}")
    if t_.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {t_.dtype}")
    if t_.device != device:
        raise ValueError(f"{name}: inputs on {t_.device} and {device}")
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
                 device: torch.device, ks: Ks, tail: int, out, *,
                 dims=None, eps=None, extra=()):
    """Launch ``fn_name`` of the kernel library on ``device``'s current
    stream, writing K/G/y_spec/dy into ``out`` (None where the kernel
    writes its state instead); returns the eps partials of a tail
    (``tail`` > 0), else None.  ``dims`` is the (Z, Y, X) of the inputs
    (the grid's by default), ``eps`` a given buffer for the partials and
    ``extra`` the arguments after the stream (the shard entries')."""
    lib = _library()
    Z, Y, X = dims or spec.geom.shape
    if tail and eps is None:
        eps = torch.empty((lib.pft_eps_blocks(Z, Y, X),),
                          dtype=torch.float32, device=device)
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
            None if eps is None else eps.data_ptr(), Z, Y, X, stream,
            *extra)
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
# shard variants: one shard of a device mesh (parallel/fused.py)
# ---------------------------------------------------------------------------
#
# A shard holds planes [z0, z0 + zl) and rows [y0, y0 + Yl) of the grid.
# Its inputs are (nv, zl, Ye, X) with the own rows at [r0, r0 + Yl) of the
# Ye rows (Ye = Yl + 2 on a 2-D mesh: one ghost row per side), and ``window``
# is (r0, Yl, y0).  ``ghosts`` is a pair of (3 + 2 nk, Ye, X) stacks of
# raw edge planes below plane 0 and above plane zl - 1: w's three planes,
# then each K's (u, p).  Outputs cover the own rows.  The kernels
# (pft_fused_stage_shard, pft_delta_g_shard) read the ghost planes with
# their own combination arithmetic, so a sharded stage equals the
# single-device stage bit for bit; the plain versions do the same by
# assembling each input's (zl + 2)-plane block and running the
# single-device plain arithmetic on it.

PARTS = ("all", "interior", "edge")


def _window(w: torch.Tensor, window):
    return (0, w.shape[2], 0) if window is None else tuple(window)


def _ghost_block(arr: torch.Tensor, ghosts, entry: int) -> torch.Tensor:
    """``arr`` (input ``entry``: 0 for w, q + 1 for the q-th K) between its
    ghost planes: (nv, zl + 2, Ye, X); the own edge planes where there are
    no ghosts."""
    nv = arr.shape[0]
    if ghosts is None:
        lo, hi = arr[:, :1], arr[:, -1:]
    else:
        first = 0 if entry == 0 else N_VARS + K_VARS * (entry - 1)
        lo, hi = (g[first:first + nv, None] for g in ghosts)
    return torch.cat([lo, arr, hi], dim=1)


def ghost_planes(nk: int) -> int:
    """Planes of one ghost stack of a stage with ``nk`` K inputs."""
    return N_VARS + K_VARS * nk


def _plain_rows(spec: StencilSpec, window):
    """The rows the plain versions compute on: the own rows with those
    neighbour rows that exist in the grid (so the block's edge is the
    grid's edge where it mirrors), and the own rows' offset in them."""
    r0, Yl, y0 = window
    lo = r0 - 1 if y0 > 0 else r0
    hi = r0 + Yl + 1 if y0 + Yl < spec.geom.n2 else r0 + Yl
    return slice(lo, hi), r0 - lo


def _planes(part: str, zl: int):
    return {"all": slice(0, zl), "interior": slice(1, zl - 1),
            "edge": [0, zl - 1]}[part]


def fused_stage_shard_plain(spec: StencilSpec, t: float, h: float,
                            w: torch.Tensor, ks: Ks, ghosts=None, *,
                            window=None, stage5: bool = False,
                            part: str = "all", prev=()):
    """Plain version of the ``fused_stage_shard`` kernel (any device)."""
    r0, Yl, y0 = window = _window(w, window)
    zl, X = w.shape[1], w.shape[3]
    rows, off = _plain_rows(spec, window)
    wb = _ghost_block(w, ghosts, 0)[:, :, rows]
    kb = [(c, _ghost_block(K, ghosts, q + 1)[:, :, rows])
          for q, (c, K) in enumerate(ks)]
    zs, own = _planes(part, zl), slice(r0, r0 + Yl)
    k_out = fused_stage_plain(spec, t, h, wb, kb)[:, 1:-1, off:off + Yl]
    if part == "edge":
        out, eps = (tuple(prev) + (None,))[:2]
    else:
        out = torch.zeros((K_VARS, zl, Yl, X), dtype=w.dtype,
                          device=w.device)
        eps = (torch.zeros((1 if part == "all" else 2,), dtype=w.dtype,
                           device=w.device) if stage5 else None)
    if not stage5:
        out[:, zs] = k_out[:, zs]
        return out
    y_out, e = _stage5_tail(h, w[:, zs, own], [K[:, zs, own] for _, K in ks],
                            k_out[:, zs])
    out[:, zs] = y_out
    eps[int(part == "edge")] = e[0]
    return out, eps


def delta_g_shard_plain(spec: StencilSpec, h: float, D1: float, dDi: float,
                        w: torch.Tensor, ks: Ks, ghosts, *, is_top: bool,
                        window=None, stage5: bool = False, emit: str = "y"):
    """Plain version of the ``delta_g_shard`` kernel (any device)."""
    r0, Yl, y0 = window = _window(w, window)
    rows, off = _plain_rows(spec, window)
    wb = _ghost_block(w, ghosts, 0)[:, :, rows]
    kb = [_ghost_block(K, ghosts, q + 1)[:, :, rows]
          for q, (_, K) in enumerate(ks)]
    h32 = np.float32(h)
    hc0 = _hc(h32, ks[0][0])
    a, b = hc0 * kb[0][0], hc0 * kb[0][1]
    for (c, _), K in zip(ks[1:], kb[1:]):
        hc = _hc(h32, c)
        a = a + hc * K[0]
        b = b + hc * K[1]
    if is_top:
        # the Dirichlet overwrites of the top ghost: old u := D1, the
        # increment := dDi (rounded to float32 as they fill the planes)
        wb[0, -1] = D1
        a[-1] = dDi
    g_out = g_rhs(spec.mode, spec.params, spec.coeffs, spec.geom, wb,
                  (a, b), D1, dDi)[:, 1:-1, off:off + Yl].contiguous()
    if not stage5:
        return g_out
    own = slice(r0, r0 + Yl)
    return _delta_tail(h, w[:, :, own], [K[:, :, own] for _, K in ks],
                       g_out, emit)


def _check_shard(spec: StencilSpec, name: str, w: torch.Tensor, ks: Ks,
                 ghosts, window, stage5: bool, nk_min: int,
                 part: str = "all", prev=()) -> None:
    zl, Ye, X = w.shape[1:] if w.dim() == 4 else (0, 0, 0)
    _check(spec, name, w, ks, stage5, nk_min, w_shape=(N_VARS, zl, Ye, X),
           k_shape=(K_VARS, zl, Ye, X))
    r0, Yl, y0 = _window(w, window)
    if X != spec.geom.n1 or zl < 1:
        raise ValueError(f"{name}: a shard of the grid {spec.geom.shape} "
                         f"cannot have the shape {tuple(w.shape)}")
    if part not in PARTS:
        raise ValueError(f"{name}: part must be one of {PARTS}, got {part!r}")
    if part != "all" and zl < 3:
        raise ValueError(f"{name}: the {part} part needs >= 3 planes, "
                         f"got {zl}")
    n2 = spec.geom.n2
    if not (0 <= r0 and 1 <= Yl and r0 + Yl <= Ye and 0 <= y0
            and y0 + Yl <= n2 and (y0 == 0 or r0 >= 1)
            and (y0 + Yl == n2 or r0 + Yl < Ye)):
        raise ValueError(f"{name}: window (r0, Yl, y0) = {(r0, Yl, y0)} "
                         f"does not fit {Ye} input rows of a grid of {n2}")
    if part == "interior" and ghosts is not None:
        raise ValueError(f"{name}: the interior part reads no ghosts")
    if part != "interior":
        if ghosts is None or len(ghosts) != 2:
            raise ValueError(f"{name}: takes two ghost stacks")
        for g in ghosts:
            _check_tensor(name, g, (ghost_planes(len(ks)), Ye, X), w.device)
    if part == "edge":
        if len(prev) != 1 + int(stage5):
            raise ValueError(f"{name}: the edge part takes the interior "
                             "part's outputs")
        _check_tensor(name, prev[0], (K_VARS, zl, Yl, X), w.device)


def _ghost_ptrs(ghosts):
    return (None, None) if ghosts is None else tuple(
        g.data_ptr() for g in ghosts)


def fused_stage_shard(spec: StencilSpec, t: float, h: float,
                      w: torch.Tensor, ks: Ks, ghosts=None, *, window=None,
                      stage5: bool = False, part: str = "all", prev=()):
    """One classic Merson stage on one shard (K1s; K3 for the parts).

    ``part="all"`` returns K of shape (2, zl, Yl, X), or ``(y_spec,
    eps_blocks)`` with ``stage5``.  ``part="interior"`` computes planes
    [1, zl - 1), which read no ghost (pass ``ghosts=None``), and returns
    the same objects with the edge planes and the edge's eps slots still
    to be written; ``part="edge"`` writes planes 0 and zl - 1 into
    ``prev``, the interior part's return value (``(K,)`` or ``(y_spec,
    eps_blocks)``), and returns it."""
    _check_shard(spec, "fused_stage_shard", w, ks, ghosts, window, stage5,
                 0, part, prev)
    if w.device.type == "cpu":
        return fused_stage_shard_plain(spec, t, h, w, ks, ghosts,
                                       window=window, stage5=stage5,
                                       part=part, prev=prev)
    lib = _library()
    r0, Yl, y0 = _window(w, window)
    zl, Ye, X = w.shape[1:]
    n_int = lib.pft_shard_eps_blocks(1, zl, Yl, X)
    if part == "edge":
        out, eps = (tuple(prev) + (None,))[:2]
        view = eps[n_int:] if stage5 else None
    else:
        out = torch.empty((K_VARS, zl, Yl, X), dtype=torch.float32,
                          device=w.device)
        n_eps = (lib.pft_shard_eps_blocks(0, zl, Yl, X) if part == "all"
                 else n_int + lib.pft_shard_eps_blocks(2, zl, Yl, X))
        eps = view = (torch.empty((n_eps,), dtype=torch.float32,
                                  device=w.device) if stage5 else None)
    scalars = (float(np.float32(t)), float(np.float32(h)))
    _kernel_call("pft_fused_stage_shard", spec, scalars, (w.data_ptr(),),
                 w.device, ks, int(stage5), out, dims=(zl, Ye, X), eps=view,
                 extra=_ghost_ptrs(ghosts) + (
                     PARTS.index(part), r0, Yl, y0, spec.geom.n2))
    if part == "all":
        fused_stage_shard.launches += 1
    else:
        fused_stage_shard.launches_split += 1
    return (out, eps) if stage5 else out


fused_stage_shard.launches = 0         # K1s: part "all"
fused_stage_shard.launches_split = 0   # K3: parts "interior" and "edge"


def delta_g_shard(spec: StencilSpec, h: float, D1: float, dDi: float,
                  w: torch.Tensor, ks: Ks, ghosts, *, is_top: bool,
                  window=None, stage5: bool = False, emit: str = "y"):
    """One increment-form stage on one shard (K2s; with ``emit="dy"`` the
    compensated tail).  Returns G of shape (2, zl, Yl, X), or with
    ``stage5`` ``(y_spec or dy, eps_blocks)``.  ``is_top`` applies the
    Dirichlet overwrites of the top ghost (the global top shard only)."""
    _check_shard(spec, "delta_g_shard", w, ks, ghosts, window, stage5, 1)
    if emit not in EMITS or (emit == "dy" and not stage5):
        raise ValueError(f"delta_g_shard: emit must be one of {EMITS}, and "
                         f"'dy' needs stage5; got {emit!r}")
    if w.device.type == "cpu":
        return delta_g_shard_plain(spec, h, D1, dDi, w, ks, ghosts,
                                   is_top=is_top, window=window,
                                   stage5=stage5, emit=emit)
    r0, Yl, y0 = _window(w, window)
    zl, Ye, X = w.shape[1:]
    out = torch.empty((K_VARS, zl, Yl, X), dtype=torch.float32,
                      device=w.device)
    eps = (torch.empty((_library().pft_shard_eps_blocks(0, zl, Yl, X),),
                       dtype=torch.float32, device=w.device)
           if stage5 else None)
    scalars = tuple(float(np.float32(v)) for v in (h, D1, dDi))
    tail = 2 if emit == "dy" else int(stage5)
    _kernel_call("pft_delta_g_shard", spec, scalars, (w.data_ptr(),),
                 w.device, ks, tail, out, dims=(zl, Ye, X), eps=eps,
                 extra=_ghost_ptrs(ghosts) + (
                     int(is_top), r0, Yl, y0, spec.geom.n2))
    if emit == "dy":
        delta_g_shard.launches_dy += 1
    else:
        delta_g_shard.launches += 1
    return (out, eps) if stage5 else out


delta_g_shard.launches = 0
delta_g_shard.launches_dy = 0


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

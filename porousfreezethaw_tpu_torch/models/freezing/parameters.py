"""Freezing-model variables and physical parameters.

The reference declares the equation system's variables (``u`` temperature,
``p`` ice phase field, ``gl`` glass phase field) and 30 named physical
parameters with descriptions in ``model.c:32-137``.  Here the same registry
drives Params extraction, NetCDF attribute naming, and logging.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# NetCDF variable names + descriptions (model.c:79-83)
VARIABLES: Tuple[str, ...] = ("u", "p", "gl")
VAR_DESCRIPTIONS: Dict[str, str] = {
    "u": "temperature field",
    "p": "phase field",
    "gl": "glass balls phase field",
}

# (name, description) in the reference's report order; section headers are
# (None, description) rows (model.c:85-137)
PARAM_INFO: List[Tuple[Optional[str], str]] = [
    (None, "Physical parameters"),
    ("u_star", "u*"),
    ("L", "Specific latent heat of fusion of water [J/kg]"),
    ("water_cp", "Heat capacity of liquid water at constant pressure [J/(kg.K)]"),
    ("ice_cp", "Heat capacity of ice at constant pressure [J/(kg.K)]"),
    ("glass_cp", "Heat capacity of glass at constant pressure [J/(kg.K)]"),
    ("water_lambda", "Thermal conductivity of liquid water [W/(m.K)]"),
    ("ice_lambda", "Thermal conductivity of ice [W/(m.K)]"),
    ("glass_lambda", "Thermal conductivity of glass [W/(m.K)]"),
    ("water_rho", "Density of liquid water [kg/m^3]"),
    ("ice_rho", "Density of ice [kg/m^3]"),
    ("glass_rho", "Density of glass [kg/m^3]"),
    (None, "Glass phase field representation parameters"),
    ("ball_radius", "Radius of all glass beads [m]"),
    ("beads_scaling", "Scaling of the glass beads positions"),
    ("beads_offset_x", "Glass beads position offset along the x1 axis"),
    ("beads_offset_y", "Glass beads position offset along the x2 axis"),
    ("beads_offset_z", "Glass beads position offset along the x3 axis"),
    ("xi_gl", "Glass phase interface thickness parameter"),
    ("zeta", "Glass phase field multiplier in water indicator"),
    (None, "Phase field model parameters"),
    ("xi", "Phase interface thickness parameter xi"),
    ("a", "Phase field model parameter a"),
    ("b", "Phase field model parameter b"),
    ("alpha", "Coefficient of attachment kinetics [s/m^2]"),
    ("mu", "Interfacial mobility [m/(s.K)]"),
    (None, "SigmaP1-P model parameters"),
    ("p_eps0", "p S-shape limiter 0-threshold"),
    ("p_eps1", "p S-shape limiter 1-threshold"),
    (None, "Temperature-based freezing model parameters"),
    ("gamma", "Freezing progression factor [1]"),
    (None, "Simulation settings"),
    ("top_temp1", "Temperature at the top of the vessel during Phase 1 [K]"),
    ("top_temp2", "Temperature at the top of the vessel during Phase 2 [K]"),
    ("phase_switch_time", "Time of switchnig from Phase 1 to Phase 2 [s]"),
    ("u_noise_amp", "Temperature noise amplitude"),
]

PARAM_NAMES: Tuple[str, ...] = tuple(n for n, _ in PARAM_INFO if n is not None)


@dataclasses.dataclass(frozen=True)
class FreezingParams:
    """All physical parameters of the freezing model (model.c:44-59)."""

    u_star: float
    L: float
    xi: float
    a: float
    b: float
    alpha: float
    mu: float
    beads_scaling: float
    beads_offset_x: float
    beads_offset_y: float
    beads_offset_z: float
    xi_gl: float
    zeta: float
    p_eps0: float
    p_eps1: float
    gamma: float
    water_cp: float
    ice_cp: float
    glass_cp: float
    water_lambda: float
    ice_lambda: float
    glass_lambda: float
    water_rho: float
    ice_rho: float
    glass_rho: float
    top_temp1: float
    top_temp2: float
    phase_switch_time: float
    u_noise_amp: float
    ball_radius: float

    @staticmethod
    def from_dict(values: Dict[str, float]) -> "FreezingParams":
        return FreezingParams(**{n: float(values[n]) for n in PARAM_NAMES})

    def as_dict(self) -> Dict[str, float]:
        return {n: getattr(self, n) for n in PARAM_NAMES}


def shift_temperature_origin(params: "FreezingParams",
                             offset: float) -> "FreezingParams":
    """Parameters for a temperature state stored as ``u - offset``.

    The temperature enters the model only through differences (fluxes),
    through ``u - u_star`` (reaction terms, phf), and through the
    Dirichlet boundary values — so shifting ``u_star`` and ``top_temp1/2``
    together with the state is *exact*.  With ``offset = u_star`` the f32
    representation of u moves from ~293 K (ulp 3e-5) to [-25, 20] K
    (ulp 2e-6), dropping the error estimator's rounding floor ~16x; this
    is what makes f32 production runs step at the reference's f64 step
    sizes (mixed-precision design; validation runs remain f64/unshifted).
    """
    return dataclasses.replace(
        params,
        u_star=params.u_star - offset,
        top_temp1=params.top_temp1 - offset,
        top_temp2=params.top_temp2 - offset,
    )

"""Benchmark-case configurations.

These generate Params-language text for the reference's published benchmark
cases (BASELINE.md: LR/MR/HR freezing at grid_nodes 100/200/400), authored
from the published physical constants and case setup (Params file of
``apps/intertrack-hybrid-S-freezing``; PhysRevE-2025 cases).  Keeping them
in the Params language (rather than python dicts) exercises the full
config pipeline in benchmarks and gives users a template.
"""

from __future__ import annotations


def freezing_params_text(grid_nodes: int = 100, calc_mode: int = 0,
                         final_time_hours: float = 10.0,
                         saved_files: int = 100,
                         alpha_mult: float = 1.0,
                         zeta: float = 1.05) -> str:
    """Params text for the freezing benchmark at the given resolution.

    ``alpha_mult`` reproduces the reference's "smallsigma" variants
    (sigma ~ 1/alpha): the shipped ``*-smallsigma`` cases set
    ``alpha = water_rho*water_cp*3`` (Cases-LR.tgz Params diff); the
    PhysRevE "tinysigma" revision uses larger factors.  ``zeta`` is the
    glass thermal-coupling exponent, which also varies per shipped case
    (1.0 Temp-LR, 2.0 SigmaP1-P-LR, 1.05 PhysRevE).
    """
    return f"""\
# Freezing/thawing benchmark case (water in a porous glass-bead bed)
# domain 3 cm x 3 cm x 6 cm, {grid_nodes} cells along the long side

icond u = "293.15"
icond p = "z>0.052 and z<0.058 and ((x-L1/2)^2+(y-L2/2)^2 < (L1/3)^2)"
icond gl = "(0.5*(1.0 + tanh(0.5/xi_gl*(z-0.055)))) max (0.5*(1.0 + tanh(0.5/xi_gl*(beads_offset_z-z)))) max (0.5*(1.0 + tanh(0.5/xi_gl*(x-L1+beads_offset_x)))) max (0.5*(1.0 + tanh(0.5/xi_gl*(y-L2+beads_offset_y)))) max (0.5*(1.0 + tanh(0.5/xi_gl*(beads_offset_x-x)))) max (0.5*(1.0 + tanh(0.5/xi_gl*(beads_offset_y-y))))"

set out_file = $OUTPUT/image out_file_suffix = .ncd
set logfile = $OUTPUT/intertrack.log

hours           60*60

# domain dimensions [m]
L1              0.03
L2              0.03
L3              0.06

u_noise_amp     0

# material constants (liquid water / ice / glass)
water_cp        4.18e3
ice_cp          2.05e3
glass_cp        0.84e3
water_lambda    0.6
ice_lambda      2.22
glass_lambda    1.1
water_rho       997
ice_rho         917
glass_rho       2500

u_star          273.15
L               3.34e5

# glass-bead bed geometry
wall_thickness  0.05
beads_scaling   (1-2*wall_thickness)*L1
ball_radius     0.1*beads_scaling
beads_offset_x  wall_thickness*L1
beads_offset_y  beads_offset_x
beads_offset_z  beads_offset_x
xi_gl           L3/500
zeta            {zeta}

# phase-field model
xi              L3/100
a               2
b               1
alpha           water_rho*water_cp{"*" + repr(alpha_mult) if alpha_mult != 1.0 else ""}
mu              1e-4
p_eps0          0.05
p_eps1          0.2
gamma           2

# freezing then thawing
top_temp1       273.15 - 25
top_temp2       273.15 + 20
phase_switch_time 5*hours

calc_mode       {calc_mode}

final_time      {final_time_hours}*hours
saved_files     {saved_files}
delta           1e-3
tau_min         1e-6
tau             1

grid_nodes      {grid_nodes}
multiplier      grid_nodes / (L1 max L2 max L3)
n1              L1 * multiplier
n2              L2 * multiplier
n3              L3 * multiplier

set comment="Benchmark case grid_nodes={grid_nodes} calc_mode={calc_mode}"
"""

"""The least work of one intertrack freezing attempt, whatever implements
it: the bytes that must cross the memory and the operations of the plain
reference's equations (``benchmark/reference/freezing.py``).

Bytes: the state's three fields read once (u, p, gl) and the two that
evolve written once (u, p): 5 planes of the grid in the field's width.

Operations: five right-hand sides and the Merson combination per cell,
each +, -, *, /, comparison, select, max, sqrt, exp and tanh one
operation.  A face flux is shared by the two cells it joins, so a cell
counts three faces; terms of the static glass field are counted as if
formed anew in every right-hand side (the equations' own form).
"""

# one face of div(lambda grad u): the face means of p and gl (2 each),
# the conductivity blend (8), the difference of u (1) and the product (1)
FACE_FLUX = 14
# the divergence of the three axes' face fluxes: 3 faces a cell, (F+ -
# F-) / h^2 by axis (2 x 3) and the sum of the axes (2)
DIV_LAMBDA_GRAD_U = 3 * FACE_FLUX + 6 + 2
# a material blend gl a + (1 - gl)(p b + (1 - p) c)
BLEND = 8
# the water fraction max(1 - zeta gl, 0)
WATER = 3
# the Laplacian of p from 3 face differences a cell: (d+ - d-) / h^2 by
# axis and the sum
LAPLACIAN = 3 + 3 * 2 + 2
# |grad p| from the same differences: (d+ + d-) / 2h, squared, by axis,
# the sum, sqrt and the regularisation
GRAD_NORM = 3 * 3 + 2 + 1 + 1
# the double well p (1 - p)(p - 1/2) a / xi^2
DOUBLE_WELL = 5
# the S-shape limiter of one argument
SSHAPE = 7
# dp/dt = (Laplacian + reaction) / alpha * water fraction
DP_DT = 3 + WATER
# du/dt = (div / rho + L dp/dt) / cp
DU_DT = DIV_LAMBDA_GRAD_U + (BLEND + 1) + 2 + (BLEND + 1)

RHS_OPS = {
    # GradP: reaction c p(1-p)(p-1/2) - b alpha mu |grad p| (u - u*)
    0: LAPLACIAN + GRAD_NORM + DOUBLE_WELL + 4 + DP_DT + DU_DT,
    # SigmaP1-P: the limiters of p and 1 - p, max(p (1 - p), 0), products
    1: LAPLACIAN + DOUBLE_WELL + 2 * SSHAPE + 1 + 3 + 6 + DP_DT + DU_DT,
    # Temp: -gamma/2 sech^2(gamma (u - u*)) in the water fraction (15),
    # rho (cp - L dp/du), du = div / that, dp = dp/du du
    2: DIV_LAMBDA_GRAD_U + 11 + 1 + WATER + 2 * BLEND + 2 + 1 + 1 + 1,
    10: LAPLACIAN + GRAD_NORM + DOUBLE_WELL + 4 + DP_DT,
    11: LAPLACIAN + DOUBLE_WELL + 2 * SSHAPE + 1 + 3 + 6 + DP_DT,
}

# per evolving field: the stage inputs y + h (...) of stages 2-5 (2, 3, 4
# and 7), the error estimate (4 products, 3 sums, abs, max: 9) and the
# update (6)
MERSON_PER_FIELD = 2 + 3 + 4 + 7 + 9 + 6
EVOLVING_FIELDS = 2
STATE_FIELDS = 3


def rhs_ops(calc_mode: int) -> int:
    return RHS_OPS[int(calc_mode)]


def attempt_ops(cells: int, calc_mode: int) -> int:
    """Operations of one attempt on ``cells`` cells."""
    return cells * (5 * rhs_ops(calc_mode)
                    + EVOLVING_FIELDS * MERSON_PER_FIELD)


def attempt_bytes(cells: int, itemsize: int) -> int:
    """Bytes of one attempt: the state read once, u and p written once."""
    return cells * itemsize * (STATE_FIELDS + EVOLVING_FIELDS)


def kernel_bytes(name: str, cells: int, itemsize: int):
    """Bytes that one launch of a stage kernel of the program must move,
    from its name's template arguments <MODE, NK, TAIL, ...>: the state
    (3 planes) and NK stage inputs of 2 planes read, 2 planes written.
    None for other kernels (the commit copies only on an accepted step,
    so its bytes depend on the run)."""
    for stem in ("delta_g_kernel<", "fused_stage_kernel<",
                 "fused_attempt_kernel<"):
        i = name.find(stem)
        if i >= 0:
            args = name[i + len(stem):].split(">")[0].split(",")
            nk = int(args[1])
            return (STATE_FIELDS + 2 * nk + 2) * cells * itemsize
    return None

from .merson import MersonParams, MersonState, merson_solve, merson_init
from .rk4 import rk4_solve, rk4_step
from .dopri import dopri45_solve, DopriResult

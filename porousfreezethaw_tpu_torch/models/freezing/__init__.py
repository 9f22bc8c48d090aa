from .parameters import (FreezingParams, PARAM_INFO, VARIABLES,
                         VAR_DESCRIPTIONS, shift_temperature_origin)
from .equation import make_rhs, CalcMode
from .glass import build_glass_field, read_ball_positions
from .icond import build_initial_conditions

from .attempt import DEMAttempt, dem_solver
from .config import DEMConfig, Wall, DEFAULT_WALLS, VARIANTS
from .coupling import write_final_positions
from .forces import (
    CELL_CHUNK, CellOverflowError, default_cell_bounds, make_cell_list,
    make_dem_rhs, solve_guarded)
from .icond import icond_dense, icond_sparse, icond_2spheres

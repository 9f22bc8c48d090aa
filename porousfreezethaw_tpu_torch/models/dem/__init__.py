from .config import DEMConfig, Wall, DEFAULT_WALLS, VARIANTS
from .coupling import write_final_positions
from .forces import make_dem_rhs
from .icond import icond_dense, icond_sparse, icond_2spheres

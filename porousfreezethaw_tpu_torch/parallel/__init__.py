from .sharding import (Mesh, dem_sharding, gather_dem_state,
                       gather_freezing_state, make_mesh, shard_dem_state,
                       shard_freezing_state)

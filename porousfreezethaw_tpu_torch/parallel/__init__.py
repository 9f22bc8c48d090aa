from .sharding import (Mesh, gather_freezing_state, make_mesh,
                       shard_freezing_state)

"""Device mesh, sharding and processes: the scale-out layer."""

from .distributed import maybe_initialize_distributed
from .mesh import (Mesh, Sharding, ShardedTensor, data_sharding, make_mesh, replicated_sharding,
                   shard_batch, shard_model_variables, visible_devices)

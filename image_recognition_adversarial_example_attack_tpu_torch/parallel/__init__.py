"""Device mesh and sharding: the data axis of the scale-out layer."""

from .mesh import (Mesh, Sharding, ShardedTensor, data_sharding, make_mesh, replicated_sharding,
                   shard_batch, visible_devices)

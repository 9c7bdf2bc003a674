"""Multi-device parallelism: device meshes and sharded pipeline execution."""

from .multihost import MultiHostEngine  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh,
    ShardedEngine,
    make_mesh,
    shard_state,
    sharded_process_block,
)
from .timeshard import TimeShardEngine, timeshard_process_block  # noqa: F401

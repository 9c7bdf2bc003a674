"""Multi-device parallelism: device meshes and sharded pipeline execution."""

from .sharding import (  # noqa: F401
    make_mesh,
    shard_state,
    sharded_process_block,
)

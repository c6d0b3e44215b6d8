"""The device mesh of the port on `torch.distributed` (mirrors
`brutus_tpu.parallel`)."""

from .mesh import (  # noqa: F401
    initialize, make_mesh, model_sharding, data_sharding, replicated,
    shard_grid, pad_to_multiple, Mesh,
)

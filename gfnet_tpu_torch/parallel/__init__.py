"""Several devices: one process a device over `torch.distributed`."""

from gfnet_tpu_torch.parallel.mesh import (Mesh, create_mesh, fsdp_param_sharding, init_distributed, shard_batch,
                                           shard_params)

__all__ = ["Mesh", "create_mesh", "fsdp_param_sharding", "init_distributed", "shard_batch", "shard_params"]

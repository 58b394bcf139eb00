"""Several devices: one process a device over `torch.distributed`."""

from gfnet_tpu_torch.parallel.mesh import Mesh, create_mesh, init_distributed, shard_batch

__all__ = ["Mesh", "create_mesh", "init_distributed", "shard_batch"]

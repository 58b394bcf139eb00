"""Process groups for several devices.

Counterpart of `gfnet_tpu/parallel/mesh.py`. The JAX package is one program
over a mesh of devices, with the batch sharded over its `data` axis and XLA
inserting the collectives. The port runs one process a device instead (one
rank a GPU, NCCL between them; gloo on the CPU): every rank runs the same
program on the same request or step, holds its rows of the batch and
reduces across ranks where the JAX program reduces over the sharded axis:
the gradients, the BatchNorm moments, the loss's means, the homographies a
server returns and the sharded correlation.

A `Mesh` is the process group, its size, this process's rank and its device.
`init_distributed` joins the group from arguments, from torchrun's
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`) or from the JAX package's (`GFNET_COORDINATOR` as host:port,
`GFNET_NUM_PROCESSES`, `GFNET_PROCESS_ID`, `gfnet_tpu/cli/train.py:58-69`).
The frozen ViT stays whole on every rank: the JAX package's
`fsdp_param_sharding` / `shard_params` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the process group: `size` of them, this one `rank`, its
    tensors on `device`. Its collectives run over the group whatever its
    size, a world of one included; one process without a group is
    `mesh=None` wherever a mesh is taken."""

    size: int
    rank: int
    device: torch.device

    def all_reduce(self, x: Tensor) -> Tensor:
        """The sum of `x` over the ranks, differentiable: every rank holds
        the sum, and the backward sums the ranks' gradients of it. A rank's
        own terms then carry `size` times their share of the gradient of a
        loss that every rank computes alike, so the parameters' gradients
        are averaged over the ranks (`train/step.py`)."""
        return _AllReduceSum.apply(x)

    @torch.no_grad()
    def all_reduce_(self, x: Tensor, op: str = "sum") -> Tensor:
        """`x` reduced over the ranks in place ("sum" or "max"), no gradient."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
        return x

    def all_gather_rows(self, x: Tensor) -> Tensor:
        """Every rank's `x` (of one shape on all), stacked along the first
        axis in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of `n`, which the mesh divides."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _from_env() -> tuple[str | None, int | None, int | None, int]:
    """(init method, world size, rank, local rank) from torchrun's or the
    JAX package's environment; Nones where neither is set."""
    env = os.environ
    if env.get("GFNET_COORDINATOR"):
        rank = int(env["GFNET_PROCESS_ID"])
        return (f"tcp://{env['GFNET_COORDINATOR']}", int(env["GFNET_NUM_PROCESSES"]), rank,
                int(env.get("LOCAL_RANK", rank)))
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"]), int(env.get("LOCAL_RANK", 0))
    return None, None, None, 0


def init_distributed(device: str = "cuda", init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> Mesh:
    """Join the process group and return its mesh. The backend is NCCL on
    "cuda" (this rank on `cuda:LOCAL_RANK`) and gloo on "cpu"; there is no
    fallback from one to the other. Arguments left out come from the
    environment (module docstring). A process already in a group returns
    that group's mesh."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process group for device {device!r}")
    env_method, env_world, env_rank, local_rank = _from_env()
    init_method = init_method or env_method
    world_size = env_world if world_size is None else world_size
    rank = env_rank if rank is None else rank
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA, and torch.cuda.is_available() is False")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        if init_method is None or world_size is None or rank is None:
            raise ValueError("init_distributed needs an init method, a world size and a rank, "
                             "as arguments or from the environment")
        # binding the group to its device lets NCCL connect eagerly
        kw = {"device_id": dev} if kind == "cuda" else {}
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    return create_mesh(dev)


def create_mesh(device) -> Mesh:
    """The mesh of the process group this process has joined, with this
    rank's tensors on `device`."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call init_distributed first")
    return Mesh(dist.get_world_size(), dist.get_rank(), torch.device(device))


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of every array of a batch that the mesh divides (the
    JAX package's `shard_batch`, where each process holds its own rows)."""
    return {k: v[mesh.rows(len(v))] for k, v in batch.items()}

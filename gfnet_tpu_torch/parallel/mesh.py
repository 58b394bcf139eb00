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

The frozen ViT can be sharded over the ranks (`shard_params`, the JAX
package's FSDP rule of `fsdp_param_sharding`): each rank keeps its slice of
every large leaf, and each block all-gathers its leaves just before it runs
and frees them after, so at most one block's full weights are resident. The
ViT is frozen and runs without gradient, so nothing is reduce-scattered.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
import torch.nn as nn

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


# torch 2.13 names all_gather_into_tensor all_gather_single and warns on the
# old name; earlier releases (2.11) have only the old one
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def fsdp_param_sharding(mesh: Mesh, module_or_named_params, min_size: int = 2**16) -> dict[str, int | None]:
    """The JAX package's FSDP rule (`gfnet_tpu/parallel/mesh.py:53-82`) on the
    port's tensors: name → the axis a leaf is split on over the ranks, or
    None for a leaf that stays whole. A leaf of at least `min_size` elements
    is split on its largest axis that `mesh.size` divides (the first such
    axis on ties); smaller leaves, and leaves with no such axis, stay whole.
    Takes a module (its `named_parameters()`) or (name, tensor) pairs. The
    JAX package holds the ViT's blocks stacked over depth, so a block leaf is
    `depth` times larger there: at ViT-L and 2¹⁶ its qkv and fc1 biases
    (24 × 3072, 24 × 4096) are split there and whole here (0.06% of the
    ViT's bytes); the weights split alike."""
    named = module_or_named_params.named_parameters() if isinstance(module_or_named_params, nn.Module) \
        else module_or_named_params
    spec = {}
    for name, x in named:
        axis = None
        if x.numel() >= min_size:
            for i, d in enumerate(x.shape):
                if d % mesh.size == 0 and (axis is None or d > x.shape[axis]):
                    axis = i
        spec[name] = axis
    return spec


class _ShardedLeaves:
    """The split leaves of one module: this rank's slices, packed into one
    flat buffer that each leaf's `.data` views between calls. `gather()`
    all-gathers the buffer in one collective and points every leaf at its
    full tensor; `free()` points them back at the slices, so the full
    tensors go as soon as the module's forward is done."""

    def __init__(self, mesh: Mesh, leaves: list):
        self.mesh = mesh
        self.leaves = []  # (parameter, axis, full shape, offset in the buffer, slice shape)
        slices, offset = [], 0
        for p, axis in leaves:
            part = p.shape[axis] // mesh.size
            piece = p.detach().narrow(axis, mesh.rank * part, part)
            self.leaves.append((p, axis, tuple(p.shape), offset, tuple(piece.shape)))
            slices.append(piece.reshape(-1))
            offset += piece.numel()
        if len({t.dtype for t in slices}) != 1:
            raise ValueError("shard_params: the split leaves of one module must share a dtype")
        self.flat = torch.cat(slices)  # a copy: the full tensors go with the last reference to them
        self.gathers = 0
        self.free()

    def gather(self) -> None:
        n = self.mesh.size
        # outside inference mode, so that the leaves stay normal tensors
        with torch.inference_mode(False), torch.no_grad():
            out = torch.empty(n * self.flat.numel(), dtype=self.flat.dtype, device=self.flat.device)
            _all_gather_flat(out, self.flat)
            ranks = out.view(n, -1)
            for p, axis, full, offset, shape in self.leaves:
                pieces = ranks[:, offset:offset + math.prod(shape)].reshape(n, *shape)
                p.data = pieces.movedim(0, axis).reshape(full)
        self.gathers += 1

    def free(self) -> None:
        for p, _, _, offset, shape in self.leaves:
            p.data = self.flat[offset:offset + math.prod(shape)].view(shape)


@dataclasses.dataclass
class FSDPState:
    """What `shard_params` did to a module: the mesh, the split axis of
    each leaf (`fsdp_param_sharding`'s spec), and one `_ShardedLeaves` for
    each module that gathers before it runs (module name → group)."""

    mesh: Mesh
    spec: dict
    groups: dict

    @property
    def gathers(self) -> int:
        """All-gathers run so far, one for each module call."""
        return sum(g.gathers for g in self.groups.values())


def _refuse_state_dict(module, prefix, keep_vars) -> None:
    raise RuntimeError("this module's parameters are split over the ranks (parallel.mesh.shard_params): "
                       "its state_dict would hold this rank's slices only")


def shard_params(mesh: Mesh, vit: nn.Module, min_size: int = 2**16) -> nn.Module:
    """Shard the frozen ViT over the ranks of `mesh`, in place, by
    `fsdp_param_sharding`'s rule; returns it. Each rank keeps its slice of
    every split leaf and frees the full tensors. A forward pre-hook on each
    block of `vit.blocks`, on each other module that holds a split leaf (the
    patch embedding), and on `vit` itself for its own leaves (the position
    embedding) all-gathers that module's leaves in one collective, and a
    forward hook frees them again: at most one block's full weights are
    resident besides the ViT's own leaves. Every rank runs the ViT together,
    on its own rows. The ViT runs without gradient, so nothing is
    reduce-scattered. `state_dict()` of a sharded module raises rather than
    hand out slices. A ViT already sharded over `mesh` is returned as it is."""
    done = getattr(vit, "fsdp", None)
    if done is not None:
        if done.mesh != mesh:
            raise ValueError("shard_params: the ViT is already sharded over another mesh")
        return vit
    spec = fsdp_param_sharding(mesh, vit, min_size)
    owners: dict[str, list] = {}
    for name, axis in spec.items():
        if axis is None:
            continue
        parts = name.split(".")
        if parts[0] == "blocks":  # a block gathers all its leaves at once
            owner = ".".join(parts[:2])
        else:
            owner = ".".join(parts[:-1])
        owners.setdefault(owner, []).append((vit.get_parameter(name), axis))
    groups = {}
    for owner, leaves in owners.items():
        module = vit.get_submodule(owner)
        group = _ShardedLeaves(mesh, leaves)
        module.register_forward_pre_hook(lambda mod, args, g=group: g.gather())
        module.register_forward_hook(lambda mod, args, out, g=group: g.free())
        module.register_state_dict_pre_hook(_refuse_state_dict)
        groups[owner] = group
    if "" not in groups:
        vit.register_state_dict_pre_hook(_refuse_state_dict)
    vit.fsdp = FSDPState(mesh, spec, groups)
    return vit

"""The device mesh of multi-device training (port of
elliptic_gnn_tpu/parallel/mesh.py).

A 1-D mesh over the `nodes` axis: node rows (destination chunks) are split
across the ranks of a torch.distributed process group, one process per
rank; the dense parameters stay replicated. Rank r uses cuda:{r % cards},
or the CPU under `device: cpu`. The backend follows the device: NCCL for
CUDA tensors, gloo for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

NODE_AXIS = "nodes"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: `size` ranks, this one `rank`, its
    `device`, and the mesh's process `group`."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_devices(n_devices: int, device_type: str) -> None:
    """Raises where a CUDA mesh asks for more ranks than this host has
    cards (NCCL does not run two ranks on one card)."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if n_devices > count:
            raise ValueError(
                f"requested {n_devices} devices, only {count} available")


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("a CUDA mesh needs a GPU and none is available")
        return torch.device("cuda", rank % count)
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda") -> Mesh:
    """The mesh over the initialized default process group; `n_devices`,
    where given, must be its size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(parallel/multihost.py: maybe_initialize or world_of_one)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"requested {n_devices} devices, the process group has {world} ranks")
    return Mesh(size=world, rank=rank, device=rank_device(rank, device_type),
                group=dist.group.WORLD)


class _AllReduceSum(torch.autograd.Function):
    """psum over the group: the sum of every rank's tensor on every rank.
    Its transpose is psum again: each rank's output feeds that rank's own
    share of the loss, so the cotangent of an input is the sum of every
    rank's output cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        out = ct.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def psum(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Differentiable all-reduce (SUM) over `group` (None: the world)."""
    return _AllReduceSum.apply(t, group)

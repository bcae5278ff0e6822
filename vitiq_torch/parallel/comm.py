"""Process groups and collectives for the device mesh.

Every rank is one process. `init_distributed` starts the default process
group from `torchrun`'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or
from an explicit rank, world size and ``file://`` store (`spawn`'s
workers), and places the rank on ``cuda:LOCAL_RANK`` (modulo the cards the
machine has) or on the CPU when the CPU is asked for.

Backend: NCCL when the rank runs on a card and every local rank has a card
of its own; gloo otherwise (the CPU, or more ranks than cards: NCCL refuses
two ranks on one device). Gloo takes CUDA tensors for `broadcast` and
`all_reduce` only, so every collective of the mesh is one of the two (a
gather is an all-reduce of a zeroed buffer). The choice is made from the
machine before the group starts; a failing NCCL raises, it is never swapped
for gloo.

`copy_to_model` and `reduce_from_model` are Megatron's pair of autograd
functions for the model axis: identity forward / all-reduce backward before
a column-parallel projection, all-reduce forward / identity backward after a
row-parallel one. They reduce in f32.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL where every local rank has a card of its own, gloo otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` (ranks past the machine's cards
    share them in turn) for a CUDA request, else `device` as given."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but CUDA is not available; "
                           "pass device='cpu' to run on the host")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None, init_method: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     verbose: bool = True) -> Tuple[torch.device, str]:
    """Start the default process group (if it is not started) and return
    (the rank's device, the backend). Without an explicit `rank` /
    `world_size` they come from the started group, else from torchrun's
    environment; `init_method` defaults to ``env://``. On a card the rank's
    device is made current before the group starts, so every kernel and
    collective of the rank runs there."""
    env = os.environ
    if is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    device = rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(device, local_world_size)
    if not is_initialized():
        if verbose and rank == 0:
            print(f"process group: backend {backend}, world {world_size}, "
                  f"{local_world_size} local ranks on "
                  f"{torch.cuda.device_count() if device.type == 'cuda' else 0} cards",
                  flush=True)
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return device, dist.get_backend()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def _entry(index: int, world: int, init_method: str, device: str, fn: Callable, args) -> None:
    init_distributed(device, rank=index, world_size=world, init_method=init_method,
                     local_rank=index, local_world_size=world, verbose=False)
    try:
        fn(index, world, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, *args, device: str = "cuda") -> None:
    """Run ``fn(rank, world, *args)`` in `world` new processes
    (`torch.multiprocessing`, the spawn method), each with the default
    process group started over a ``file://`` store and placed on its card
    (``device="cpu"`` for the host); raises if any of them fails. `fn` must
    be importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="vitiq_torch_pg_") as tmp:
        init_method = (Path(tmp) / "store").as_uri()
        mp.spawn(_entry, args=(world, init_method, device, fn, args), nprocs=world, join=True)


def agree(value):
    """Rank 0's `value` on every rank (itself in a group of one)."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group` (nothing when the group is None: an
    axis of one rank)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` in place from global rank `src` over `group` (None: nothing)."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    out = x.float().contiguous().clone()
    all_reduce_(out, group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _reduced(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over the model group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over the model group forward, identity backward."""
    return x if group is None else _ReduceFromModel.apply(x, group)

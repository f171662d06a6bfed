"""The collectives of kaamer_tpu/parallel/mesh.py over one dp row of a
(dp, shard) grid, in plain torch.

Each function takes a list with one tensor per shard, each on that shard's
device, and returns such a list: the result for shard i lives on the
device of xs[i].  These are the tiled lax collectives of the JAX package
(shard_map over the "shard" axis).  Where shards share a device, `.to` is
a no-op and a collective is a reshape; across cards it is a peer copy,
which PyTorch orders after the source stream's work.

dp_all_gather is the one collective that crosses processes: the JAX
engine's dp axis spans hosts, and so does this one, over the default
torch.distributed process group when one is initialised.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device, non_blocking=True)


def _chunks(x: torch.Tensor, n: int, dim: int):
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split into {n} shards")
    return torch.chunk(x, n, dim)


def all_to_all(xs: List[torch.Tensor], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """lax.all_to_all(tiled=True): shard i receives chunk i of every
    shard's split_dim, concatenated in shard order along concat_dim."""
    parts = [_chunks(x, len(xs), split_dim) for x in xs]
    return [torch.cat([_to(p[i], xi) for p in parts], concat_dim)
            for i, xi in enumerate(xs)]


def all_gather(xs: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """lax.all_gather(tiled=True): every shard's tensor, concatenated in
    shard order along dim, on every shard."""
    return [torch.cat([_to(x, xi) for x in xs], dim) for xi in xs]


def psum(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """lax.psum: the elementwise sum over shards, in the inputs' dtype."""
    return [torch.stack([_to(x, xi) for x in xs]).sum(0, dtype=xi.dtype)
            for xi in xs]


def pmax(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """lax.pmax: the elementwise maximum over shards."""
    return [torch.stack([_to(x, xi) for x in xs]).amax(0) for xi in xs]


def psum_scatter(xs: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """lax.psum_scatter(tiled=True): shard i gets the sum over shards of
    chunk i of dim."""
    parts = [_chunks(x, len(xs), dim) for x in xs]
    return [torch.stack([_to(p[i], xi) for p in parts]).sum(
        0, dtype=xi.dtype) for i, xi in enumerate(xs)]


def world() -> tuple:
    """(size, rank) of the default process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def dp_all_gather(t: torch.Tensor) -> torch.Tensor:
    """lax.all_gather over the dp axis where it crosses processes: every
    process's t concatenated along dim 0 in rank order, over the default
    process group (gloo for CPU tensors, NCCL for CUDA ones).  The
    identity without a process group or with one process."""
    size, _ = world()
    if size == 1:
        return t
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous())
    return torch.cat(out, 0)

"""The global batch over ranks, and the gradients' all-reduce.

Counterpart of ``dsl_tpu/parallel/mesh.py``. The JAX package shards a
global batch's leading axis over the mesh's ``data`` axis and replicates
the state; here rank ``r`` of ``W`` holds shard ``r`` of the global batch
and a replica of the state, and :func:`allreduce_grads` sums the
gradients over the ranks, which is what XLA's all-reduce gives the mesh.
An FSDP counterpart (``fsdp_sharding``) is not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# gradients summed per all-reduce: a few calls instead of one per tensor
BUCKET_BYTES = 25 * 2 ** 20


def local_batch_size(global_batch: int, world_size: int) -> int:
    """The rows of a global batch each rank holds; raises where it does not
    split evenly, as ``shard_batch`` does."""
    if global_batch % world_size:
        raise ValueError(f"batch leading dim {global_batch} not divisible by "
                         f"data axis {world_size}")
    return global_batch // world_size


def rank_slice(items: list, rank: int, world_size: int) -> list:
    """Rank ``rank``'s contiguous share of a global sample list."""
    per = local_batch_size(len(items), world_size)
    return items[rank * per:(rank + 1) * per]


def allreduce_grads(params, group) -> None:
    """Sum every parameter's gradient over ``group`` in place: the
    gradients packed into flat buckets of one dtype and device (about
    ``BUCKET_BYTES`` each), one ``all_reduce(SUM)`` per bucket, written
    back. Parameters without a gradient (frozen) are skipped. Nothing where
    ``group`` is None."""
    if group is None:
        return
    bucket, size = [], 0
    grads = [p.grad for p in params if p.grad is not None]
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i + 1 == len(grads)
        if (size >= BUCKET_BYTES or last
                or (grads[i + 1].dtype, grads[i + 1].device) != (g.dtype, g.device)):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            bucket, size = [], 0


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor; ``t`` itself where
    ``group`` is None)."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast_state(tensors, group, src: int = 0) -> None:
    """Every tensor given rank ``src``'s values, in place."""
    if group is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)

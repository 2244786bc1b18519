"""Collectives that carry gradients, as small autograd Functions.

The JAX package's multi-device code runs inside ``shard_map``, where JAX
derives each collective's transpose. Here each rank is a process of its
own, and autograd crosses a collective only through these Functions:

* :func:`all_to_all`: row ``d`` of ``x [D, ...]`` goes to rank ``d`` of the
  group, and row ``s`` of the result came from rank ``s``. Its transpose is
  the same exchange of the cotangents, the other way round.
* :func:`all_reduce_sum`: the sum over the group's ranks. Each rank's result
  is taken to feed that rank's own term of a loss summed over ranks, so the
  cotangent of ``x`` is the sum of every rank's cotangent (another
  all-reduce). A loss that every rank computes alike from the result counts
  once per rank under this rule.
* :func:`all_gather`: the ranks' tensors concatenated along dim 0, in rank
  order. Its transpose is a reduce-scatter: the cotangents summed over the
  ranks, each rank keeping its own slice. It is written as an all-reduce
  and a slice, which gloo and NCCL both run.

Every rank of the group must call the same collectives in the same order,
in the forward and in the backward. Gloo takes CUDA tensors for each of
these calls (it stages them through the host itself), so ranks that share
a card run them as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_to_all_raw(x: torch.Tensor, group=None) -> torch.Tensor:
    """The exchange without autograd: ``x [D, ...]`` -> ``[D, ...]``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_raw(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """A reduced copy of ``x`` over the group, without autograd."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def broadcast_raw(*tensors: torch.Tensor, group=None) -> tuple:
    """The group's first rank's ``tensors`` on every rank of the group
    (copies), without autograd."""
    out = tuple(t.detach().clone().contiguous() for t in tensors)
    for t in out:
        dist.broadcast(t, group=group, group_src=0)
    return out


def all_gather_raw(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 in rank order, without
    autograd."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_raw(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, group=ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        summed = all_reduce_raw(g, group=ctx.group)
        return summed[rank * ctx.n:(rank + 1) * ctx.n], None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-to-all of ``x [D, ...]`` over ``group``."""
    return _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (see the module
    docstring for its cotangent)."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable concatenation of every rank's ``x`` along dim 0."""
    return _AllGather.apply(x, group)

"""Tensor parallelism inside the layers, and the batch rows a rank holds.

A parameter that ``parallel.shard_params`` splits over the mesh's
``model`` axis carries a ``Shard`` as its ``tp`` attribute: the dimension
it is split along, the group of the axis, the group's size and this rank's
place in it. The layers keep every activation whole on every rank, so the
kernels see every head (the talking-heads mix couples them), as XLA does
around the Pallas custom call of the JAX package:

  * a column-parallel product (``Dense`` with ``w`` split along its output
    features, a logits head) runs on this rank's columns and gathers its
    output features;
  * a row-parallel product (``w`` split along its input features) slices
    its input's features and all-reduces the partial sums (in fp32);
  * a feature-split embedding gathers its features;
  * a head-split parameter read directly (``null_k``, ``null_v``) is
    gathered before use (``whole``).

The collectives are small autograd functions whose backward follows the
Megatron pairs (Shoeybi et al., 2019): the input of a column-parallel
product is the identity forward and an all-reduce backward, its gathered
output an all-gather forward and a slice backward; the input of a
row-parallel product a slice forward and an all-gather backward, its output
an all-reduce forward and the identity backward. (DTensor does not pass
through the port's autograd functions and CUDA extension ops, and
``torch.distributed.nn.functional.all_gather`` sums its backward over the
ranks, which would multiply the gradient of a replicated activation by the
group's size.)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shard:
    """Where a tensor's part lies on a mesh axis: split along ``dim`` into
    ``size`` equal parts over ``group``; this rank holds part ``rank``."""

    dim: int
    group: object
    size: int
    rank: int

    def part(self, t):
        """This rank's part of the whole tensor ``t``."""
        return t.chunk(self.size, self.dim)[self.rank].contiguous()

    def gather(self, t):
        """The whole tensor from every rank's part ``t`` (no gradient)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, self.dim)


def shard_of(t):
    """The ``Shard`` of a tensor split over the model axis, or None."""
    return getattr(t, "tp", None)


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``shard.dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.gather(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.part(grad), None


class _Scatter(torch.autograd.Function):
    """This rank's slice along ``shard.dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.part(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.gather(grad), None


def _along(shard, dim):
    return Shard(dim, shard.group, shard.size, shard.rank)


def whole(t):
    """A parameter whole on every rank: gathered along its shard's
    dimension when it is split (this rank's slice of the gradient flows
    back), else itself."""
    shard = shard_of(t)
    return t if shard is None else _Gather.apply(t, shard)


def column(x, w, shard):
    """``x @ w`` with ``w`` this rank's output columns: the whole output."""
    return _Gather.apply(_Copy.apply(x, shard) @ w, _along(shard, -1))


def row(x, w, shard):
    """``x @ w`` with ``w`` this rank's input rows: the whole output. The
    partial products are taken and summed in fp32 and the sum is rounded
    once to x's dtype, as one product over every row accumulates in fp32
    and rounds once (bf16 partials would round twice)."""
    part = _Scatter.apply(x, _along(shard, -1)).float() @ w.float()
    return _Reduce.apply(part, shard).to(x.dtype)


def gathered_features(x, shard):
    """Every rank's features of ``x`` (this rank's along its last axis)."""
    return _Gather.apply(x, _along(shard, -1))


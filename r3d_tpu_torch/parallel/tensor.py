"""The tensor- and expert-parallel collectives that the model's layers call.

Megatron's split, written out over ``all_reduce`` alone (the only
collective, with ``broadcast``, that gloo carries for CUDA tensors as well
as CPU ones, so one code path runs on gloo and on NCCL). Every rank of an
axis holds the same rows and computes the same loss, so a gradient is
never averaged over tp or ep: each rank's share of it is summed where the
forward split the work.

- ``copy_to`` (Megatron's *f*): the input of a column-parallel product,
  identity forward, the ranks' input gradients summed backward;
- ``reduce_from`` (*g*): the output of a row-parallel product, the ranks'
  partial sums added forward (in fp32), identity backward;
- ``gather_from``: a column-parallel output made whole, each rank's slice
  in a zero-filled fp32 tensor summed forward (exact), the rank's slice of
  the gradient backward.

Sequence parallelism (the sp axis) keeps another convention: every sp rank
computes a loss, and the trainer averages the gradients over the dp x sp
ranks, so a collective's backward is the adjoint of its forward taken over
the sum of the ranks' losses:

- ``gather_seq``: a rank's ``[B, S/sp, ...]`` block made whole along axis 1,
  exact as ``gather_from`` is; backward, the ranks' gradients of the whole
  tensor summed, then the rank's block (``parallel.mesh.gather_rows``'
  convention). What runs after it runs replicated on the sp ranks, as JAX's
  program computes it on each sp device;
- ``cut_seq``: the rank's block of a tensor every sp rank holds whole, a
  plain slice, whose backward (zeros elsewhere) is already that adjoint.

An ``Axis`` is what a module holds of one mesh axis: its group, its extent
and this rank's place on it. Layers without one (``None``) compute as one
process does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as a module sees it: ``size`` ranks in ``group``, this
    one at ``rank``."""
    group: dist.ProcessGroup
    size: int
    rank: int

    def part(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` entries."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.float().contiguous().clone()
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        n = x.shape[-1]
        full = x.new_zeros(x.shape[:-1] + (n * axis.size,), dtype=torch.float32)
        full[..., axis.rank * n:(axis.rank + 1) * n] = x
        dist.all_reduce(full, group=axis.group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.axis.part(g.shape[-1])].contiguous(), None


class _Sum(torch.autograd.Function):
    """Sum over the group; the backward sums the ranks' gradients, so each
    rank's input gets the gradient of every rank's loss through it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` summed over ``group`` (``x`` itself for None), with gradients."""
    return x if group is None else _Sum.apply(x, group)


def gather_block(x: torch.Tensor, group: dist.ProcessGroup, rank: int, size: int,
                 dim: int = 0) -> torch.Tensor:
    """The whole tensor of which ``x`` is block ``rank`` of ``size`` along
    ``dim``, the blocks in rank order over ``group``: ``x`` in a zero-filled
    tensor (fp32 for floats, int64 else) summed over the group, exact; a
    gradient reaches each rank's block from every rank's loss."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    wide = torch.float64 if x.dtype == torch.float64 else (
        torch.float32 if x.is_floating_point() else torch.int64)
    full = x.new_zeros(shape, dtype=wide)
    full.narrow(dim, rank * n, n).copy_(x)
    if x.requires_grad:
        return sum_over(full, group).to(x.dtype)
    dist.all_reduce(full, group=group)
    return full.to(x.dtype)


def gather_seq(x: torch.Tensor, axis: Optional[Axis], dim: int = 1) -> torch.Tensor:
    """``x``'s axis ``dim``, cut over the sp ``axis``, made whole (exact);
    a gradient reaches each rank's block from every rank's loss."""
    return x if axis is None else gather_block(x, axis.group, axis.rank, axis.size, dim)


def cut_seq(x: torch.Tensor, axis: Optional[Axis], dim: int = 1) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, which every rank of the sp
    ``axis`` holds whole."""
    if axis is None:
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


def seq_positions(table: torch.Tensor, S: int, axis: Optional[Axis], dim: int = 0
                  ) -> torch.Tensor:
    """The rows of a position ``table`` for a stream of ``S`` frames along
    ``dim``: the first S, or on the sp ``axis`` this rank's own range of
    them, ``[r S, (r+1) S)``."""
    start = 0 if axis is None else axis.rank * S
    return table.narrow(dim, start, S)


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if axis is None else _Copy.apply(x, axis.group)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if axis is None else _Reduce.apply(x, axis.group)


def gather_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x``'s last axis, split over ``axis``, made whole."""
    return x if axis is None else _Gather.apply(x, axis)

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


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if axis is None else _Copy.apply(x, axis.group)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if axis is None else _Reduce.apply(x, axis.group)


def gather_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x``'s last axis, split over ``axis``, made whole."""
    return x if axis is None else _Gather.apply(x, axis)

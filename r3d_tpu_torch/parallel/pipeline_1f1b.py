"""1F1B (one forward, one backward) pipeline schedule over the pp axis.

Counterpart of ``r3d_tpu/parallel/pipeline_1f1b.py``: the forward, the
per-microbatch loss at the last stage and the backward of a
stage-partitioned model in one program, returning the loss and the
gradients. The schedule is JAX's closed form, each pp rank d running at
most one op a tick:

    fwd(m, d)  at tick  m + d     where m + d <= pp - 1   (fill)
                        2m + d    otherwise               (steady)
    bwd(m, d)  at tick  2m + 2pp - 1 - d

over T = 2(M + pp - 1) ticks. The last stage runs no forward tick: at its
backward tick it runs its stage, ``last`` (norm, heads, loss) and the
backward of both, fused. Every backward tick recomputes its stage's
forward from the saved boundary input (at most pp of them wait on a rank)
and differentiates it, the dropout masks redrawn from the forward tick's
seeds (``parallel/pipeline.py``, ``stage_generators``). A rank skips the
ticks where it has no op; the hops (the activation one rank on, the
cotangent one rank back, ``pipeline.exchange``) run on every tick, on
every rank.

Returned, summed over the rank's microbatches: the losses and metrics
(the last stage's, summed over pp so every rank holds them), the stage
parameters' gradients (each layer's from its owner, summed over pp), the
last parameters' (the last stage's, summed over pp), and per microbatch
the cotangents of the side inputs (every stage reads them: summed over
pp) and of the injected input (stage 0's, summed over pp). Per-microbatch
losses are summed: dividing by M gives ``make_accum_step``'s mean of
microbatches.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from r3d_tpu_torch.parallel.pipeline import exchange, sum_over_pp
from r3d_tpu_torch.parallel.tensor import Axis

Consts = Dict[str, Optional[torch.Tensor]]


def fwd_tick(m: int, d: int, pp: int) -> int:
    return m + d if m + d <= pp - 1 else 2 * m + d


def bwd_tick(m: int, d: int, pp: int) -> int:
    return 2 * m + 2 * pp - 1 - d


def schedule(pp: int, M: int) -> Dict[Tuple[int, int], Tuple[str, int]]:
    """{(tick, stage): ("F" or "B", microbatch)}: the closed form above (the
    last stage has no "F")."""
    ops = {}
    for m in range(M):
        for d in range(pp):
            if d < pp - 1:
                ops[(fwd_tick(m, d, pp), d)] = ("F", m)
            ops[(bwd_tick(m, d, pp), d)] = ("B", m)
    return ops


def pipelined_value_and_grad(
        stage: Callable[[torch.Tensor, Consts, Dict, int], torch.Tensor],
        last: Callable[[torch.Tensor, Consts, Dict, int], Tuple[torch.Tensor, Dict]],
        stage_params: Sequence[nn.Parameter], last_params: Sequence[nn.Parameter],
        inject: List[torch.Tensor], consts: List[Consts], aux: List[Dict], axis: Axis):
    """Run the schedule over ``len(inject)`` microbatches on the pp ``axis``.

    - ``stage(x, consts_m, aux_m, m)``: this rank's layers on microbatch m;
    - ``last(y, consts_m, aux_m, m) -> (loss, metrics)``: the tail on the
      last stage, a scalar loss and a dict of scalar metrics;
    - ``stage_params``: every layer's parameters (all ranks', so each
      gradient is summed over pp); ``last_params`` the tail's;
    - ``inject``: stage 0's input per microbatch; ``consts``: the
      differentiable side inputs per microbatch; ``aux``: the rest.

    Returns (loss sum, metric sums, stage gradients, last gradients,
    injected cotangents, side-input cotangents)."""
    d, pp, M = axis.rank, axis.size, len(inject)
    ops = schedule(pp, M)
    zeros = torch.zeros_like(inject[0])
    held: Dict[int, torch.Tensor] = {}      # arrived activations, by microbatch
    y_in = dx_in = zeros
    g_stage: List[Optional[torch.Tensor]] = [None] * len(stage_params)
    g_last: List[Optional[torch.Tensor]] = [None] * len(last_params)
    d_inject: List[Optional[torch.Tensor]] = [None] * M
    d_consts: List[Dict[str, Optional[torch.Tensor]]] = [dict.fromkeys(c) for c in consts]
    loss_sum = torch.zeros((), device=zeros.device)
    metric_sums: Dict[str, torch.Tensor] = {}

    def add(acc, i, g):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g

    for t in range(2 * (M + pp - 1)):
        # the activation that arrived: stage d - 1's forward of the last tick
        if d > 0:
            prev = ops.get((t - 1, d - 1))
            if prev is not None and prev[0] == "F":
                held[prev[1]] = y_in
        op = ops.get((t, d))
        y_out = dx_out = zeros
        if op is not None and op[0] == "F":
            m = op[1]
            x = inject[m] if d == 0 else held[m]
            with torch.no_grad():
                y_out = stage(x, consts[m], aux[m], m)
        elif op is not None:
            m = op[1]
            x = (inject[m] if d == 0 else held.pop(m)).detach().requires_grad_()
            cl = {k: None if v is None else v.detach().requires_grad_(v.is_floating_point())
                  for k, v in consts[m].items()}
            wrt_c = [k for k, v in cl.items() if v is not None and v.requires_grad]
            with torch.enable_grad():
                y = stage(x, cl, aux[m], m)
                if d == pp - 1:
                    loss, metrics = last(y, cl, aux[m], m)
                    got = torch.autograd.grad(
                        loss.float(), [x] + [cl[k] for k in wrt_c] + list(stage_params)
                        + list(last_params), allow_unused=True)
                    loss_sum = loss_sum + loss.detach().float()
                    for k, v in metrics.items():
                        metric_sums[k] = metric_sums.get(k, 0.0) + v.detach().float()
                else:
                    got = torch.autograd.grad(
                        y, [x] + [cl[k] for k in wrt_c] + list(stage_params),
                        dx_in.to(y.dtype), allow_unused=True)
            dx_out = torch.zeros_like(x) if got[0] is None else got[0].detach()
            for i, k in enumerate(wrt_c):
                d_consts[m][k] = got[1 + i]
            n = 1 + len(wrt_c)
            for i in range(len(stage_params)):
                add(g_stage, i, got[n + i])
            if d == pp - 1:
                for i in range(len(last_params)):
                    add(g_last, i, got[n + len(stage_params) + i])
            if d == 0:
                d_inject[m] = dx_out
        (y_in,), (dx_in,) = exchange([y_out.to(zeros.dtype)], [dx_out.to(zeros.dtype)], axis)

    # every rank sums the same list: zeros where it computed nothing
    keys = sorted(metric_sums) if d == pp - 1 else None
    keys = _agree(keys, axis)
    flat = [loss_sum] + [metric_sums.get(k, torch.zeros((), device=zeros.device)) for k in keys]
    flat += [torch.zeros_like(p) if g is None else g for p, g in zip(stage_params, g_stage)]
    flat += [torch.zeros_like(p) if g is None else g for p, g in zip(last_params, g_last)]
    flat += [torch.zeros_like(inject[m]) if g is None else g for m, g in enumerate(d_inject)]
    cons = [(m, k) for m in range(M) for k, v in consts[m].items()
            if v is not None and v.is_floating_point()]
    flat += [torch.zeros_like(consts[m][k]) if d_consts[m][k] is None else d_consts[m][k]
             for m, k in cons]
    out = sum_over_pp(flat, axis)
    loss_sum, metric_sums = out[0], dict(zip(keys, out[1:1 + len(keys)]))
    at = 1 + len(keys)
    g_stage = out[at:at + len(stage_params)]
    at += len(stage_params)
    g_last = out[at:at + len(last_params)]
    at += len(last_params)
    d_inject = out[at:at + M]
    at += M
    d_consts = [dict.fromkeys(c) for c in consts]
    for (m, k), g in zip(cons, out[at:]):
        d_consts[m][k] = g
    return loss_sum, metric_sums, g_stage, g_last, d_inject, d_consts


def _agree(keys: Optional[List[str]], axis: Axis) -> List[str]:
    """The last stage's metric names on every pp rank."""
    box = [keys]
    dist.broadcast_object_list(box, src=dist.get_global_rank(axis.group, axis.size - 1),
                               group=axis.group)
    return box[0]

"""Mixture-of-Experts feed-forward: ``moe_experts > 0`` replaces every FFN of
the encoder and the decoder.

Counterpart of ``r3d_tpu/models/moe.py`` (``MoEFeedForward``), the same
function:

- the router is a bias-free fp32 linear to E logits, softmax, then the top
  K probabilities (K = min(top_k, E); ties go to the lower expert, as
  ``jax.lax.top_k`` orders them), renormalised to sum 1 for K > 1, the raw
  probability for K = 1;
- each expert takes at most ``cap = min(ceil(K * T / E * capacity_factor),
  T)`` of the T = B * L tokens; the assignments queue k-major (every
  token's first choice ahead of any second choice), in token order within
  a choice, and those past ``cap`` drop. Pad tokens (``pad_mask``) take no
  place in a queue, and their output rows are zero;
- the experts are FFNs (linear1, ReLU, dropout, linear2) with their
  parameters stacked [E, ...]; a token's output is the sum over its kept
  choices of the gate times the expert's output, in the compute dtype;
- the Switch balance term ``E * sum_e f_e * P_e`` over the valid tokens
  (f_e: the share whose first choice is e; P_e: the mean router
  probability) is left in ``aux`` after each forward with gradients on,
  where the trainer collects it (``moe_aux``); with gradients off (serving,
  validation) ``aux`` is None, as JAX sows it only where the trainer asks.

JAX dispatches with one-hot [K*T, E, cap] tensors; the port indexes:
the kept assignments are copied into their [E, cap, C] slots and gathered
back from them, which gives the same values (each slot holds one token, and
each token's output one product a choice).

On a mesh (``parallel.mesh``) JAX routes over the global batch: inside
``split_rows`` T is the global token count, ``cap`` is taken from it, and
an assignment's queue place is its place in the global k-major order of
the global token index ``b * S + s`` (one all-reduce of each rank's
per-row [B, K, E] counts gives each row its offset: every token of the
rows on earlier dp coordinates, then, within its dp block, of its earlier
rows on every sp rank, then of its own row on earlier sp ranks); the
balance term's f, P and token count are global sums. Which group holds the
tokens depends on the layer: the encoder's FFN (and the S-query decoder's)
takes the sequence stream, cut over sp, so its tokens are per frame and
the group is the dp x sp ranks; ``futr``'s decoder takes ``n_query`` rows
that every sp rank holds whole (``seq=False``), so its group is the dp
ranks alone, else each token would count sp times. The experts shard over ep (each rank holds E/ep of them, its slots
of the global queues) and each expert's two linears over tp, as JAX's
rules say; tokens are replicated over ep and tp, so each rank adds its
experts' contributions and one sum over ep (and tp inside each expert)
combines them: no all-to-all.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from r3d_tpu_torch.models.layers import Dropout
from r3d_tpu_torch.parallel.mesh import group_size, rank_table, row_group, seq_axis, split_group
from r3d_tpu_torch.parallel.tensor import Axis, copy_to, reduce_from, sum_over


class Router(nn.Linear):
    """The bias-free router; its weight draws flax's default Dense init
    (lecun normal), not the transformer's xavier."""

    def __init__(self, dim: int, n_experts: int):
        super().__init__(dim, n_experts, bias=False)


class StackedLinear(nn.Module):
    """E linears side by side: ``weight`` [E, out, in], ``bias`` [E, out]
    (flax's ``nn.vmap`` of ``Dense``: kernel [E, in, out])."""

    def __init__(self, n: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))

    def forward(self, x, dtype: torch.dtype, tp: Optional[Axis] = None):
        """[E, N, in] -> [E, N, out], the product then the bias in ``dtype``;
        with ``tp`` the product's partial sums (row-parallel) are added over
        it first."""
        y = reduce_from(torch.bmm(x.to(dtype), self.weight.to(dtype).transpose(1, 2)), tp)
        return y + self.bias.to(dtype)[:, None, :]


class Experts(nn.Module):
    """E FFNs over their own [E, cap, C] slots; with an ep axis this rank's
    E/ep of them, with a tp axis each split column- then row-parallel."""

    def __init__(self, n: int, dim: int, hidden_dim: int, dropout: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.ep: Optional[Axis] = None
        self.tp: Optional[Axis] = None
        self.linear1 = StackedLinear(n, dim, hidden_dim)
        self.linear2 = StackedLinear(n, hidden_dim, dim)
        self.drop = Dropout(dropout)

    def set_axes(self, ep: Optional[Axis], tp: Optional[Axis]) -> None:
        self.ep, self.tp = ep, tp
        self.drop.cuts = tuple((d, a) for d, a in ((0, ep), (2, tp)) if a is not None)

    def forward(self, x):
        h = self.drop(torch.relu(self.linear1(copy_to(x, self.tp), self.dtype)))
        return self.linear2(h, self.dtype, self.tp)


class MoEFeedForward(nn.Module):
    """[B, L, C] -> [B, L, C], in place of ``FeedForward``."""

    def __init__(self, dim: int, hidden_dim: int, n_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_experts = n_experts
        self.top_k = min(top_k, n_experts)
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = Router(dim, n_experts)
        self.experts = Experts(n_experts, dim, hidden_dim, dropout, dtype)
        self.aux: Optional[torch.Tensor] = None

    def select(self, probs: torch.Tensor) -> torch.Tensor:
        """[T, E] router probabilities -> [T, K] experts: the K largest, ties
        to the lower expert (a stable descending sort)."""
        return torch.sort(probs, stable=True, dim=-1, descending=True).indices[:, :self.top_k]

    def forward(self, x, pad_mask: Optional[torch.Tensor] = None, seq: bool = True):
        """``seq``: ``x`` is the sequence stream (under sp the rank's
        frames), not rows every sp rank holds whole."""
        B, L, C = x.shape
        T = B * L
        E, K = self.n_experts, self.top_k
        sp = seq_axis() if seq else None
        group = split_group() if sp is not None else row_group()   # where the tokens lie
        W = group_size(group)
        cap = min(int(math.ceil(K * T * W / E * self.capacity_factor)), T * W)
        xt = x.reshape(T, C)
        valid = (torch.ones(T, device=x.device) if pad_mask is None
                 else (~pad_mask).reshape(T).float())

        probs = torch.softmax(torch.nn.functional.linear(xt.float(), self.router.weight), -1)
        gate_idx = self.select(probs)                              # [T, K]
        gate = probs.gather(-1, gate_idx)
        if K > 1:
            gate = gate / gate.sum(-1, keepdim=True)

        # k-major queue positions over the global batch, pad tokens out of
        # every queue: a token's place within its row's (choice, expert)
        # run, after every earlier choice and, within its choice, every
        # token of a lower global index b * S + s
        expert = gate_idx.t().reshape(K * T)
        onehot = (torch.nn.functional.one_hot(expert, E)
                  * valid.repeat(K).long()[:, None]).view(K, B, L, E)
        n_sp = 1 if sp is None else sp.size
        table = rank_table(onehot.sum(2).transpose(0, 1).double(), group).long()   # [W, B, K, E]
        table = table.view(W // n_sp, n_sp, B, K, E)   # [dp, sp, rows, K, E]
        r = 0 if W == 1 else torch.distributed.get_rank(group)
        d, p = divmod(r, n_sp)
        totals = table.sum((0, 1, 2))                             # [K, E]
        rows = table.sum(1)                                       # [dp, B, K, E]: whole rows
        before = (totals.cumsum(0) - totals + rows[:d].sum((0, 1))
                  + rows[d].cumsum(0) - rows[d] + table[d, :p].sum(0))   # [B, K, E]
        pos = ((torch.cumsum(onehot, 2) + before.transpose(0, 1)[:, :, None, :])
               * onehot).sum(-1).reshape(K * T) - 1
        keep = (pos >= 0) & (pos < cap)
        # each kept assignment to this rank's experts gets its slot in
        # [E_local * cap]; the others point at a zero row past the end
        ep = self.experts.ep
        n_local = E if ep is None else E // ep.size
        first = 0 if ep is None else ep.rank * n_local
        mine = keep & (expert >= first) & (expert < first + n_local)
        slot = torch.where(mine, (expert - first) * cap + pos,
                           torch.full_like(pos, n_local * cap))

        xr = copy_to(xt.to(self.dtype), ep).repeat(K, 1)
        expert_in = xr.new_zeros(n_local * cap + 1, C).index_copy(0, slot, xr)[:n_local * cap]
        expert_out = self.experts(expert_in.view(n_local, cap, C)).reshape(n_local * cap, C)
        expert_out = torch.cat([expert_out, expert_out.new_zeros(1, C)])
        g = copy_to(gate.t().reshape(K * T, 1).to(self.dtype), ep)
        y = reduce_from((expert_out.index_select(0, slot) * g).view(K, T, C).sum(0), ep)

        self.aux = None
        if torch.is_grad_enabled():
            n_valid = sum_over(valid.sum(), group).clamp_min(1.0)
            f = sum_over((torch.nn.functional.one_hot(gate_idx[:, 0], E).float()
                          * valid[:, None]).sum(0), group)
            P = sum_over((probs * valid[:, None]).sum(0), group)
            self.aux = E * ((f / n_valid) * (P / n_valid)).sum()
        return y.reshape(B, L, C).to(self.dtype)


def moe_aux(model: nn.Module) -> Optional[torch.Tensor]:
    """The sum of the balance terms the last forward left in ``model``'s
    MoE layers; None for a dense model."""
    terms = [m.aux for m in model.modules()
             if isinstance(m, MoEFeedForward) and m.aux is not None]
    return torch.stack(terms).sum() if terms else None

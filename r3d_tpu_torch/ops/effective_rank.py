"""Effective rank (Roy & Vetterli 2007): metric and differentiable loss.

Counterpart of ``r3d_tpu/ops/effective_rank.py``:

    erank(X) = exp(-sum_i p_i log p_i),   p_i = sigma_i / sum_j sigma_j

with sigma_i^2 the eigenvalues of the C x C Gram matrix X^T X (``eigh``, no
SVD). The backward is the eigenvalue-only identity
d f(lambda(G)) / dG = U diag(df/dlambda) U^T, well defined on repeated
eigenvalues, where autograd through ``eigh`` is not.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from r3d_tpu_torch.parallel.tensor import sum_over

_EPS = 1e-12


def _entropy_from_eigs(lam):
    """(erank, d erank / d lambda) from ascending Gram eigenvalues."""
    lam = lam.clamp_min(0.0)
    sigma = torch.sqrt(lam + _EPS)
    total = sigma.sum(-1, keepdim=True)
    p = sigma / total
    logp = torch.log(p + _EPS)
    erank = torch.exp(-(p * logp).sum(-1))
    dH_dp = -(logp + 1.0)
    dH_dsigma = (dH_dp - (dH_dp * p).sum(-1, keepdim=True)) / total
    return erank, erank[..., None] * dH_dsigma * (0.5 / sigma)


class _ERankFromGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gram):
        lam, U = torch.linalg.eigh(gram)
        erank, dlam = _entropy_from_eigs(lam)
        ctx.save_for_backward(U, dlam)
        return erank

    @staticmethod
    def backward(ctx, g):
        U, dlam = ctx.saved_tensors
        dG = (U * dlam[..., None, :]) @ U.transpose(-1, -2)
        return g[..., None, None] * dG


def effective_rank(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """x [..., N, C] (leading dims batched), mask [..., N] with 1 = valid
    row. Masked rows are zeroed, which leaves the Gram matrix exact.
    ``group``: the N rows are cut over it (a sequence over sp), and each
    Gram matrix is summed over it, with gradients, before the eigenvalues."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    if mask is not None:
        x = x * mask.to(x.dtype)[..., None]
    gram = sum_over(torch.einsum("...nc,...nd->...cd", x, x), group)
    return _ERankFromGram.apply(gram)


def effective_rank_loss(x, mask=None, target: Optional[float] = None,
                        group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """-erank (maximize rank), or (erank - target)^2; mean over the batch."""
    er = effective_rank(x, mask, group)
    return (-er if target is None else (er - target) ** 2).mean()

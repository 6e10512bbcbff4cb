"""Rank-enhancing Token Fuser, BN variant (``CMFuserBN``).

Counterpart of ``r3d_tpu/models/fuser.py:38-345``. Per-modality BatchNorm
(batch statistics in train mode, running statistics in eval mode or when
``frozen``), the bottom 10 % of channels by |gamma| alpha-blended across the
modalities, dropout, then the two-token SA-Fuser tail without outer
residual. The two-token self-attention with its -inf diagonal is exactly a
value swap, so the block's attention needs only the V third of ``qkv`` and
``proj``, prefolded into ``Wvp = W_proj @ W_v``. Without dropout the whole
fuser is one call of ``ops.fuser_kernel.fused_bn_blend_tail``; with it, the
blend and the dropout run in PyTorch and the tail is
``ops.fuser_kernel.fused_safuser_tail`` (``r3d_tpu/models/fuser.py:229-276``).
"""

from __future__ import annotations

import torch
from torch import nn

from r3d_tpu_torch.models.layers import Dropout
from r3d_tpu_torch.ops.fuser_kernel import (
    BlendParams,
    FuserTailParams,
    composed_bn_blend,
    fused_bn_blend_tail,
    fused_safuser_tail,
)

BN_MOMENTUM = 0.1  # torch BatchNorm1d's default (r3d_tpu/models/fuser.py:51)


class TorchBatchNorm(nn.Module):
    """BatchNorm1d over the channels of [B, T, C] with torch semantics:
    batch statistics over (B, T) with the biased variance normalize; the
    running statistics update in place by momentum 0.1 with the unbiased
    variance. Eval mode normalizes with the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def stats(self, x, train: bool):
        """(mean, var) to normalize with; in train mode the batch's (which
        carry gradients), updating the running statistics."""
        if not train:
            return self.running_mean, self.running_var
        x32 = x.float()
        mean = x32.mean(dim=(0, 1))
        var = ((x32 - mean) ** 2).mean(dim=(0, 1))
        n = x.shape[0] * x.shape[1]
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * (var * (n / max(n - 1, 1))))
        return mean, var

    def folded(self, mean, var):
        """(scale, shift) with normalized = x * scale + shift."""
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale

    def forward(self, x):
        mean, var = self.stats(x, self.training)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def bottomk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean [C] mask of the k smallest entries. Ties go to the lower
    index, as ``jax.lax.top_k`` orders them: a stable ascending sort, not
    ``torch.topk``, which promises no order."""
    mask = torch.zeros(scores.shape[-1], dtype=torch.bool, device=scores.device)
    if k > 0:
        # index_fill_ takes its value as a kernel argument; ``mask[idx] = True``
        # would copy it to the card and wait for the card
        mask.index_fill_(0, torch.argsort(scores, stable=True)[:k], True)
    return mask


class FuserBlock(nn.Module):
    """Parameters of the pre-norm timm Block of the SA-Fuser. Only the exact
    two-token form is ported, which reads them through ``_SAFuserCore``."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp1 = nn.Linear(dim, hidden)
        self.mlp2 = nn.Linear(hidden, dim)


class _SAFuserCore(nn.Module):
    """The BN-blend prologue, dropout, one FuserBlock, the output LayerNorm
    and the mean over the two modality tokens."""

    def __init__(self, dim: int, drop_rate: float = 0.1):
        super().__init__()
        self.block0 = FuserBlock(dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.drop = Dropout(drop_rate)

    def tail_params(self) -> FuserTailParams:
        b = self.block0
        C = self.norm.normalized_shape[0]
        return FuserTailParams(
            norm1_scale=b.norm1.weight, norm1_bias=b.norm1.bias,
            wvp=b.proj.weight @ b.qkv.weight[2 * C:], proj_bias=b.proj.bias,
            norm2_scale=b.norm2.weight, norm2_bias=b.norm2.bias,
            mlp1_weight=b.mlp1.weight, mlp1_bias=b.mlp1.bias,
            mlp2_weight=b.mlp2.weight, mlp2_bias=b.mlp2.bias,
            norm_out_scale=self.norm.weight, norm_out_bias=self.norm.bias,
        )

    def forward(self, rgb, depth, blend: BlendParams):
        """Raw [B, T, C] streams -> fused [B, T, C]."""
        B, T, C = rgb.shape
        r = rgb.reshape(B * T, C).contiguous()
        d = depth.reshape(B * T, C).contiguous()
        params = self.tail_params()
        no_dropout = not self.training or self.drop.rate == 0.0
        if no_dropout:
            fused = fused_bn_blend_tail(r, d, blend, params)
        else:
            ex_r, ex_d = composed_bn_blend(r, d, blend)
            fused = fused_safuser_tail(self.drop(ex_r).contiguous(),
                                       self.drop(ex_d).contiguous(), params)
        return fused.reshape(B, T, C)


class CMFuserBN(nn.Module):
    """BN variant: per-modality BatchNorm, bottom-k channels by |gamma|
    alpha-blended with the other modality, SA-Fuser tail. ``frozen``: torch
    module-eval BatchNorm while training (running statistics, no update)."""

    def __init__(self, dim: int, depth: int = 1, exchange_frac: float = 0.1,
                 drop_rate: float = 0.1, frozen: bool = False):
        super().__init__()
        if depth != 1:
            raise NotImplementedError("fuser_depth > 1 is not ported")
        self.exchange_frac = exchange_frac
        self.frozen = frozen
        self.bn_rgb = TorchBatchNorm(dim)
        self.bn_depth = TorchBatchNorm(dim)
        self.alpha = nn.Parameter(torch.rand(1, 1, dim))
        self.safuser = _SAFuserCore(dim, drop_rate)

    def forward(self, rgb, depth):
        C = rgb.shape[-1]
        k = max(0, int(C * self.exchange_frac))
        bn_train = self.training and not self.frozen
        scale_r, shift_r = self.bn_rgb.folded(*self.bn_rgb.stats(rgb, bn_train))
        scale_d, shift_d = self.bn_depth.folded(*self.bn_depth.stats(depth, bn_train))
        blend = BlendParams(
            scale_r=scale_r, shift_r=shift_r, scale_d=scale_d, shift_d=shift_d,
            mask_r=bottomk_mask(self.bn_rgb.weight.abs(), k).float(),
            mask_d=bottomk_mask(self.bn_depth.weight.abs(), k).float(),
            alpha=self.alpha.reshape(C),
        )
        return self.safuser(rgb, depth, blend)

"""Rank-enhancing Token Fuser, BN variant (``CMFuserBN``), inference only.

Counterpart of ``r3d_tpu/models/fuser.py:38-345``. Per-modality BatchNorm
(running statistics), the bottom 10 % of channels by |gamma| alpha-blended
across the modalities, then the two-token SA-Fuser tail without outer
residual. The two-token self-attention with its -inf diagonal is exactly a
value swap, so the block's attention needs only the V third of ``qkv`` and
``proj``, prefolded into ``Wvp = W_proj @ W_v``. The whole fuser runs as one
call of ``ops.fuser_kernel.fused_bn_blend_tail``.
"""

from __future__ import annotations

import torch
from torch import nn

from r3d_tpu_torch.ops.fuser_kernel import (
    BlendParams,
    FuserTailParams,
    fused_bn_blend_tail,
)


class TorchBatchNorm(nn.Module):
    """BatchNorm1d over the channels of [B, T, C], eval semantics: it
    normalizes with the running statistics and folds into an affine."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self):
        """(scale, shift) with normalized = x * scale + shift."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        scale, shift = self.folded()
        return x * scale + shift


def bottomk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean [C] mask of the k smallest entries. Ties go to the lower
    index, as ``jax.lax.top_k`` orders them: a stable ascending sort, not
    ``torch.topk``, which promises no order."""
    mask = torch.zeros(scores.shape[-1], dtype=torch.bool, device=scores.device)
    if k > 0:
        mask[torch.argsort(scores, stable=True)[:k]] = True
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
    """One FuserBlock, the output LayerNorm and the mean over the two
    modality tokens, with the BN-blend prologue, as one fused call."""

    def __init__(self, dim: int):
        super().__init__()
        self.block0 = FuserBlock(dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

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
        fused = fused_bn_blend_tail(rgb.reshape(B * T, C).contiguous(),
                                    depth.reshape(B * T, C).contiguous(),
                                    blend, self.tail_params())
        return fused.reshape(B, T, C)


class CMFuserBN(nn.Module):
    """BN variant: per-modality BatchNorm, bottom-k channels by |gamma|
    alpha-blended with the other modality, SA-Fuser tail."""

    def __init__(self, dim: int, depth: int = 1, exchange_frac: float = 0.1):
        super().__init__()
        if depth != 1:
            raise NotImplementedError("fuser_depth > 1 is not ported")
        self.exchange_frac = exchange_frac
        self.bn_rgb = TorchBatchNorm(dim)
        self.bn_depth = TorchBatchNorm(dim)
        self.alpha = nn.Parameter(torch.rand(1, 1, dim))
        self.safuser = _SAFuserCore(dim)

    def forward(self, rgb, depth):
        C = rgb.shape[-1]
        k = max(0, int(C * self.exchange_frac))
        scale_r, shift_r = self.bn_rgb.folded()
        scale_d, shift_d = self.bn_depth.folded()
        blend = BlendParams(
            scale_r=scale_r, shift_r=shift_r, scale_d=scale_d, shift_d=shift_d,
            mask_r=bottomk_mask(self.bn_rgb.weight.abs(), k).float(),
            mask_d=bottomk_mask(self.bn_depth.weight.abs(), k).float(),
            alpha=self.alpha.reshape(C),
        )
        return self.safuser(rgb, depth, blend)

"""Rank-enhancing Token Fuser variants.

Counterpart of ``r3d_tpu/models/fuser.py``. Each variant exchanges channels
between the two modality streams, then runs the SA-Fuser tail
(``_SAFuserCore``): dropout, ``depth`` pre-norm blocks over the two tokens,
an optional outer residual, the output LayerNorm and the mean over the two
tokens.

- ``CMFuserBN`` (``futr_fusion_bn``): per-modality BatchNorm (batch
  statistics in train mode, running statistics in eval mode or when
  ``frozen``), the bottom 10 % of channels by |gamma| alpha-blended across
  the modalities; no outer residual.
- ``CMFuserGrad`` (``futr_fusion_grad``): the bottom quarter of channels by
  a gradient probe in train mode (a constant, so the first quarter) or by
  mean |activation| in eval mode, hard-swapped; the outer residual.
- ``CMFuserVary`` (``futr_fusion_vary``): the bottom quarter by mean
  |activation| always, the exchanged channels ``alpha * other``.
- ``CMFuserNoExchange`` (``futr_fusion_nox`` and ``afft``): a learned
  modality token added to both streams, no exchange.

The two-token self-attention with its -inf diagonal is exactly a value
swap, so a block's attention needs only the V third of ``qkv`` and
``proj`` (JAX's ``two_token_exact``, the only form its fusers build). With
one block the tail is one kernel (``r3d_tpu/models/fuser.py:229-276``):
without dropout ``CMFuserBN``'s whole fuser is
``ops.fuser_kernel.fused_bn_blend_tail``; otherwise the exchange and the
dropout run in PyTorch and the tail is ``ops.fuser_kernel.fused_safuser_tail``
(K1's no-blend route, K2 its backward), with ``Wvp = W_proj @ W_v``
prefolded. With ``depth > 1`` the blocks run composed, as in JAX, which has
no kernel there.

The streams are fp32 or bf16 (``compute_dtype``); the parameters and the
BatchNorm statistics stay fp32. In bf16 the kernels and their plain versions
compute at the Pallas kernel's rounding points (``ops/fuser_kernel.py``),
and a composed block at flax's: LayerNorm in fp32 rounded to bf16, each
product of bf16 operands rounded once, its bias added in bf16.

Under sequence parallelism each rank fuses its own frames (K1 and K2 on
its ``B/dp * S/sp`` rows); the BatchNorm statistics, the BN unbiased
factor's n and the activation rankings reduce over the dp x sp group
(``parallel.mesh.split_rows``), and the dropout keeps the rank's frames of
the whole mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from r3d_tpu_torch.models.layers import Dropout
from r3d_tpu_torch.ops.fuser_kernel import (
    BlendParams,
    FuserTailParams,
    composed_bn_blend,
    fused_bn_blend_tail,
    fused_safuser_tail,
    linear_in_dtype,
)
from r3d_tpu_torch.parallel.mesh import global_mean, split_group

BN_MOMENTUM = 0.1  # torch BatchNorm1d's default (r3d_tpu/models/fuser.py:51)


class TorchBatchNorm(nn.Module):
    """BatchNorm1d over the channels of [B, T, C] with torch semantics:
    batch statistics over (B, T) with the biased variance normalize; the
    running statistics update in place by momentum 0.1 with the unbiased
    variance. Eval mode normalizes with the running statistics. The
    statistics are fp32 whatever the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def stats(self, x, train: bool):
        """(mean, var) to normalize with; in train mode the batch's (which
        carry gradients), updating the running statistics. Where the rows
        are split over a dp (x sp) group (``parallel.mesh.split_rows``) the
        batch is the global one: both statistics and the unbiased factor's n."""
        if not train:
            return self.running_mean, self.running_var
        x32 = x.float()
        mean = global_mean(x32, (0, 1))
        var = global_mean((x32 - mean) ** 2, (0, 1))
        n = x.shape[0] * x.shape[1]
        if split_group() is not None:
            n *= torch.distributed.get_world_size(split_group())
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
    """The pre-norm timm Block of the SA-Fuser over two tokens with the -inf
    diagonal, in its exact closed form (``r3d_tpu/models/fuser.py:163-171``):
    each token's attention output is the projected value of the other."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp1 = nn.Linear(dim, hidden)
        self.mlp2 = nn.Linear(hidden, dim)

    def forward(self, x):
        """[N, 2, C] -> [N, 2, C], in x's dtype."""
        C = x.shape[-1]
        v = linear_in_dtype(layer_norm(self.norm1, x), self.qkv.weight[2 * C:])
        x = x + linear_in_dtype(v.flip(1), self.proj.weight, self.proj.bias)
        m = linear_in_dtype(layer_norm(self.norm2, x), self.mlp1.weight, self.mlp1.bias)
        m = F.gelu(m.float(), approximate="none").to(x.dtype)
        return x + linear_in_dtype(m, self.mlp2.weight, self.mlp2.bias)


def layer_norm(norm: nn.LayerNorm, x):
    """``norm(x)`` in fp32, rounded to x's dtype (flax's fp32 LayerNorm
    statistics and affine)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class _SAFuserCore(nn.Module):
    """The optional BN-blend prologue, dropout, ``depth`` FuserBlocks, the
    optional outer residual around them, the output LayerNorm and the mean
    over the two modality tokens. One block takes the kernels; more run
    composed (JAX's ``kernel_ok``)."""

    def __init__(self, dim: int, depth: int = 1, outer_residual: bool = False,
                 drop_rate: float = 0.1):
        super().__init__()
        if depth < 1:
            raise ValueError(f"fuser depth {depth} < 1")
        self.depth = depth
        self.outer_residual = outer_residual
        for i in range(depth):
            setattr(self, f"block{i}", FuserBlock(dim))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        # applied to [B, T, C]: under sp, T is the rank's frames of the stream
        self.drop = Dropout(drop_rate, seq_dim=1)

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

    def forward(self, rgb, depth, blend: Optional[BlendParams] = None):
        """[B, T, C] streams -> fused [B, T, C]. With ``blend`` the streams
        are the raw ones and the BN-affine and alpha-blend come first."""
        B, T, C = rgb.shape
        r = rgb.reshape(B * T, C).contiguous()
        d = depth.reshape(B * T, C).contiguous()
        no_dropout = not self.training or self.drop.rate == 0.0
        if self.depth == 1 and blend is not None and no_dropout:
            fused = fused_bn_blend_tail(r, d, blend, self.tail_params(), self.outer_residual)
            return fused.reshape(B, T, C)
        if blend is not None:
            r, d = composed_bn_blend(r, d, blend)
        # the masks drawn as [B, T, C], the same numbers as [B * T, C]
        r = self.drop(r.view(B, T, C)).reshape(B * T, C)
        d = self.drop(d.view(B, T, C)).reshape(B * T, C)
        if self.depth == 1:
            fused = fused_safuser_tail(r.contiguous(), d.contiguous(), self.tail_params(),
                                       self.outer_residual)
            return fused.reshape(B, T, C)
        x = x_res = torch.stack([r, d], dim=1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        if self.outer_residual:
            x = x + x_res
        return layer_norm(self.norm, x).mean(dim=1).reshape(B, T, C)


def _activation_masks(rgb, depth, k: int):
    """Bottom-k masks of each stream's channels by mean |activation| over
    (B, T), pad rows included, as JAX ranks them; over the global batch
    where the rows are split over a dp group."""
    with torch.no_grad():
        return (bottomk_mask(global_mean(rgb.abs(), (0, 1)), k),
                bottomk_mask(global_mean(depth.abs(), (0, 1)), k))


class CMFuserBN(nn.Module):
    """BN variant: per-modality BatchNorm, bottom-k channels by |gamma|
    alpha-blended with the other modality, SA-Fuser tail. ``frozen``: torch
    module-eval BatchNorm while training (running statistics, no update)."""

    def __init__(self, dim: int, depth: int = 1, exchange_frac: float = 0.1,
                 drop_rate: float = 0.1, frozen: bool = False):
        super().__init__()
        self.exchange_frac = exchange_frac
        self.frozen = frozen
        self.bn_rgb = TorchBatchNorm(dim)
        self.bn_depth = TorchBatchNorm(dim)
        self.alpha = nn.Parameter(torch.rand(1, 1, dim))
        self.safuser = _SAFuserCore(dim, depth, drop_rate=drop_rate)

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


class CMFuserGrad(nn.Module):
    """Gradient-probe variant: the bottom quarter of each stream's channels
    hard-swapped with the other stream's, SA-Fuser tail with the outer
    residual. The ranking: in a training forward JAX ranks by
    |d(mean(rgb) + mean(depth)) / d stream| averaged over (B, T), which is
    1/numel for every channel, so its bottom-k takes the first quarter
    (COMPAT #2, #10); in eval mode by mean |activation|.

    ``sticky``: the sticky-eval training epochs run the module-eval forward
    (``model.eval()``) but rank as JAX's frozen twin does, which it applies
    with ``train=True``: by the probe. The trainer sets it after
    ``model.train(False)``; every ``train()`` / ``eval()`` clears it."""

    def __init__(self, dim: int, depth: int = 1, drop_rate: float = 0.1):
        super().__init__()
        self.sticky = False
        self.safuser = _SAFuserCore(dim, depth, outer_residual=True, drop_rate=drop_rate)

    def train(self, mode: bool = True):
        self.sticky = False
        return super().train(mode)

    def masks(self, rgb, depth):
        """(mask_rgb, mask_depth), [C] bool: the channels that swap."""
        C = rgb.shape[-1]
        k = C // 4
        if self.training or self.sticky:
            # the probe's scores are all equal; the first k, with no sum whose
            # rounding could reorder the ties
            first = torch.arange(C, device=rgb.device) < k
            return first, first
        return _activation_masks(rgb, depth, k)

    def forward(self, rgb, depth):
        mask_r, mask_d = self.masks(rgb, depth)
        return self.safuser(torch.where(mask_r, depth, rgb), torch.where(mask_d, rgb, depth))


class CMFuserVary(nn.Module):
    """Vary ablation: the bottom quarter of each stream's channels by mean
    |activation| (in every mode) become ``alpha * other``, alpha initialised
    to ones; SA-Fuser tail without the outer residual."""

    def __init__(self, dim: int, depth: int = 1, drop_rate: float = 0.1):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, 1, dim))
        self.safuser = _SAFuserCore(dim, depth, drop_rate=drop_rate)

    def masks(self, rgb, depth):
        return _activation_masks(rgb, depth, rgb.shape[-1] // 4)

    def forward(self, rgb, depth):
        mask_r, mask_d = self.masks(rgb, depth)
        a = self.alpha.to(rgb.dtype)
        return self.safuser(torch.where(mask_r, a * depth, rgb),
                            torch.where(mask_d, a * rgb, depth))


class CMFuserNoExchange(nn.Module):
    """AFFT-style fusion without exchange (``futr_fusion_nox``, ``afft``): a
    learned modality token, N(0, 1) at init, added to both streams, then the
    SA-Fuser tail without the outer residual."""

    def __init__(self, dim: int, depth: int = 1, drop_rate: float = 0.1):
        super().__init__()
        self.modality_token = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.safuser = _SAFuserCore(dim, depth, drop_rate=drop_rate)

    def forward(self, rgb, depth):
        tok = self.modality_token.reshape(-1).to(rgb.dtype)
        return self.safuser(rgb + tok, depth + tok)


def mark_sticky(model: nn.Module) -> None:
    """Let every ``CMFuserGrad`` of ``model`` (already in eval mode) rank by
    the probe, as JAX's frozen twin does in the sticky epochs."""
    for m in model.modules():
        if isinstance(m, CMFuserGrad):
            m.sticky = True

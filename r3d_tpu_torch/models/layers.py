"""Transformer layers with DETR post-norm semantics, batch-major [B, L, C].

Counterpart of ``r3d_tpu/models/layers.py``: multi-head attention with the
positional embedding already added to q, k and v by the caller (the
reference passes ``with_pos_embed(...)`` as the value too), key-padding
masks as an additive ``finfo(float32).min`` bias, fp32 softmax, post-norm
residual blocks, and dropout that follows ``self.training``.

Randomness: dropout masks draw from ``generator`` (a ``torch.Generator`` on
the module's device) and the attention kernel's per-call seed from
``seed_generator`` (one on the CPU, so drawing it never waits for the card);
the trainer sets both with ``set_generators``. None means torch's default
generators.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from r3d_tpu_torch.ops.attention import (
    attention_kernel_eligible,
    composed_attention,
    flash_attention,
    flash_attention_dropout,
)

INT32_MAX = 2 ** 31 - 1


def attention_bias_from_padding(key_padding_mask: Optional[torch.Tensor],
                                dtype: torch.dtype = torch.float32
                                ) -> Optional[torch.Tensor]:
    """[B, S] bool (True = pad) -> additive bias [B, 1, 1, S]."""
    if key_padding_mask is None:
        return None
    bias = torch.zeros(key_padding_mask.shape, dtype=dtype,
                       device=key_padding_mask.device)
    bias.masked_fill_(key_padding_mask, torch.finfo(torch.float32).min)
    return bias[:, None, None, :]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1/(1 - rate)."""
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Dropout in train mode at ``rate`` > 0, identity otherwise."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return dropout(x, self.rate, self.generator)


def set_generators(model: nn.Module, generator: Optional[torch.Generator],
                   seed_generator: Optional[torch.Generator]) -> None:
    """Point every dropout of ``model`` at ``generator`` and every attention
    kernel's seed draw at ``seed_generator``."""
    for m in model.modules():
        if isinstance(m, (Dropout, MultiheadAttention)):
            m.generator = generator
        if isinstance(m, MultiheadAttention):
            m.seed_generator = seed_generator


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` math with separate q/k/v/out
    projections and attention-weight dropout. Routes, as
    ``r3d_tpu/models/layers.py:135-180`` does:

    - ``attention_kernel_eligible`` and no dropout: ``flash_attention`` (K3
      forward, K5 backward);
    - ``attention_kernel_eligible`` and dropout: ``flash_attention_dropout``
      (K4 forward, K5 backward) with a fresh int32 seed per call;
    - otherwise plain attention, with dropout on the weights in train mode.
    """

    def __init__(self, dim: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None
        self.seed_generator: Optional[torch.Generator] = None
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, key_padding_mask=None):
        B, Lq, C = q.shape
        Lk = k.shape[1]
        H = self.n_head
        D = C // H
        scale = 1.0 / math.sqrt(D)
        heads = lambda x, L: x.view(B, L, H, D).transpose(1, 2).contiguous()
        qh = heads(self.q_proj(q), Lq)
        kh = heads(self.k_proj(k), Lk)
        vh = heads(self.v_proj(v), Lk)
        bias = attention_bias_from_padding(key_padding_mask)
        rate = self.dropout if self.training else 0.0
        if rate == 0.0 and attention_kernel_eligible(Lq, Lk, D, q.device):
            out = flash_attention(qh, kh, vh, bias, scale)
        elif attention_kernel_eligible(Lq, Lk, D, q.device):
            seed = int(torch.randint(0, INT32_MAX, (), generator=self.seed_generator))
            out = flash_attention_dropout(qh, kh, vh, bias, seed, scale, rate)
        elif rate == 0.0:
            out = composed_attention(qh, kh, vh, bias, scale)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
            if bias is not None:
                scores = scores + bias
            w = dropout(torch.softmax(scores.float(), dim=-1).to(q.dtype), rate,
                        self.generator)
            out = torch.einsum("bhqk,bhkd->bhqd", w, vh)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class FeedForward(nn.Module):
    """linear1 -> ReLU -> dropout -> linear2."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.linear2(self.drop(torch.relu(self.linear1(x))))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention, cross-attention into
    (memory + pos) keys and values, FFN, each added back through dropout."""

    def __init__(self, dim: int, n_head: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, n_head, dropout)
        self.cross_attn = MultiheadAttention(dim, n_head, dropout)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FeedForward(dim, ffn_dim, dropout)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.drop3 = Dropout(dropout)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.drop1(self.self_attn(q, q, q)))
        mem = memory if pos is None else memory + pos
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.drop2(self.cross_attn(q, mem, mem, memory_key_padding_mask)))
        return self.norm3(tgt + self.drop3(self.ffn(tgt)))

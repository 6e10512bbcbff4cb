"""Transformer layers with DETR post-norm semantics, batch-major [B, L, C].

Counterpart of ``r3d_tpu/models/layers.py``: multi-head attention with the
positional embedding already added to q, k and v by the caller (the
reference passes ``with_pos_embed(...)`` as the value too), key-padding
masks as an additive ``finfo(float32).min`` bias, fp32 softmax, post-norm
residual blocks. Inference only: no dropout.
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
)


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


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` math with separate q/k/v/out
    projections. Routes to the attention kernel where
    ``attention_kernel_eligible`` says so, else to plain attention."""

    def __init__(self, dim: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, key_padding_mask=None):
        B, Lq, C = q.shape
        Lk = k.shape[1]
        H = self.n_head
        D = C // H
        heads = lambda x, L: x.view(B, L, H, D).transpose(1, 2).contiguous()
        qh = heads(self.q_proj(q), Lq)
        kh = heads(self.k_proj(k), Lk)
        vh = heads(self.v_proj(v), Lk)
        bias = attention_bias_from_padding(key_padding_mask)
        attend = (flash_attention if attention_kernel_eligible(Lq, Lk, D, q.device)
                  else composed_attention)
        out = attend(qh, kh, vh, bias, 1.0 / math.sqrt(D))
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class FeedForward(nn.Module):
    """linear1 -> ReLU -> linear2."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        return self.linear2(torch.relu(self.linear1(x)))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention, cross-attention into
    (memory + pos) keys and values, FFN."""

    def __init__(self, dim: int, n_head: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, n_head)
        self.cross_attn = MultiheadAttention(dim, n_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FeedForward(dim, ffn_dim)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, q))
        mem = memory if pos is None else memory + pos
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.cross_attn(q, mem, mem, memory_key_padding_mask))
        return self.norm3(tgt + self.ffn(tgt))

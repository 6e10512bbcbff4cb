"""Transformer layers with DETR post-norm semantics, batch-major [B, L, C].

Counterpart of ``r3d_tpu/models/layers.py``: multi-head attention with the
positional embedding already added to q, k and v by the caller (the
reference passes ``with_pos_embed(...)`` as the value too), key-padding
masks as an additive ``finfo(float32).min`` bias, fp32 softmax, post-norm
residual blocks, and dropout that follows ``self.training``.

``dtype`` is the compute dtype, as flax's ``dtype=``: parameters stay fp32,
each linear layer casts its input, weight and bias to it (``linear_in``),
and LayerNorm keeps its statistics in fp32 and gives ``dtype`` out. In bf16
the composed attention rounds its scores to bf16, where the key-padding
bias becomes -inf: a masked key weighs exactly 0 there.

Randomness: dropout masks draw from ``generator`` (a ``torch.Generator`` on
the module's device) and the attention kernel's per-call seed from
``seed_generator`` (one on the CPU, so drawing it never waits for the card);
the trainer sets both with ``set_generators``. None means torch's default
generators.

Tensor parallelism (``parallel.mesh.place_model``, JAX's TP rules): a
``MultiheadAttention`` or ``FeedForward`` given a tp axis (``set_axes``)
holds its rank's slice, Megatron's: q/k/v column-parallel (the rank's
H/tp heads, whose attention runs on them alone), ``out_proj`` and
``linear2`` row-parallel, their partial sums added over tp and their
biases added once after. A mask the port draws itself is drawn whole from
the generator every tp rank shares and cut to the rank's slice
(``Dropout.cuts``), so a tp step draws one process's masks; the
attention kernels' seeds fold in the tp coordinate, as JAX's
``flash_attention_dropout_sharded`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r3d_tpu_torch.ops.attention import (
    attention_kernel_eligible,
    flash_attention,
    flash_attention_dropout,
    many_query_body,
)
from r3d_tpu_torch.ops.cross_attention import (
    cross_attention_native,
    cross_attention_native_eligible,
)
from r3d_tpu_torch.ops.ring_attention import ring_attention, ring_attention_eligible
from r3d_tpu_torch.parallel.mesh import seq_axis
from r3d_tpu_torch.parallel.tensor import Axis, copy_to, cut_seq, gather_seq, reduce_from

INT32_MAX = 2 ** 31 - 1
TP_SEED_STRIDE = 7919   # r3d_tpu/ops/attention.py:435: a tp shard's seed offset
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def linear_in(x, layer: nn.Linear, dtype: torch.dtype):
    """``layer(x)`` with input, weight and bias cast to ``dtype`` (flax
    ``Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def row_parallel(x, layer: nn.Linear, dtype: torch.dtype, tp: Optional[Axis]):
    """``linear_in(x, layer, dtype)`` of a row-parallel layer: with ``tp``
    the rank's partial product summed over it, then the bias, once."""
    if tp is None:
        return linear_in(x, layer, dtype)
    return reduce_from(F.linear(x.to(dtype), layer.weight.to(dtype)), tp) + layer.bias.to(dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and affine in fp32, the
    output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


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


Cuts = Tuple[Tuple[int, Axis], ...]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            cuts: Cuts = ()):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1/(1 - rate). ``x`` is a rank's slice along each (dim, axis)
    of ``cuts``: the whole mask is drawn and cut to it."""
    shape = list(x.shape)
    for d, a in cuts:
        shape[d] *= a.size
    u = torch.rand(shape, device=x.device, generator=generator)
    for d, a in cuts:
        u = u[(slice(None),) * (d % x.dim()) + (a.part(u.shape[d]),)]
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Dropout in train mode at ``rate`` > 0, identity otherwise; ``cuts``
    where its input is a rank's slice (``dropout``). ``seq_dim``: the axis
    of its input that is the sequence, cut over sp where ``seq_axis()`` is
    set (None: its input never is); a caller whose input is on the sequence
    stream only at times says which with ``seq``."""

    def __init__(self, rate: float, seq_dim: Optional[int] = None):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.cuts: Cuts = ()
        self.seq_dim = seq_dim

    def forward(self, x, seq: bool = True):
        if not self.training or self.rate == 0.0:
            return x
        sp = seq_axis() if seq and self.seq_dim is not None else None
        cuts = self.cuts if sp is None else self.cuts + ((self.seq_dim, sp),)
        return dropout(x, self.rate, self.generator, cuts)


class FixedDropout(Dropout):
    """A dropout whose rate is written into the model, not taken from the
    config (the self-attention and depth sources' 0.1, the TCN's 0.2). JAX's
    frozen twin of the sticky epochs zeroes only the configured rates and
    runs at ``train=True``, so these stay on there (ROADMAP C4):
    ``train.loop.frozen_twin`` puts them back in train mode after
    ``model.eval()``."""


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
    ``r3d_tpu/models/layers.py:87-180`` does:

    - ``cross_attention_native_eligible`` (opt-in, few queries against long
      keys): ``cross_attention_native`` on the projections' own layout (K6
      forward, K7 backward), with a fresh int32 seed per call when dropping;
    - ``attention_kernel_eligible`` and no dropout: ``flash_attention`` (K3
      forward, K5 backward);
    - ``attention_kernel_eligible`` and dropout: ``flash_attention_dropout``
      (K4 forward, K5 backward) with a fresh int32 seed per call;
    - otherwise plain attention in the compute dtype, with dropout on the
      weights in train mode.

    With a tp axis every route runs on the rank's H/tp heads (K6/K7 on its
    C/tp channels, each head's channels together). With ``seq`` and
    ``seq_axis()`` set, the routes are chosen on the whole lengths, JAX's
    order (``r3d_tpu/models/layers.py:87-133``):

    - ``seq=True`` (q, k and v on the sequence stream): the ring without
      dropout where ``ring_attention_eligible``, else the whole call on the
      inputs gathered over sp, the rank's rows kept;
    - ``seq="q"`` (the rank's queries against whole keys: the S-query
      decoder's cross-attention into the gathered memory): without dropout
      the rank's query rows alone, where their route (kernel body
      included) is the whole call's, so each row is computed as one
      process computes it; else (the kernels' dropout hashes the query's
      index) the whole call on the gathered queries, the rank's rows kept.
    """

    def __init__(self, dim: int, n_head: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.dtype = dtype
        self.generator: Optional[torch.Generator] = None
        self.seed_generator: Optional[torch.Generator] = None
        self.tp: Optional[Axis] = None
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def set_axes(self, tp: Optional[Axis]) -> None:
        self.tp = tp

    def _seed(self) -> int:
        seed = int(torch.randint(0, INT32_MAX, (), generator=self.seed_generator))
        if self.tp is not None:
            seed = (seed + TP_SEED_STRIDE * self.tp.rank) % INT32_MAX
        return seed

    def _route(self, Lq: int, Lk: int, Cl: int, H: int, rate: float, device) -> tuple:
        """The route a call of ``Lq`` queries against ``Lk`` keys takes: the
        native cross-attention, an attention kernel and its body (many
        queries or few), or plain."""
        if cross_attention_native_eligible(Lq, Lk, Cl, H, rate, device):
            return ("native",)
        if attention_kernel_eligible(Lq, Lk, Cl // H, device):
            return ("kernel", many_query_body(self.dtype, Lq))
        return ("plain",)

    def forward(self, q, k, v, key_padding_mask=None, seq=False):
        B, Lq, C = q.shape
        Lk = k.shape[1]
        tp = self.tp
        rate = self.dropout if self.training else 0.0
        sp = seq_axis() if seq else None
        D = C // self.n_head
        H = self.n_head // (1 if tp is None else tp.size)   # this rank's heads
        Cl = H * D
        ring = (sp is not None and seq is True and rate == 0.0
                and ring_attention_eligible(Lq * sp.size, Lk * sp.size, sp.size))
        rows = (sp is not None and seq == "q" and rate == 0.0
                and self._route(Lq, Lk, Cl, H, rate, q.device)
                == self._route(Lq * sp.size, Lk, Cl, H, rate, q.device))
        if sp is not None and not (ring or rows):
            # the one-process call on the gathered sequence, this rank's rows kept
            gq = gather_seq(q, sp)
            if seq == "q":
                gk, gv, mask = k, v, key_padding_mask
            else:
                gk = gq if k is q else gather_seq(k, sp)
                gv = gk if v is k else gather_seq(v, sp)
                mask = None if key_padding_mask is None else gather_seq(key_padding_mask, sp)
            return cut_seq(self.forward(gq, gk, gv, mask), sp)
        scale = 1.0 / math.sqrt(D)
        if tp is not None:
            qi = copy_to(q, tp)
            ki = qi if k is q else copy_to(k, tp)
            q, k, v = qi, ki, ki if v is k else copy_to(v, tp)
        qf = linear_in(q, self.q_proj, self.dtype)
        kf = linear_in(k, self.k_proj, self.dtype)
        vf = linear_in(v, self.v_proj, self.dtype)
        bias = attention_bias_from_padding(key_padding_mask)
        if cross_attention_native_eligible(Lq, Lk, Cl, H, rate, q.device) and not ring:
            seed = self._seed() if rate > 0.0 else 0
            out = cross_attention_native(qf, kf, vf, bias, seed, scale, rate, H)
            return row_parallel(out, self.out_proj, self.dtype, tp)
        heads = lambda x, L: x.view(B, L, H, D).transpose(1, 2).contiguous()
        qh, kh, vh = heads(qf, Lq), heads(kf, Lk), heads(vf, Lk)
        if ring:
            out = ring_attention(qh, kh, vh, bias, scale, sp)
        elif rate == 0.0 and attention_kernel_eligible(Lq, Lk, D, q.device):
            out = flash_attention(qh, kh, vh, bias, scale)
        elif attention_kernel_eligible(Lq, Lk, D, q.device):
            out = flash_attention_dropout(qh, kh, vh, bias, self._seed(), scale, rate)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(D)
            if bias is not None:
                scores = scores + bias.to(scores.dtype)
            w = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            if rate > 0.0:
                w = dropout(w, rate, self.generator, () if tp is None else ((1, tp),))
            out = torch.einsum("bhqk,bhkd->bhqd", w, vh)
        return row_parallel(out.transpose(1, 2).reshape(B, Lq, Cl), self.out_proj, self.dtype, tp)


class FeedForward(nn.Module):
    """linear1 -> ReLU -> dropout -> linear2. ``pad_mask`` is for the MoE
    layer's signature; a token-wise FFN needs none. With a tp axis linear1
    is column-parallel and linear2 row-parallel, its bias added once."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tp: Optional[Axis] = None
        self.linear1 = nn.Linear(dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, dim)
        self.drop = Dropout(dropout)

    def set_axes(self, tp: Optional[Axis]) -> None:
        self.tp = tp
        self.drop.cuts = () if tp is None else ((-1, tp),)

    def forward(self, x, pad_mask=None, seq: bool = True):
        h = self.drop(torch.relu(linear_in(copy_to(x, self.tp), self.linear1, self.dtype)), seq)
        return row_parallel(h, self.linear2, self.dtype, self.tp)


def feed_forward(dim: int, hidden_dim: int, dropout: float, dtype: torch.dtype,
                 moe: Optional[tuple] = None) -> nn.Module:
    """The layer's FFN: dense, or with ``moe`` = (experts, top_k,
    capacity_factor) and experts > 0 ``MoEFeedForward``
    (``r3d_tpu/models/layers.py:201-213``)."""
    if moe is not None and moe[0] > 0:
        from r3d_tpu_torch.models.moe import MoEFeedForward

        return MoEFeedForward(dim, hidden_dim, *moe, dropout=dropout, dtype=dtype)
    return FeedForward(dim, hidden_dim, dropout, dtype)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer (``r3d_tpu/models/layers.py:223-253``):
    self-attention with ``src + pos`` as queries, keys and values under the
    key-padding mask, then the FFN (MoE under the same mask with ``moe``),
    each added back through dropout. At S of 256 or more the
    self-attention takes the attention kernels (S queries against S
    keys). Its input is the sequence stream: under sp, the rank's frames."""

    def __init__(self, dim: int, n_head: int, ffn_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, moe: Optional[tuple] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, n_head, dropout, dtype)
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.ffn = feed_forward(dim, ffn_dim, dropout, dtype, moe)
        self.drop1 = Dropout(dropout, seq_dim=1)
        self.drop2 = Dropout(dropout, seq_dim=1)
        if isinstance(self.ffn, FeedForward):
            self.ffn.drop.seq_dim = 1

    def forward(self, src, pos, key_padding_mask=None):
        qkv = src if pos is None else src + pos
        src = self.norm1(src + self.drop1(self.self_attn(qkv, qkv, qkv, key_padding_mask,
                                                         seq=True)))
        return self.norm2(src + self.drop2(self.ffn(src, key_padding_mask)))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention, cross-attention into
    (memory + pos) keys and values, FFN, each added back through dropout.
    ``tgt_key_padding_mask`` masks padded query rows out of the
    self-attention (the S-query models, whose queries pad with the
    stream) and, with ``moe``, out of the MoE FFN's queues. ``seq``: the
    queries are the sequence stream (the S-query models; under sp the
    rank's frames): the self-attention takes ``seq=True``'s routes, the
    cross-attention into the gathered memory ``seq="q"``'s, and the
    dropouts, the FFN and MoE's queues take the rank's frames."""

    def __init__(self, dim: int, n_head: int, ffn_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, moe: Optional[tuple] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, n_head, dropout, dtype)
        self.cross_attn = MultiheadAttention(dim, n_head, dropout, dtype)
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.norm3 = LayerNorm(dim, dtype)
        self.ffn = feed_forward(dim, ffn_dim, dropout, dtype, moe)
        self.drop1 = Dropout(dropout, seq_dim=1)
        self.drop2 = Dropout(dropout, seq_dim=1)
        self.drop3 = Dropout(dropout, seq_dim=1)
        if isinstance(self.ffn, FeedForward):
            self.ffn.drop.seq_dim = 1

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                tgt_key_padding_mask=None, seq: bool = False):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.drop1(self.self_attn(q, q, q, tgt_key_padding_mask, seq=seq),
                                          seq))
        mem = memory if pos is None else memory + pos
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.drop2(self.cross_attn(q, mem, mem, memory_key_padding_mask,
                                                          seq="q" if seq else False), seq))
        return self.norm3(tgt + self.drop3(self.ffn(tgt, tgt_key_padding_mask, seq=seq), seq))


def sinusoidal_positional_encoding(seq_len: int, dim: int) -> torch.Tensor:
    """The sin/cos table [seq_len, dim] in fp32 (``r3d_tpu/models/layers.py:312``)."""
    position = torch.arange(seq_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                         * -(math.log(10000.0) / dim))
    pe = torch.zeros(seq_len, dim)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """``F.adaptive_avg_pool1d`` over the middle axis of [B, T, C]: bin i
    averages rows [floor(i*T/out), ceil((i+1)*T/out)), as one product with a
    pooling matrix whose weights are in ``x.dtype`` (in bf16, 1/len rounded
    as JAX rounds it)."""
    T = x.shape[1]
    i = torch.arange(out_len, device=x.device)
    starts = (i * T) // out_len
    ends = -((-(i + 1) * T) // out_len)
    t = torch.arange(T, device=x.device)
    sel = (t[None, :] >= starts[:, None]) & (t[None, :] < ends[:, None])
    w = sel.to(x.dtype) / (ends - starts).clamp_min(1)[:, None].to(x.dtype)
    return torch.einsum("ot,btc->boc", w, x)


def masked_adaptive_avg_pool1d(x: torch.Tensor, out_len: int,
                               lengths: torch.Tensor) -> torch.Tensor:
    """``adaptive_avg_pool1d`` over only the first ``lengths[b]`` rows of
    each example: the bins follow each row's true length, as the pool of
    the unpadded sequence (``r3d_tpu/models/layers.py:339``)."""
    S = x.shape[1]
    q = torch.arange(out_len, device=x.device)[None, :]
    L = lengths.to(torch.int64)[:, None]
    starts = (q * L) // out_len
    ends = -((-(q + 1) * L) // out_len)
    s = torch.arange(S, device=x.device)[None, None, :]
    sel = (s >= starts[..., None]) & (s < ends[..., None])
    w = sel.to(x.dtype)
    w = w / w.sum(-1, keepdim=True).clamp_min(1)
    return torch.einsum("bns,bsc->bnc", w, x)

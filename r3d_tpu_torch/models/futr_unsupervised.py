"""The query-conditioned FUTR family: ``futr_proposed``, ``futr_unsupervised``
(with its ``temp2`` and ``temp3`` variants) and ``futr_gaze``.

Counterpart of ``FUTRUnsupervised`` and ``GazeCNN`` in
``r3d_tpu/models/futr_unsupervised.py``. Every source embeds the features
with ``InputEmbed``, adds the learned ``pos_embedding`` to the decoder's keys
and values, runs the decoder (encoder bypassed) and reads ``Heads`` off its
rows and the embedded stream. The sources differ in their queries:

- ``query_source="gt"`` (``futr_proposed``, the reference's
  ``model/futr_proposed.py``): ``query_embed`` (an ``nn.Embedding`` of
  ``query_num`` rows) of the query ids plus the sinusoidal encoding, looked
  up in fp32 and cast; the decoder runs all S queries against the S keys
  with the pad mask on both sides, and only its output pools down to
  ``n_query`` rows, each row's bins following its true length when a mask
  is given (``masked_adaptive_avg_pool1d``), else over every row;
- ``query_source="self_attention"`` (``futr_unsupervised``,
  ``model/futr_unsupervised.py:124-137``): the source gets the sinusoidal
  encoding and a hard-coded ``Dropout(0.1)``, which ``cfg.dropout`` does not
  reach; ``l3_attention`` runs on the (S, B, C) stream, so it attends ACROSS
  THE BATCH at each step (COMPAT #17: the reference's ``batch_first=True``
  fed (T, B, C) tensors; on a dp group its keys are the global batch's
  rows, ``parallel.mesh.gather_rows``); the queries are its output plus
  the encoding,
  pooled to ``n_query`` rows (``adaptive_avg_pool1d``, COMPAT #18) before
  the decoder. Variants: ``temp2`` adds the L3 stream into the source, runs
  the decoder on a learned ``query_embed`` parameter of ``n_query`` rows
  and reads the seg head off the source before the add; ``temp3`` is the
  default without ``supcon``;
- ``query_source="gaze"`` (``futr_gaze``,
  ``model/futr_unsupervised_multimodal.py``): the normalised gaze is
  truncated (``query.long()``), ``GazeCNN`` turns it into 8 identical rows,
  the L2-normalised encoding of the first 8 positions is added, and the
  decoder output over those 8 queries pools to ``n_query``; no ``l3``;
- ``query_source="depth"`` (``futr_unsupervised_depth``,
  ``model/futr_unsupervised_depth.py``): the source gets the encoding and
  the hard-coded dropout as the self-attention source does; the queries are
  ``DepthEmbed`` of the query input (projection, LayerNorm, ReLU) plus the
  encoding, then a hard-coded ``Dropout(0.1)`` of their own; the decoder
  and the pool are gt's. The module takes raw depth [B, S, H, W], as JAX's
  does (``depth_dim = H * W``), but the trainer, the cached route and the
  sweep feed it what JAX's trainer feeds (``r3d_tpu/train/loop.py:136-149``):
  the [B, S] L3 ids of ``query_label``, so ``build_model`` sizes its
  projection 1 wide, as JAX's init through that route does.

The hard-coded dropouts (``SRC_DROPOUT``, ``DEPTH_QUERY_DROPOUT``) are
``FixedDropout``: on in the sticky epochs, as in JAX's frozen twin (ROADMAP
C4).

Sequence parallelism (``parallel.mesh.seq_axis()`` set; the features,
``query`` ids and, where as long as the bucket, the gaze stream are the
rank's S/sp frames): the encoding and ``pos_embedding`` take the rank's
positions, the hard-coded dropouts draw the whole mask and keep the rank's
frames, and ``l3``, ``supcon`` and the seg head stay the rank's frames.
What mixes frames is gathered over sp first and then runs whole,
replicated on the sp ranks:

- gt and depth: the decoder runs the rank's S/sp queries
  (``FUTRTransformer(seq_queries=True)``), and its output ``hs`` is
  gathered before the pool to ``n_query`` rows, whose lengths come from
  the gathered mask;
- self-attention: ``l3_attention``'s keys are the dp group's rows at the
  rank's own frames (``gather_rows`` over the per-row group), and its
  stream is gathered before the pool to ``n_query`` rows (``temp2``'s
  add stays per frame);
- gaze: ``GazeCNN`` convolves and averages over the gaze rows, so it runs
  on the stream gathered over sp where the batch cut it (its length the
  features'), ``query_len`` whole.

Outputs: ``action``, ``duration``, ``seg`` as ``Heads`` gives them; ``l3``
[B, S, query_num] (``fc_l3`` of the query stream, fp32) but for gaze;
``supcon`` (the query stream, in the compute dtype) but for ``temp2`` and
``temp3``. JAX's ``attend_over_batch=False`` (per-sequence L3 attention) is
selected by no model and is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.futr import Heads, InputEmbed, compute_dtype, moe_spec, positions
from r3d_tpu_torch.models.futr_fusion import DepthEmbed
from r3d_tpu_torch.models.layers import (
    FixedDropout,
    MultiheadAttention,
    adaptive_avg_pool1d,
    linear_in,
    masked_adaptive_avg_pool1d,
    sinusoidal_positional_encoding,
)
from r3d_tpu_torch.models.transformer import FUTRTransformer
from r3d_tpu_torch.parallel.mesh import axis_size, gather_rows, seq_axis
from r3d_tpu_torch.parallel.tensor import gather_seq, seq_positions

SOURCES = ("gt", "self_attention", "gaze", "depth")
GAZE_STEPS = 8   # GazeCNN's output rows: its constructor default, never overridden
SRC_DROPOUT = 0.1   # the hard-coded dropout on the self-attention and depth sources
DEPTH_QUERY_DROPOUT = 0.1   # the hard-coded dropout on the depth queries


def check_gaze_cut(config, mesh) -> None:
    """Raise ``ValueError`` where a gaze stream uncut by sp would read as
    cut: the model takes a stream of the rank's S/sp frames for a cut one,
    which an explicit ``gaze_pad_len`` of S/sp rows for a bucket of S would
    mimic."""
    d, sp = config.data, axis_size(mesh, "sp")
    if d.gaze_dir is not None and d.gaze_pad_len and sp > 1 and \
            d.gaze_pad_len * sp in d.seq_buckets and d.gaze_pad_len not in d.seq_buckets:
        raise ValueError(f"gaze_pad_len {d.gaze_pad_len} on sp {sp}: its rows would read as the "
                         f"sp rank's frames of the {d.gaze_pad_len * sp} bucket")


class GazeCNN(nn.Module):
    """Gaze (x, y) series [B, N, 2] -> [B, 8, C] (multimodal.py GazeCNN):
    three 3x3 convs (32, 64, C channels, ReLU) over the [B, 2, N, 1] map,
    whose width-1 axis sees only the kernels' middle column, then the mean
    over the N rows repeated 8 times (the reference pools the width-1 axis
    up to 8). With ``lengths`` the rows past each row's length are zeroed
    after every conv and the mean divides by ``max(length, 1)``, so a
    padded batch gives each row's unpadded forward (COMPAT #31)."""

    def __init__(self, hidden_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(2, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.conv3 = nn.Conv2d(64, hidden_dim, 3, padding=1)

    def forward(self, gaze: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        x = gaze.to(self.dtype).transpose(1, 2)[..., None]          # [B, 2, N, 1]
        row_ok = None
        if lengths is not None:
            N = x.shape[2]
            row_ok = (torch.arange(N, device=x.device)[None, :]
                      < lengths[:, None])[:, None, :, None].to(x.dtype)
            x = x * row_ok
        for conv in (self.conv1, self.conv2, self.conv3):
            x = torch.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                    padding=1))
            if row_ok is not None:
                # the next conv sees the zero boundary of the unpadded run
                x = x * row_ok
        if row_ok is None:
            pooled = x.mean(dim=(2, 3))
        else:
            pooled = x.sum(dim=(2, 3)) / lengths.clamp_min(1).to(x.dtype)[:, None]
        return pooled[:, None, :].expand(-1, GAZE_STEPS, -1)


class FUTRUnsupervised(nn.Module):
    """``forward(features [B, S, input_dim], query, src_pad_mask [B, S] bool
    (True = pad) or None, query_len [B] or None)``: ``query`` is the [B, S]
    query ids (gt), the [B, N, 2] gaze stream (gaze; ``query_len`` its true
    rows), [B, S, ...] of ``depth_dim`` values a row (depth) or unused
    (self_attention)."""

    def __init__(self, cfg: ModelConfig, n_class: int, query_source: str = "gt",
                 variant: str = "", depth_dim: int = 1):
        super().__init__()
        if query_source not in SOURCES:
            raise ValueError(f"unknown query_source {query_source!r}")
        if variant not in ("", "temp2", "temp3") or (variant and query_source != "self_attention"):
            raise ValueError(f"variant {variant!r} of query_source {query_source!r}")
        self.cfg = cfg
        self.query_source = query_source
        self.variant = variant
        C = cfg.hidden_dim
        dt = compute_dtype(cfg)
        self.embed = InputEmbed(cfg, n_class)
        if cfg.pos_emb:
            self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.max_pos_len, C))
        if query_source == "gt":
            self.query_embed = nn.Embedding(cfg.query_num, C)
        elif query_source == "gaze":
            self.gaze_cnn = GazeCNN(C, dt)
        elif query_source == "depth":
            self.src_drop = FixedDropout(SRC_DROPOUT, seq_dim=1)
            self.depth_embed = DepthEmbed(cfg, depth_dim)
            self.query_drop = FixedDropout(DEPTH_QUERY_DROPOUT, seq_dim=1)
        else:
            self.src_drop = FixedDropout(SRC_DROPOUT, seq_dim=1)
            self.l3_attention = MultiheadAttention(C, cfg.n_head, 0.0, dt)
            if variant == "temp2":
                self.query_embed = nn.Parameter(torch.zeros(cfg.n_query, C))
        self.transformer = FUTRTransformer(
            C, cfg.n_head, cfg.n_decoder_layers, 4 * C,
            n_encoder_layers=cfg.n_encoder_layers if cfg.use_encoder else 0,
            dropout=cfg.dropout, dtype=dt, moe=moe_spec(cfg))
        self.heads = Heads(cfg, n_class)
        if query_source != "gaze":
            self.fc_l3 = nn.Linear(C, cfg.query_num)
        self.register_buffer("pe", sinusoidal_positional_encoding(cfg.max_pos_len, C),
                             persistent=False)

    def forward(self, features, query=None, src_pad_mask: Optional[torch.Tensor] = None,
                query_len: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = features.shape[:2]   # S: the rank's frames under sp
        dt = compute_dtype(cfg)
        sp = seq_axis()
        src = self.embed(features)
        pe = seq_positions(self.pe, S, sp).to(dt)
        if self.query_source in ("self_attention", "depth"):
            # futr_unsupervised.py:106, futr_unsupervised_depth.py:99: the
            # encoding and its dropout on the source
            src = self.src_drop(src + pe)
        pos = None
        if cfg.pos_emb:
            pos = positions(self.pos_embedding, S).to(src.dtype).expand(B, S, cfg.hidden_dim)
        seg_stream = None   # temp2: the seg head reads the source before the add
        if self.query_source == "gt":
            # the lookup in fp32, then the cast: the values of flax's table
            # lookup, with the backward's sums over S rows in fp32
            action_query = self.query_embed(query.long()).to(dt) + pe
            query_stream = action_query
        elif self.query_source == "gaze":
            if sp is not None and query.shape[1] == S:
                query = gather_seq(query, sp)   # the batch cut it with the features
            q = self.gaze_cnn(torch.trunc(query.float()), query_len)
            pe_q = self.pe[:GAZE_STEPS]
            pe_q = pe_q / pe_q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            action_query = query_stream = q + pe_q.to(q.dtype)
        elif self.query_source == "depth":
            # futr_unsupervised_depth.py:108-115: the projected queries, the
            # encoding and its dropout
            action_query = query_stream = self.query_drop(self.depth_embed(query) + pe)
        else:
            # (S, B, C): attention across the batch, whose keys are the
            # global batch's rows at the same frames where a dp group
            # splits the rows (the per-row group: not the sp ranks)
            src_t = src.transpose(0, 1)
            all_t = gather_rows(src).transpose(0, 1)
            query_stream = self.l3_attention(src_t, all_t, all_t).transpose(0, 1) + pe
            if self.variant == "temp2":
                seg_stream = src
                src = src + query_stream
                action_query = self.query_embed[None].to(dt).expand(B, -1, -1)
            else:
                action_query = adaptive_avg_pool1d(gather_seq(query_stream, sp), cfg.n_query)
        s_queries = self.query_source in ("gt", "depth")   # pooled after the decoder
        tgt_mask = src_pad_mask if s_queries else None
        memory, hs = self.transformer(src, pos, action_query, src_pad_mask, tgt_mask,
                                      seq_queries=s_queries)
        if s_queries:
            hs = gather_seq(hs, sp)   # the rank's frames of the decoder's S rows
        if s_queries and src_pad_mask is not None:
            lengths = (~gather_seq(src_pad_mask, sp)).sum(1)
            hs = masked_adaptive_avg_pool1d(hs, cfg.n_query, lengths)
        elif self.query_source in ("gt", "depth", "gaze"):
            # gaze: the 8 decoder rows pool to n_query (identity at 8)
            hs = adaptive_avg_pool1d(hs, cfg.n_query)
        out = self.heads(hs, memory if seg_stream is None else seg_stream)
        if self.query_source != "gaze":
            out["l3"] = linear_in(query_stream, self.fc_l3, dt).float()
        if self.variant not in ("temp2", "temp3"):
            out["supcon"] = query_stream
        return out

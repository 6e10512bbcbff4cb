"""The query-conditioned FUTR: ``futr_proposed``, queries from the ground
truth.

Counterpart of ``FUTRUnsupervised`` in ``r3d_tpu/models/futr_unsupervised.py``
with ``query_source="gt"`` (the reference's ``model/futr_proposed.py``):

- the features go through ``InputEmbed``; the learned ``pos_embedding`` is
  added to the decoder's keys and values (no sinusoidal encoding and no
  dropout on the source in this mode);
- the S queries are ``query_embed`` (an ``nn.Embedding`` of ``query_num``
  rows) of the query ids plus the sinusoidal encoding;
- the decoder runs all S queries against the S keys, with the pad mask on
  both sides, and only its output pools down to ``n_query`` rows: each
  row's bins follow its true length when a mask is given
  (``masked_adaptive_avg_pool1d``), else the plain pool runs over every
  row, pads included (validation and serving give no mask);
- ``Heads`` read the pooled rows and the embedded stream; ``l3`` is
  ``fc_l3`` of the queries in fp32 and ``supcon`` the queries themselves,
  in the compute dtype.

The other query sources (``self_attention``, ``gaze``, ``depth``) and the
``temp2``/``temp3`` variants are ROADMAP item A11.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.futr import Heads, InputEmbed, compute_dtype
from r3d_tpu_torch.models.layers import (
    adaptive_avg_pool1d,
    linear_in,
    masked_adaptive_avg_pool1d,
    sinusoidal_positional_encoding,
)
from r3d_tpu_torch.models.transformer import FUTRTransformer


class FUTRUnsupervised(nn.Module):
    """``forward(features [B, S, input_dim], query [B, S] int ids,
    src_pad_mask [B, S] bool (True = pad) or None)`` -> ``action``,
    ``duration``, ``seg``, ``l3`` [B, S, query_num] and ``supcon`` [B, S, C]."""

    def __init__(self, cfg: ModelConfig, n_class: int, query_source: str = "gt",
                 variant: str = ""):
        super().__init__()
        if query_source != "gt" or variant:
            raise NotImplementedError(
                f"FUTRUnsupervised with query_source={query_source!r} variant={variant!r} is "
                "not ported yet (ROADMAP queue A, item A11)")
        self.cfg = cfg
        C = cfg.hidden_dim
        self.embed = InputEmbed(cfg)
        if cfg.pos_emb:
            self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.max_pos_len, C))
        self.query_embed = nn.Embedding(cfg.query_num, C)
        self.transformer = FUTRTransformer(C, cfg.n_head, cfg.n_decoder_layers, 4 * C,
                                           use_encoder=cfg.use_encoder, dropout=cfg.dropout,
                                           dtype=compute_dtype(cfg))
        self.heads = Heads(cfg, n_class)
        self.fc_l3 = nn.Linear(C, cfg.query_num)
        self.register_buffer("pe", sinusoidal_positional_encoding(cfg.max_pos_len, C),
                             persistent=False)

    def forward(self, features, query, src_pad_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = features.shape[:2]
        dt = compute_dtype(cfg)
        src = self.embed(features)
        pos = None
        if cfg.pos_emb:
            pos = self.pos_embedding[:, :S].to(src.dtype).expand(B, S, cfg.hidden_dim)
        # the lookup in fp32, then the cast: the values of flax's bf16 table
        # lookup, with the backward's sums over S rows in fp32 (an
        # embedding backward, not an indexing scatter)
        action_query = self.query_embed(query.long()).to(dt) + self.pe[:S].to(dt)
        memory, hs = self.transformer(src, pos, action_query, src_pad_mask, src_pad_mask)
        if src_pad_mask is not None:
            hs = masked_adaptive_avg_pool1d(hs, cfg.n_query, (~src_pad_mask).sum(1))
        else:
            hs = adaptive_avg_pool1d(hs, cfg.n_query)
        out = self.heads(hs, memory)
        out["l3"] = linear_in(action_query, self.fc_l3, dt).float()
        out["supcon"] = action_query
        return out

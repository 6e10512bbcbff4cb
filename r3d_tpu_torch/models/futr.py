"""FUTR: the baseline model, its input embed and heads.

Counterpart of ``r3d_tpu/models/futr.py``: ``InputEmbed``, ``Heads`` and
``FUTR`` (the reference's ``model/futr.py``; with ``emit_supcon`` its
``model/futr_baseline.py``, which also returns the decoder output). Compute
runs in ``cfg.compute_dtype`` with fp32 parameters; the wide input embed in
``cfg.embed_dtype`` (default: the compute dtype); the heads return fp32.

Outputs: ``action`` [B, n_query, n_class], ``duration`` [B, n_query],
``seg`` [B, S, n_class - 1] (the NONE class excluded when
``seg_excludes_none``), and ``supcon`` [B, n_query, C] for ``futr_baseline``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.layers import DTYPES, linear_in
from r3d_tpu_torch.models.transformer import FUTRTransformer
from r3d_tpu_torch.parallel.mesh import seq_axis
from r3d_tpu_torch.parallel.tensor import seq_positions


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def embed_dtype(cfg: ModelConfig) -> torch.dtype:
    """Dtype of only the wide input projections."""
    return DTYPES[cfg.embed_dtype or cfg.compute_dtype]


def moe_spec(cfg: ModelConfig):
    """(experts, top_k, capacity_factor) of the transformer's FFNs."""
    return cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor


def positions(table: torch.Tensor, S: int) -> torch.Tensor:
    """The learned positions of the stream's S frames, [1, S, C]: the first
    S rows of ``table``, or under sequence parallelism the sp rank's own
    range of them, ``[r S, (r+1) S)``."""
    return seq_positions(table, S, seq_axis(), dim=1)


class InputEmbed(nn.Module):
    """Features -> hidden, ReLU, in the compute dtype. With ``input_type=
    "gt"`` the input is [B, S] label ids, looked up in ``gt_emb`` (an
    ``nn.Embedding`` of ``n_class + 2`` rows, the Breakfast gt-label
    embedding), looked up in fp32 and cast, as ``futr_proposed``'s query
    table is (the values of flax's lookup, the backward's sums in fp32)."""

    def __init__(self, cfg: ModelConfig, n_class: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.input_type == "gt":
            if n_class is None:
                raise ValueError("input_type 'gt' needs n_class")
            self.gt_emb = nn.Embedding(n_class + 2, cfg.hidden_dim)
        elif cfg.input_type == "i3d_transcript":
            self.input_embed = nn.Linear(cfg.input_dim, cfg.hidden_dim)
        else:
            raise ValueError(f"unknown input_type {cfg.input_type!r}")

    def forward(self, src):
        dt = compute_dtype(self.cfg)
        if self.cfg.input_type == "gt":
            return torch.relu(self.gt_emb(src.long()).to(dt))
        emb = linear_in(src, self.input_embed, embed_dtype(self.cfg))
        return torch.relu(emb).to(dt)


class Heads(nn.Module):
    """Action, duration and segmentation heads, computed in the compute
    dtype and returned in fp32."""

    def __init__(self, cfg: ModelConfig, n_class: int):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        if cfg.anticipate:
            self.fc = nn.Linear(C, n_class)
            self.fc_len = nn.Linear(C, 1)
        if cfg.seg:
            self.fc_seg = nn.Linear(C, n_class - 1 if cfg.seg_excludes_none else n_class)

    def forward(self, hs, memory) -> Dict[str, torch.Tensor]:
        dt = compute_dtype(self.cfg)
        out: Dict[str, torch.Tensor] = {}
        if self.cfg.anticipate:
            out["action"] = linear_in(hs, self.fc, dt).float()
            out["duration"] = linear_in(hs, self.fc_len, dt)[..., 0].float()
        if self.cfg.seg:
            out["seg"] = linear_in(memory, self.fc_seg, dt).float()
        return out


class FUTR(nn.Module):
    """The baseline FUTR: input embed, learned positions added to the keys
    and values, the decoder over learned action queries against the embedded
    stream (the encoder bypassed unless ``use_encoder``), then the heads. Train mode
    (``module.train()``) turns on every dropout."""

    def __init__(self, cfg: ModelConfig, n_class: int, emit_supcon: bool = False):
        super().__init__()
        self.cfg = cfg
        self.emit_supcon = emit_supcon
        C = cfg.hidden_dim
        self.embed = InputEmbed(cfg, n_class)
        if cfg.pos_emb:
            self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.max_pos_len, C))
        self.query_embed = nn.Parameter(torch.zeros(cfg.n_query, C))
        self.transformer = FUTRTransformer(
            C, cfg.n_head, cfg.n_decoder_layers, 4 * C,
            n_encoder_layers=cfg.n_encoder_layers if cfg.use_encoder else 0,
            dropout=cfg.dropout, dtype=compute_dtype(cfg), moe=moe_spec(cfg))
        self.heads = Heads(cfg, n_class)

    def forward(self, features, src_pad_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """features [B, S, input_dim] (or [B, S] label ids for
        ``input_type="gt"``), src_pad_mask [B, S] bool with True = pad
        (None: no mask)."""
        cfg = self.cfg
        B, S = features.shape[:2]
        src = self.embed(features)
        pos = None
        if cfg.pos_emb:
            pos = positions(self.pos_embedding, S).to(src.dtype).expand(B, S, cfg.hidden_dim)
        query = self.query_embed[None].to(src.dtype).expand(B, -1, -1)
        memory, hs = self.transformer(src, pos, query, src_pad_mask)
        out = self.heads(hs, memory)
        if self.emit_supcon:
            out["supcon"] = hs.float()
        return out

"""RGB + depth fusion FUTR (``futr_fusion_bn``).

Counterpart of ``r3d_tpu/models/futr_fusion.py``: embed RGB, project + LN +
ReLU the raw depth frames, fuse them with ``CMFuserBN``, run the decoder over
the learned action queries against the fused stream (encoder bypassed), then
the heads. The fusion models' seg head is ``n_class`` wide.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.fuser import CMFuserBN
from r3d_tpu_torch.models.futr import Heads, InputEmbed, compute_dtype, embed_dtype, linear_in
from r3d_tpu_torch.models.transformer import FUTRTransformer


class DepthEmbed(nn.Module):
    """Raw depth frames -> hidden: flatten, Linear, LayerNorm, ReLU."""

    def __init__(self, cfg: ModelConfig, depth_dim: int):
        super().__init__()
        self.cfg = cfg
        self.depth_projection = nn.Linear(depth_dim, cfg.hidden_dim)
        self.depth_layernorm = nn.LayerNorm(cfg.hidden_dim, eps=1e-5)

    def forward(self, depth):
        B, S = depth.shape[:2]
        h = linear_in(depth.reshape(B, S, -1), self.depth_projection, embed_dtype(self.cfg))
        return torch.relu(self.depth_layernorm(h.to(compute_dtype(self.cfg))))


class FUTRFusion(nn.Module):
    """FUTR with the Rank-enhancing Token Fuser front end."""

    def __init__(self, cfg: ModelConfig, n_class: int, depth_dim: int):
        super().__init__()
        if cfg.model != "futr_fusion_bn":
            raise NotImplementedError(f"fusion model {cfg.model!r} is not ported")
        self.cfg = cfg
        C = cfg.hidden_dim
        self.embed = InputEmbed(cfg)
        self.depth_embed = DepthEmbed(cfg, depth_dim)
        self.fuser = CMFuserBN(C, depth=cfg.fuser_depth,
                               exchange_frac=cfg.fuser_exchange_frac)
        if cfg.pos_emb:
            self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.max_pos_len, C))
        self.query_embed = nn.Parameter(torch.zeros(cfg.n_query, C))
        self.transformer = FUTRTransformer(C, cfg.n_head, cfg.n_decoder_layers, 4 * C,
                                           use_encoder=cfg.use_encoder)
        self.heads = Heads(cfg, n_class)

    def forward(self, features, depth_features,
                src_pad_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """features [B, S, input_dim], depth_features [B, S, H, W] (or
        [B, S, H*W]), src_pad_mask [B, S] bool with True = pad."""
        cfg = self.cfg
        B, S = features.shape[:2]
        src = self.embed(features)
        depth = self.depth_embed(depth_features)
        fused = self.fuser(src, depth)
        pos = None
        if cfg.pos_emb:
            pos = self.pos_embedding[:, :S].to(src.dtype).expand(B, S, cfg.hidden_dim)
        query = self.query_embed[None].to(src.dtype).expand(B, -1, -1)
        memory, hs = self.transformer(fused, pos, query, src_pad_mask)
        out = self.heads(hs, memory)
        out["fused"] = fused.float()
        return out

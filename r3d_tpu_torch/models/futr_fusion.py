"""RGB + depth fusion FUTR: ``futr_fusion_bn`` and the fuser ablations
``futr_fusion_grad``, ``futr_fusion_vary``, ``futr_fusion_nox`` and ``afft``.

Counterpart of ``r3d_tpu/models/futr_fusion.py``: embed RGB, project + LN +
ReLU the raw depth frames, fuse them with the model's fuser (``FUSERS``),
run the transformer (the encoder bypassed unless ``use_encoder``) with the
learned action queries against the fused stream, then the heads. The
fusion models' seg head is ``n_class`` wide. ``afft`` bypasses the
transformer: the fused stream, pooled to ``n_query`` rows, goes through
``fc`` and ``fc_len`` only (no ``seg``, no ``fused`` output). Train mode
(``module.train()``) turns on the batch-statistics BatchNorm and every
dropout; ``module.eval()`` is the reference's module-eval forward. In bf16
(``compute_dtype``) the embeds, the fuser, the transformer and the heads
compute in bf16 and the parameters stay fp32, as flax's ``dtype=`` does.

Under sequence parallelism (``parallel.mesh.seq_axis()`` set) the inputs
are the rank's frames ``[r S, (r+1) S)`` of the bucket (S the rank's
length): the embeds and the fuser run on them, the positional table is
cut to that range, and ``afft`` pools the fused stream gathered over sp.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.fuser import CMFuserBN, CMFuserGrad, CMFuserNoExchange, CMFuserVary
from r3d_tpu_torch.models.futr import (
    Heads,
    InputEmbed,
    compute_dtype,
    embed_dtype,
    moe_spec,
    positions,
)
from r3d_tpu_torch.models.layers import LayerNorm, adaptive_avg_pool1d, linear_in
from r3d_tpu_torch.models.transformer import FUTRTransformer
from r3d_tpu_torch.parallel.mesh import seq_axis
from r3d_tpu_torch.parallel.tensor import Axis, copy_to, gather_from, gather_seq

FUSERS = {
    "futr_fusion_bn": CMFuserBN,
    "futr_fusion_grad": CMFuserGrad,
    "futr_fusion_vary": CMFuserVary,
    "futr_fusion_nox": CMFuserNoExchange,
    "afft": CMFuserNoExchange,
}


class DepthEmbed(nn.Module):
    """Raw depth frames -> hidden: flatten, Linear, LayerNorm, ReLU. With a
    tp axis the projection is column-parallel (its kernel's rule; its bias
    has none and stays whole, each rank adding its slice of it): the rank's
    C/tp outputs, each computed as one process computes it, are gathered
    before the LayerNorm."""

    def __init__(self, cfg: ModelConfig, depth_dim: int):
        super().__init__()
        self.cfg = cfg
        self.tp: Optional[Axis] = None
        self.depth_projection = nn.Linear(depth_dim, cfg.hidden_dim)
        self.depth_layernorm = LayerNorm(cfg.hidden_dim, compute_dtype(cfg))

    def set_axes(self, tp: Optional[Axis]) -> None:
        self.tp = tp

    def forward(self, depth):
        B, S = depth.shape[:2]
        x = depth.reshape(B, S, -1)
        dt = embed_dtype(self.cfg)
        if self.tp is None:
            h = linear_in(x, self.depth_projection, dt)
        else:
            w, b = self.depth_projection.weight, copy_to(self.depth_projection.bias, self.tp)
            h = F.linear(copy_to(x, self.tp).to(dt), w.to(dt),
                         b[self.tp.part(b.shape[0])].to(dt))
            h = gather_from(h, self.tp)
        return torch.relu(self.depth_layernorm(h.to(compute_dtype(self.cfg))))


class FUTRFusion(nn.Module):
    """FUTR with the Rank-enhancing Token Fuser front end."""

    def __init__(self, cfg: ModelConfig, n_class: int, depth_dim: int):
        super().__init__()
        if cfg.model not in FUSERS:
            raise ValueError(f"{cfg.model!r} is not a fusion model")
        self.cfg = cfg
        C = cfg.hidden_dim
        self.embed = InputEmbed(cfg, n_class)
        self.depth_embed = DepthEmbed(cfg, depth_dim)
        kw = dict(depth=cfg.fuser_depth, drop_rate=cfg.fuser_dropout)
        if cfg.model == "futr_fusion_bn":
            # the BN variant's bottom-k fraction and the sticky epochs' frozen
            # statistics; grad and vary fix C // 4
            kw.update(exchange_frac=cfg.fuser_exchange_frac, frozen=cfg.frozen_stats)
        self.fuser = FUSERS[cfg.model](C, **kw)
        if cfg.model == "afft":
            if cfg.anticipate:
                self.fc = nn.Linear(C, n_class)
                self.fc_len = nn.Linear(C, 1)
            return
        if cfg.pos_emb:
            self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.max_pos_len, C))
        self.query_embed = nn.Parameter(torch.zeros(cfg.n_query, C))
        self.transformer = FUTRTransformer(
            C, cfg.n_head, cfg.n_decoder_layers, 4 * C,
            n_encoder_layers=cfg.n_encoder_layers if cfg.use_encoder else 0,
            dropout=cfg.dropout, dtype=compute_dtype(cfg), moe=moe_spec(cfg))
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
        if cfg.model == "afft":
            # the transformer bypassed: the heads on the fused stream pooled
            # to n_query rows, no mask (afft.py:174-201)
            out: Dict[str, torch.Tensor] = {}
            if cfg.anticipate:
                dt = compute_dtype(cfg)
                pooled = adaptive_avg_pool1d(gather_seq(fused, seq_axis()), cfg.n_query)
                out["action"] = linear_in(pooled, self.fc, dt).float()
                out["duration"] = linear_in(pooled, self.fc_len, dt)[..., 0].float()
            return out
        pos = None
        if cfg.pos_emb:
            pos = positions(self.pos_embedding, S).to(src.dtype).expand(B, S, cfg.hidden_dim)
        query = self.query_embed[None].to(src.dtype).expand(B, -1, -1)
        memory, hs = self.transformer(fused, pos, query, src_pad_mask)
        out = self.heads(hs, memory)
        out["fused"] = fused.float()
        return out

"""Model registry of the port, and the seeded init that mirrors flax's.

Ported: the fusion models ``futr_fusion_bn``, ``futr_fusion_grad``,
``futr_fusion_vary``, ``futr_fusion_nox`` and ``afft`` (fp32 compute, any
``fuser_depth``), ``futr``, ``futr_baseline``, ``futr_proposed``,
``futr_unsupervised``, ``futr_unsupervised_temp2``,
``futr_unsupervised_temp3`` and ``futr_gaze`` (fp32 or bf16 compute), each
with or without ``use_encoder``. The other models of
``r3d_tpu/models/__init__.py`` raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.fuser import CMFuserBN, CMFuserNoExchange, CMFuserVary, TorchBatchNorm
from r3d_tpu_torch.models.futr import FUTR
from r3d_tpu_torch.models.futr_fusion import FUSERS, FUTRFusion
from r3d_tpu_torch.models.futr_unsupervised import FUTRUnsupervised
from r3d_tpu_torch.models.layers import DTYPES

def is_fusion_model(name: str) -> bool:
    return name in FUSERS


# Models whose forward takes (features, query, src_pad_mask, query_len):
# the FUTRUnsupervised family. The trainer and the sweep build their inputs
# from this list.
QUERY_MODELS = (
    "futr_unsupervised",
    "futr_proposed",
    "futr_gaze",
    "futr_unsupervised_depth",
    "futr_unsupervised_temp2",
    "futr_unsupervised_temp3",
)


def model_needs_query(name: str) -> bool:
    return name in QUERY_MODELS


# the query source of each ported model of the family
# (r3d_tpu/models/__init__.py:52-67); the depth source raises naming A11.4
_QUERY_SOURCES = {
    "futr_unsupervised_depth": "depth",
    "futr_proposed": "gt",
    "futr_unsupervised": "self_attention",
    "futr_unsupervised_temp2": "self_attention",
    "futr_unsupervised_temp3": "self_attention",
    "futr_gaze": "gaze",
}


def build_model(cfg: ModelConfig, n_class: int,
                depth_shape: Sequence[int] = (160, 120)) -> nn.Module:
    """The module for ``cfg.model``; ``depth_shape`` is the per-frame shape
    of the raw depth input (``DataConfig.depth_shape``)."""
    if cfg.compute_dtype not in DTYPES:
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r} is not ported")
    if cfg.moe_experts > 0:
        raise NotImplementedError("moe_experts > 0 is not ported yet (ROADMAP queue A, item A11)")
    if cfg.model in ("futr", "futr_baseline"):
        # model/futr_baseline.py: futr + output['supcon'] = decoder output
        return FUTR(cfg, n_class, emit_supcon=cfg.model == "futr_baseline")
    if cfg.model in _QUERY_SOURCES:
        variant = cfg.model[len("futr_unsupervised_"):] if "_temp" in cfg.model else ""
        return FUTRUnsupervised(cfg, n_class, _QUERY_SOURCES[cfg.model], variant)
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the fusion models run in float32 only (no config asks for another "
            "compute_dtype; ROADMAP queue A, item A11)")
    if cfg.model in FUSERS:
        return FUTRFusion(cfg, n_class, math.prod(depth_shape))
    raise NotImplementedError(
        f"model {cfg.model!r} is not ported yet (ROADMAP queue A, item A11)")


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (the std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn as the flax init draws them (not the same
    numbers): xavier-uniform Linear weights and pos_embedding, zero biases,
    LayerNorm and BatchNorm at ones/zeros with unit running variance,
    FUTR's query_embed ~ N(0, 1), ``futr_fusion_bn``'s alpha ~ U(0, 1) and
    ``futr_fusion_vary``'s at ones, the modality token of
    ``futr_fusion_nox`` and ``afft`` ~ N(0, 1), an Embedding's table
    xavier-uniform with fan_in its rows and fan_out its width (flax's
    ``Embed(embedding_init=xavier)``), the raw ``query_embed`` of ``temp2``
    xavier-uniform, and a Conv2d's kernel as flax's ``Conv`` default
    (truncated lecun normal) with a zero bias."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _xavier_(m.weight, m.in_features, m.out_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, TorchBatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, TorchBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _xavier_(m.weight, m.num_embeddings, m.embedding_dim, generator)
        elif isinstance(m, CMFuserBN):
            m.alpha.uniform_(0.0, 1.0, generator=generator)
        elif isinstance(m, CMFuserVary):
            m.alpha.fill_(1.0)
        elif isinstance(m, CMFuserNoExchange):
            m.modality_token.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (FUTR, FUTRFusion, FUTRUnsupervised)):
            if hasattr(m, "pos_embedding"):
                _, L, C = m.pos_embedding.shape
                _xavier_(m.pos_embedding, L, C, generator)
            qe = getattr(m, "query_embed", None)
            if isinstance(qe, nn.Parameter) and isinstance(m, FUTRUnsupervised):
                _xavier_(qe, *qe.shape, generator)   # temp2's query_embed
            elif isinstance(qe, nn.Parameter):
                qe.normal_(0.0, 1.0, generator=generator)
    return model

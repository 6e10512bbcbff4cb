"""Model registry of the port, and the seeded init that mirrors flax's.

Only ``futr_fusion_bn`` is ported. The other models of
``r3d_tpu/models/__init__.py`` raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.fuser import CMFuserBN, TorchBatchNorm
from r3d_tpu_torch.models.futr_fusion import FUTRFusion

_FUSION_MODELS = {
    "futr_fusion_bn",
    "futr_fusion_grad",
    "futr_fusion_vary",
    "futr_fusion_nox",
    "afft",
}


def is_fusion_model(name: str) -> bool:
    return name in _FUSION_MODELS


def build_model(cfg: ModelConfig, n_class: int,
                depth_shape: Sequence[int] = (160, 120)) -> nn.Module:
    """The module for ``cfg.model``; ``depth_shape`` is the per-frame shape
    of the raw depth input (``DataConfig.depth_shape``)."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "compute_dtype other than float32 is not ported (ROADMAP queue A, item 11)")
    if cfg.model == "futr_fusion_bn":
        return FUTRFusion(cfg, n_class, math.prod(depth_shape))
    raise NotImplementedError(
        f"model {cfg.model!r} is not ported yet (ROADMAP queue A, item 11)")


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn as the flax init draws them (not the same
    numbers): xavier-uniform Linear weights and pos_embedding, zero biases,
    LayerNorm and BatchNorm at ones/zeros with unit running variance,
    query_embed ~ N(0, 1), alpha ~ U(0, 1)."""
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
        elif isinstance(m, CMFuserBN):
            m.alpha.uniform_(0.0, 1.0, generator=generator)
        elif isinstance(m, FUTRFusion):
            if hasattr(m, "pos_embedding"):
                _, L, C = m.pos_embedding.shape
                _xavier_(m.pos_embedding, L, C, generator)
            m.query_embed.normal_(0.0, 1.0, generator=generator)
    return model
